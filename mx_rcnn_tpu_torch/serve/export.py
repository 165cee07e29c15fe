"""Export stores: what a serving process needs to join warm, checked.

Counterpart of the serving half of ``mx_rcnn_tpu/serve/export.py``.  The
JAX store holds ``jax.export`` programs and the XLA cache its verify
pass filled.  The port's kernels are ``ctypes`` launches, not
``torch.library`` ops, so ``torch.export`` cannot save a forward that
holds them; the port's store keeps what makes a process serve at once
and what proves it serves the same bits:

* ``manifest.json`` (written last, atomically): the config fingerprint,
  the buckets, the serving knobs the JAX manifest records, the quant
  block (``ops/quant.py — quant_manifest_meta``, the calibration
  fingerprint included), ``version`` and ``parent_sha``; the torch and
  CUDA versions and the device (type, name, compute capability) in place
  of the jax version; and per program (``serve_fwd_<bucket>_b<n>``,
  ``serve_post``) its input spec and the sha256 of its outputs on
  :func:`_dummy_batch`;
* ``variables.npz`` with ``bundle_variables``: the weights as flat arrays
  under the JAX package's ``_flatten_variables`` names (``params/...``,
  ``batch_stats/...``, ``quant/...``), so ``variables_fingerprint`` of
  bridged weights is the JAX one;
* ``kernels/``: the built library of every kernel the programs launched,
  under ``kernels.py``'s names (source and flags hashed), the
  counterpart of the JAX store's bundled XLA cache.  A store written on
  the CPU bundles none and records the device ``cpu``.

``ServingEngine.warm_from_export`` runs :meth:`ExportStore.check` (each
mismatch raises :class:`ExportMismatch`), installs the libraries where
``kernels.py`` loads them (a process with an empty ``_build/`` then
builds nothing), reruns each bucket's dummy batch and requires the
recorded digests bit for bit.  Nothing is warned past.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.utils.checkpoint import (_atomic_write,
                                                config_fingerprint)

MANIFEST_NAME = "manifest.json"
KERNELS_SUBDIR = "kernels"
VARIABLES_NAME = "variables.npz"
SERVE_POST = "serve_post"


def serve_fwd_name(bucket: Tuple[int, int], batch: int) -> str:
    return f"serve_fwd_{bucket[0]}x{bucket[1]}_b{batch}"


def manifest_sha(root: str) -> str:
    """A store's identity for lineage: sha256 of its committed manifest
    bytes (a child records its parent's as ``parent_sha``)."""
    with open(os.path.join(root, MANIFEST_NAME), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# ---- weights ----------------------------------------------------------------


def _flatten_variables(variables, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested variables dict → flat ``{'a/b/c': array}``."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(variables, dict):
        for k in sorted(variables):
            out.update(_flatten_variables(variables[k], f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(variables)
    return out


def _empty_subtrees(variables, prefix: str = "") -> List[str]:
    """Paths of dict subtrees with no leaves (a BN-free model's
    ``batch_stats``), which the flat form drops."""
    out: List[str] = []
    if isinstance(variables, dict):
        if not variables:
            out.append(prefix.rstrip("/"))
        for k in sorted(variables):
            out.extend(_empty_subtrees(variables[k], f"{prefix}{k}/"))
    return out


def _unflatten_variables(flat: Dict[str, np.ndarray]) -> Dict:
    out: Dict = {}
    for key, arr in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out


def variables_fingerprint(variables) -> str:
    """sha256 over the sorted leaf paths, dtypes, shapes and bytes of a
    weights tree (the manifest's ``train_fingerprint``), as the JAX
    package computes it."""
    h = hashlib.sha256()
    for key, arr in sorted(_flatten_variables(variables).items()):
        a = np.ascontiguousarray(arr)
        h.update(key.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def predictor_variables(predictor) -> Dict:
    """A :class:`Predictor`'s weights as the JAX package's variables
    tree: ``params`` and ``batch_stats`` (``utils/bridge.py —
    to_flax``), and the ``quant`` scales of a quantized model."""
    from mx_rcnn_tpu_torch.utils.bridge import quant_to_flax, to_flax

    variables = to_flax(predictor.model.state_dict())
    if predictor.cfg.quant.enabled:
        variables["quant"] = quant_to_flax(predictor.model)
    return variables


def predictor_from_variables(variables: Dict, cfg, device="cuda",
                             devices=None):
    """The :class:`Predictor` of ``cfg`` on ``device`` (CUDA unless the
    caller asks for the CPU) with a variables tree's weights (and its
    ``quant`` scales when ``cfg.quant`` is on); over ``devices``, when
    given, as :class:`Predictor` splits a batch."""
    from mx_rcnn_tpu_torch.core.tester import Predictor
    from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
    from mx_rcnn_tpu_torch.utils.bridge import from_flax, load_quant
    from mx_rcnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = build_model(cfg, dev, seed=None)
    model.load_state_dict(from_flax(variables))
    if cfg.quant.enabled:
        if "quant" not in variables:
            raise ExportMismatch("cfg.quant is on but the variables carry "
                                 "no quant scales")
        load_quant(model, variables["quant"])
    return Predictor(model, cfg, dev, devices=devices)


# ---- outputs ----------------------------------------------------------------


def _host_tensors(outputs) -> List[torch.Tensor]:
    return [torch.as_tensor(t).detach().cpu().contiguous() for t in outputs]


def output_digest(outputs) -> str:
    """sha256 over each output's dtype, shape and bytes: equal digests
    are equal bits (NaNs included)."""
    h = hashlib.sha256()
    for t in _host_tensors(outputs):
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _bit_equal(a, b) -> bool:
    """Equal dtypes, shapes and bytes, output by output."""
    la, lb = _host_tensors(a), _host_tensors(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8),
                        y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def _describe(arrays) -> list:
    """[[shape, dtype], ...] of numpy arrays or tensors, dtypes by their
    numpy names."""
    return [[list(a.shape), str(a.dtype).replace("torch.", "")]
            for a in arrays]


def store_post(static: Dict) -> Callable:
    """The eval postprocess at a store's recorded thresholds."""
    from mx_rcnn_tpu_torch.core.tester import _postprocess_batch

    def post(*args):
        with torch.inference_mode():
            return _postprocess_batch(
                *args, nms_thresh=static["nms_thresh"],
                score_thresh=static["score_thresh"])

    return post


def _dummy_batch(bucket: Tuple[int, int], n: int, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The verify inputs, the JAX package's: random pixels (zeros would
    let a broken forward pass on degenerate outputs), im_info of the
    whole canvas at scale 1."""
    bh, bw = bucket
    rng = np.random.RandomState(seed + bh * 7 + bw)
    images = rng.rand(n, bh, bw, 3).astype(np.float32) * 255.0
    im_info = np.tile(np.array([bh, bw, 1.0], np.float32), (n, 1))
    return images, im_info


def device_record(device) -> Dict:
    """The device a store was written for: type, name, compute
    capability."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"type": "cuda", "name": torch.cuda.get_device_name(dev),
                "capability": list(torch.cuda.get_device_capability(dev))}
    return {"type": dev.type, "name": dev.type, "capability": None}


class ExportMismatch(RuntimeError):
    """The store does not match this process (config, versions, device,
    kernels, quant block, weights or outputs): serving from it would
    serve other semantics.  Export again instead."""


class ExportStore:
    """A directory holding a manifest, optionally the weights, and the
    kernel libraries its programs launched.

    Writing: ``ExportStore.create(root, cfg, device=...)`` → ``add`` per
    program → ``add_kernels`` / ``add_variables`` → ``finish()`` (the
    manifest last, atomically: a half-written store has none).  Reading:
    ``ExportStore(root)`` → ``check(cfg, device=...)`` →
    ``install_kernels()`` → ``load(name, predictor)``.
    """

    def __init__(self, root: str):
        self.root = root
        self._manifest: Optional[Dict] = None

    # ---- writing ------------------------------------------------------------

    @classmethod
    def create(cls, root: str, cfg, extra_meta: Dict = None,
               device="cuda") -> "ExportStore":
        os.makedirs(root, exist_ok=True)
        store = cls(root)
        store._manifest = {
            "kind": "mx_rcnn_tpu_torch_export_store",
            "config_fingerprint": config_fingerprint(cfg),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device": device_record(device),
            "bucket_shapes": [list(b) for b in cfg.bucket.shapes],
            "num_classes": cfg.num_classes,
            "entries": {},
            "kernels": {},
            **(extra_meta or {}),
        }
        return store

    def add(self, name: str, args: Sequence, outputs,
            static: Dict = None) -> None:
        """Record program ``name``: its input spec and the digest of the
        outputs it gave on ``args``."""
        self._manifest["entries"][name] = {
            "args": _describe(args),
            "outputs_sha256": output_digest(outputs),
            "static": dict(static or {}),
        }

    def add_kernels(self, names: Sequence[str]) -> None:
        """Bundle the built library of each kernel in ``names`` under
        ``kernels/`` (sha-pinned in the manifest)."""
        for name in sorted(names):
            lib = kernels.BY_NAME[name].library_path()
            blob = lib.read_bytes()
            rel = f"{KERNELS_SUBDIR}/{lib.name}"
            _atomic_write(os.path.join(self.root, rel), blob)
            self._manifest["kernels"][name] = {
                "file": rel, "bytes": len(blob),
                "sha256": hashlib.sha256(blob).hexdigest()}

    def add_variables(self, variables) -> None:
        """Bundle the weights (npz of the flat leaves, sha-pinned) and
        record their ``train_fingerprint``."""
        buf = io.BytesIO()
        np.savez(buf, **_flatten_variables(variables))
        blob = buf.getvalue()
        _atomic_write(os.path.join(self.root, VARIABLES_NAME), blob)
        self._manifest["variables"] = {
            "file": VARIABLES_NAME,
            "bytes": len(blob),
            "sha256": hashlib.sha256(blob).hexdigest(),
            "empty_subtrees": _empty_subtrees(variables),
        }
        self._manifest["train_fingerprint"] = \
            variables_fingerprint(variables)

    def _read(self, entry: Dict, what: str) -> bytes:
        """A file the manifest names, its sha256 checked."""
        path = os.path.join(self.root, entry["file"])
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            raise ExportMismatch(
                f"export store {self.root} is missing {entry['file']} "
                "although the manifest names it: the store is corrupt; "
                "export again") from None
        sha = hashlib.sha256(blob).hexdigest()
        if sha != entry["sha256"]:
            raise ExportMismatch(f"{what} {path} is corrupt: sha256 {sha} "
                                 f"!= manifest {entry['sha256']}")
        return blob

    def load_variables(self) -> Dict:
        """The bundled weights (sha-verified) as a variables tree."""
        entry = self.manifest().get("variables")
        if entry is None:
            raise ExportMismatch(
                f"export store {self.root} bundles no weights")
        blob = self._read(entry, "variables payload")
        with np.load(io.BytesIO(blob)) as z:
            variables = _unflatten_variables({k: z[k] for k in z.files})
        for path in entry.get("empty_subtrees", []):
            node = variables
            parts = [p for p in path.split("/") if p]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            if parts:
                node.setdefault(parts[-1], {})
        return variables

    # ---- lineage ----------------------------------------------------------

    @property
    def version(self) -> Optional[str]:
        return self.manifest().get("version")

    @property
    def parent_sha(self) -> Optional[str]:
        return self.manifest().get("parent_sha")

    def check_lineage(self, known_parents=None,
                      expect_train_fingerprint: str = None) -> Dict:
        """Rollout admission, beside :meth:`check`: a versioned store
        whose ``parent_sha`` is missing or not among ``known_parents``
        is refused, and so is a ``train_fingerprint`` other than
        ``expect_train_fingerprint``.  A manifest without ``version``
        predates lineage and admits unchanged."""
        m = self.manifest()
        if "version" not in m:
            return {"version": None, "parent_sha": None, "legacy": True}
        version = m["version"]
        parent = m.get("parent_sha")
        if known_parents is not None:
            known = set(known_parents)
            if parent is None:
                raise ExportMismatch(
                    f"export store {self.root} (version {version!r}) "
                    "records no parent_sha but this fleet requires "
                    "lineage: refusing an unrooted version")
            if parent not in known:
                raise ExportMismatch(
                    f"export store {self.root} (version {version!r}) has "
                    f"unknown parent {parent[:12]}…, not among the "
                    f"{len(known)} version(s) this fleet serves")
        recorded_fp = m.get("train_fingerprint")
        if (expect_train_fingerprint is not None
                and recorded_fp != expect_train_fingerprint):
            raise ExportMismatch(
                f"export store {self.root} (version {version!r}) "
                f"train_fingerprint {str(recorded_fp)[:12]}… != expected "
                f"{expect_train_fingerprint[:12]}…: the shipped weights are "
                "not the weights this rollout was approved for")
        return {"version": version, "parent_sha": parent,
                "train_fingerprint": recorded_fp, "legacy": False}

    def finish(self) -> str:
        """Commit the manifest, last: its presence means every file it
        names is whole on disk."""
        path = os.path.join(self.root, MANIFEST_NAME)
        _atomic_write(path, json.dumps(self._manifest, indent=1,
                                       sort_keys=True).encode())
        return path

    # ---- reading ----------------------------------------------------------

    def manifest(self) -> Dict:
        if self._manifest is None:
            with open(os.path.join(self.root, MANIFEST_NAME)) as f:
                self._manifest = json.load(f)
        return self._manifest

    def cache_dir(self) -> str:
        """The bundled kernel libraries (the JAX store's XLA cache)."""
        return os.path.join(self.root, KERNELS_SUBDIR)

    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self.manifest()["entries"]))

    def check(self, cfg, quant_fingerprint: str = None,
              device="cuda") -> Dict:
        """Admission before anything loads: the config fingerprint, the
        buckets, the serving knobs, the quant block (either way; the
        calibration fingerprint included), the torch and CUDA versions,
        the device (type, name, capability) and each bundled kernel
        library's name (what today's sources and flags build) must match
        this process, else :class:`ExportMismatch`."""
        from mx_rcnn_tpu_torch.ops.quant import quant_manifest_meta

        m = self.manifest()
        problems: List[str] = []
        fp = config_fingerprint(cfg)
        if m.get("config_fingerprint") != fp:
            problems.append(f"config fingerprint "
                            f"{m.get('config_fingerprint')} != this run's "
                            f"{fp}")
        for key, live in (("torch_version", torch.__version__),
                          ("cuda_version", torch.version.cuda),
                          ("device", device_record(device))):
            if m.get(key) != live:
                problems.append(f"{key} {m.get(key)} != this process's "
                                f"{live}")
        want = [list(b) for b in cfg.bucket.shapes]
        if m.get("bucket_shapes") != want:
            problems.append(f"bucket shapes {m.get('bucket_shapes')} != "
                            f"{want}")
        for key, live in (("serve_batch_size", cfg.serve.batch_size),
                          ("nms_thresh", cfg.test.nms),
                          ("serve_score_thresh", cfg.serve.score_thresh),
                          ("num_classes", cfg.num_classes)):
            if key in m and m[key] != live:
                problems.append(f"{key} {m[key]} != this run's {live}")
        live_q = (quant_manifest_meta(cfg.quant, quant_fingerprint)
                  if cfg.quant.enabled else None)
        if m.get("quant") != live_q:
            problems.append(f"quant knobs {m.get('quant')} != this run's "
                            f"{live_q}: quantized and fp programs never mix")
        for name, entry in sorted(m.get("kernels", {}).items()):
            k = kernels.BY_NAME.get(name)
            built = k.library_path().name if k is not None else None
            if os.path.basename(entry["file"]) != built:
                problems.append(
                    f"kernel library {entry['file']} is not what today's "
                    f"sources build ({built})")
        if problems:
            raise ExportMismatch(f"export store {self.root} does not match "
                                 "this process: " + "; ".join(problems))
        return m

    def install_kernels(self) -> List[str]:
        """Place each bundled library (sha-verified) where ``kernels.py``
        loads it, under the kernel's lock, and load it; returns the names
        whose file was placed (not there before)."""
        placed = []
        for name, entry in sorted(self.manifest().get("kernels",
                                                      {}).items()):
            blob = self._read(entry, f"kernel library {name}")
            if kernels.BY_NAME[name].install(blob):
                placed.append(name)
        return placed

    def load(self, name: str, predictor) -> Callable:
        """Program ``name`` in this process: the ``predictor``'s forward
        at the recorded input spec, or, for :data:`SERVE_POST`, the eval
        postprocess at the recorded thresholds."""
        m = self.manifest()
        if name not in m["entries"]:
            raise ExportMismatch(f"export store {self.root} has no program "
                                 f"{name!r} (has {list(self.names())})")
        entry = m["entries"][name]
        if name == SERVE_POST:
            return store_post(entry["static"])
        spec = entry["args"]

        def fwd(images, im_info):
            got = _describe((images, im_info))
            if got != spec:
                raise ValueError(f"program {name} takes {spec}, got {got}")
            return predictor.raw(images, im_info)

        return fwd

    def require_digest(self, name: str, outputs) -> None:
        """Raise unless ``outputs`` have program ``name``'s recorded
        digest, bit for bit."""
        want = self.manifest()["entries"][name]["outputs_sha256"]
        got = output_digest(outputs)
        if got != want:
            raise ExportMismatch(
                f"program {name} of export store {self.root} gives outputs "
                f"with sha256 {got[:16]}…, the store recorded "
                f"{want[:16]}…: this process does not compute the "
                "exported bits")


def export_serve_programs(predictor, cfg, root: str = None, *,
                          version: str = None, parent: str = None,
                          bundle_variables: bool = False) -> Dict:
    """Write the store of ``predictor``'s serving programs at ``root``:
    each bucket's forward at ``serve.batch_size`` rows, the postprocess
    once, at the first bucket's forward outputs, each with the digest of
    its outputs on :func:`_dummy_batch`; the libraries of the kernels
    they launched; the weights with ``bundle_variables``.  Each program
    runs again and must give the same bits (the digest another process
    will be held to), and the bundled weights must read back to the same
    fingerprint; a store that fails is never committed.  ``version``
    and ``parent`` (a store root or a manifest sha) record lineage.
    ``root`` defaults to ``fleet.export_dir``.  Returns the report."""
    from mx_rcnn_tpu_torch.core.tester import tiled_bbox_stats
    from mx_rcnn_tpu_torch.ops.quant import quant_manifest_meta

    root = root or cfg.fleet.export_dir
    if not root:
        raise ValueError("no store directory: pass root or set "
                         "fleet.export_dir")
    dev = predictor.device
    n = cfg.serve.batch_size
    buckets = [tuple(b) for b in cfg.bucket.shapes]
    extra_meta = {
        "serve_batch_size": n,
        "nms_thresh": cfg.test.nms,
        "serve_score_thresh": cfg.serve.score_thresh,
        "quant": (quant_manifest_meta(cfg.quant,
                                      predictor.quant_fingerprint)
                  if cfg.quant.enabled else None),
    }
    if version is not None:
        extra_meta["version"] = version
        if parent is not None and os.path.isdir(str(parent)):
            parent = manifest_sha(str(parent))
        extra_meta["parent_sha"] = parent
    store = ExportStore.create(root, cfg, extra_meta=extra_meta, device=dev)
    report: Dict = {"root": root, "programs": []}
    before = kernels.launch_counts()
    stds, means = tiled_bbox_stats(cfg, cfg.num_classes, dev)
    statics = {"nms_thresh": cfg.test.nms,
               "score_thresh": cfg.serve.score_thresh}
    all_equal = True
    for bucket in buckets:
        images, im_info = _dummy_batch(bucket, n)
        name = serve_fwd_name(bucket, n)
        live = predictor.raw(images, im_info)
        store.add(name, (images, im_info), live)
        programs = [(name, live, lambda: store.load(name, predictor)(
            images, im_info))]
        if SERVE_POST not in store.manifest()["entries"]:
            info = torch.from_numpy(im_info).to(dev)
            post_args = tuple(live) + (info, info[:, 2], stds, means)
            post = store_post(statics)(*post_args)
            store.add(SERVE_POST, post_args, post, static=statics)
            programs.append((SERVE_POST, post, lambda: store.load(
                SERVE_POST, predictor)(*post_args)))
        for prog, first, again in programs:
            # a second run must give the recorded bits: the digest
            # another process is held to
            eq = _bit_equal(first, again())
            all_equal &= eq
            report["programs"].append({"name": prog, "bit_equal": eq})
    after = kernels.launch_counts()
    launched = [k for k in after if after[k] > before.get(k, 0)]
    if torch.device(dev).type == "cuda":
        store.add_kernels(launched)
    report["kernels"] = sorted(launched)
    if bundle_variables:
        variables = predictor_variables(predictor)
        store.add_variables(variables)
        eq = variables_fingerprint(store.load_variables()) == \
            store.manifest()["train_fingerprint"]
        all_equal &= eq
        report["programs"].append({"name": VARIABLES_NAME, "bit_equal": eq})
    report["bit_equal"] = all_equal
    if not all_equal:
        raise ExportMismatch(
            "a program's outputs differ between two runs on the same "
            "inputs: refusing to commit a store no other process could be "
            f"held to ({report['programs']})")
    report["manifest"] = store.finish()
    report["bytes"] = sum(e["bytes"] for e in
                          store.manifest()["kernels"].values()) + \
        store.manifest().get("variables", {}).get("bytes", 0)
    return report
