"""Export stores: what a serving process needs to join warm, and a
train step's record, checked.

Counterpart of ``mx_rcnn_tpu/serve/export.py``.  The
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

The train-step half (:func:`export_train_step`, :func:`load_train_step`)
records one ``train_step`` entry: the input spec of the state's tensors
and the batch, the digest of the step's outputs from
:func:`train_step_inputs`, the libraries of K1, K2 and K3, and the
algorithm settings the digest was taken under
(:data:`PINNED_ALGORITHMS`: deterministic cuDNN, no benchmark, TF32
off).  A loaded step is ``core/train.py``'s, admitted by ``check``, the
recorded settings and the leaf spec.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import io
import json
import os
import time
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


# ---- the train step ---------------------------------------------------------

TRAIN_STEP = "train_step"
# the steps per epoch of the exported step's optimizer (its lr schedule's
# boundaries), as the JAX export sets up its state
TRAIN_STEPS_PER_EPOCH = 100
# the algorithm settings a train-step digest is taken under: without them
# cuDNN picks a convolution algorithm per process, and two runs of one
# step from one state need not give one set of bits (the switches
# ``parallel/dp.py`` hands every rank)
PINNED_ALGORITHMS = {"matmul_tf32": False, "cudnn_tf32": False,
                     "cudnn_deterministic": True, "cudnn_benchmark": False}


def live_algorithms() -> Dict[str, bool]:
    """This process's settings of :data:`PINNED_ALGORITHMS`' switches."""
    from mx_rcnn_tpu_torch.parallel.dp import _torch_settings

    return {k: v for k, v in _torch_settings().items() if k != "threads"}


def _set_algorithms(settings: Dict[str, bool]) -> None:
    from mx_rcnn_tpu_torch.parallel.dp import _adopt

    _adopt({"threads": torch.get_num_threads(), **settings})


@contextlib.contextmanager
def pinned_algorithms():
    """Run the body under :data:`PINNED_ALGORITHMS`, then restore the
    caller's settings."""
    was = live_algorithms()
    _set_algorithms(PINNED_ALGORITHMS)
    try:
        yield
    finally:
        _set_algorithms(was)


def _state_tensors(state) -> List[torch.Tensor]:
    """What a ``core/train.py — TrainState`` step reads and writes, in a
    fixed order: the model's state_dict, the optimizer's trace (by
    parameter) and ``[seed, count]`` (the step's draws are seeded from
    both)."""
    sd = state.model.state_dict()
    return ([sd[k] for k in sd]
            + [state.optimizer.trace[k] for k in state.optimizer.trace]
            + [torch.tensor([state.seed, state.optimizer.count],
                            dtype=torch.int64)])


def _batch_tensors(batch) -> List[torch.Tensor]:
    """A batch's tensors (each microbatch's in turn under grad_accum)."""
    if isinstance(batch, (list, tuple)) and batch and \
            isinstance(batch[0], tuple):
        return [t for mb in batch for t in mb]
    return list(batch)


def train_step_outputs(state, metrics: Dict[str, torch.Tensor]
                       ) -> List[torch.Tensor]:
    """A step's outputs as the store digests them: the new state's
    tensors, then the metrics in sorted key order."""
    return _state_tensors(state) + [metrics[k] for k in sorted(metrics)]


def _synthetic_train_batch(cfg, seed: int, device="cuda",
                           grad_accum: int = 1):
    """The first training batch (``grad_accum`` of them, as a list, when
    it is more than 1) at the recipe's static shapes, on ``device``: a
    generated preset's own images, any other preset's synthetic stand-in
    images at its canvas (no dataset is read: the export checks the
    step's bits, not the data), through ``AnchorLoader`` unshuffled."""
    from mx_rcnn_tpu_torch.core.train import to_device
    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.data.loader import AnchorLoader
    from mx_rcnn_tpu_torch.utils.device import resolve_device

    n = max(cfg.train.batch_images * 2, 4) * grad_accum
    if cfg.dataset.name.startswith("synthetic"):
        imdb, roidb = load_gt_roidb(cfg, training=True, num_images=n)
    else:
        imdb, roidb = load_gt_roidb(cfg, training=True, synthetic=n)
    loader = AnchorLoader(roidb, cfg, imdb.load_image,
                          batch_images=cfg.train.batch_images,
                          shuffle=False, seed=seed, num_workers=0)
    dev = resolve_device(device)
    it = iter(loader)
    batches = [to_device(next(it), dev) for _ in range(grad_accum)]
    return batches[0] if grad_accum == 1 else batches


def train_step_inputs(cfg, seed: int = 0, device="cuda",
                      grad_accum: int = 1):
    """The exported step's start: ``(state, batch)``, the train state of
    ``cfg`` from ``seed`` (``core/train.py — setup_training``) and
    :func:`_synthetic_train_batch`.  Another process that calls this
    with the same arguments gets the same bits, which is what
    :meth:`ExportStore.require_digest` holds it to."""
    from mx_rcnn_tpu_torch.core.train import setup_training

    state = setup_training(cfg, device, seed,
                           steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    return state, _synthetic_train_batch(cfg, seed, device, grad_accum)


def _copy_state(state):
    """A copy of a TrainState that shares nothing with it: the step
    updates the model and the trace in place."""
    from mx_rcnn_tpu_torch.core.train import TrainState

    model = copy.deepcopy(state.model)
    params = dict(model.named_parameters())
    opt = copy.copy(state.optimizer)
    opt.params = [(n, params[n]) for n, _ in state.optimizer.params]
    opt.trace = {n: t.clone() for n, t in state.optimizer.trace.items()}
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    return TrainState(model, opt, gen, state.seed)


def _train_step_fn(m: Dict, cfg) -> Callable:
    """The step of a train-step manifest ``m``: ``(state, batch,
    draws=None) → (state, metrics)``, refusing other algorithm settings
    and arguments of another leaf count or spec."""
    from mx_rcnn_tpu_torch.core.train import make_train_step

    entry = m["entries"][TRAIN_STEP]
    spec = entry["args"]
    step = make_train_step(cfg, grad_accum=m["grad_accum"])

    def check_algorithms() -> None:
        if live_algorithms() != m["algorithms"]:
            raise ExportMismatch(
                f"the train step was exported under {m['algorithms']}, "
                f"this process runs {live_algorithms()}: its digest holds "
                "only under the recorded settings (pinned_algorithms)")

    check_algorithms()

    def run(state, batch, draws=None):
        check_algorithms()
        args = _state_tensors(state) + _batch_tensors(batch)
        if len(args) != len(spec):
            raise ExportMismatch(
                f"train-step args have {len(args)} leaves, export was "
                f"taken with {len(spec)}")
        got = _describe(args)
        if got != spec:
            bad = next(i for i, (a, b) in enumerate(zip(got, spec))
                       if a != b)
            raise ExportMismatch(f"train-step arg {bad} is {got[bad]}, the "
                                 f"export took {spec[bad]}")
        metrics = step(state, batch, draws=draws)
        return state, metrics

    return run


def export_train_step(cfg, *, out_dir: str, num_devices: int = 1,
                      grad_accum: int = 1, seed: int = 0,
                      verify: bool = True, device="cuda") -> Dict:
    """Export the train step of ``cfg`` on one device (``device``, CUDA
    unless the caller asks for the CPU) into a store at ``out_dir``.

    The port's store holds no program (module docstring): its
    ``train_step`` entry records the input spec of the state's tensors
    and the batch, the digest of the step's outputs (the new state's
    tensors and the metrics) from :func:`train_step_inputs`, the
    libraries of the kernels the step launched, the JAX manifest's
    ``train_step``, ``num_devices``, ``grad_accum`` and ``batch_images``,
    and the algorithm settings the digest was taken under.  The whole
    export runs under :func:`pinned_algorithms` and restores the
    caller's settings.  With ``verify`` the live step and the loaded
    one run from two copies of one start state and must give the same
    bits, else :class:`ExportMismatch` and no manifest is committed.
    Returns the report."""
    from mx_rcnn_tpu_torch.core.train import make_train_step
    from mx_rcnn_tpu_torch.utils.device import resolve_device

    if num_devices != 1:
        raise NotImplementedError(
            "train-step export covers the single-device step (the "
            "data-parallel step runs one process per card)")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    with pinned_algorithms():
        state, batch = train_step_inputs(cfg, seed, dev, grad_accum)
        start = _copy_state(state) if verify else None
        args = _state_tensors(state) + _batch_tensors(batch)
        n_state = len(args) - len(_batch_tensors(batch))
        store = ExportStore.create(out_dir, cfg, extra_meta={
            "train_step": True, "num_devices": num_devices,
            "grad_accum": grad_accum,
            "batch_images": cfg.train.batch_images,
            "algorithms": dict(PINNED_ALGORITHMS)}, device=dev)
        step = make_train_step(cfg, grad_accum=grad_accum)
        before = kernels.launch_counts()
        metrics = step(state, batch)
        live = train_step_outputs(state, metrics)
        mid = kernels.launch_counts()
        launches = {"live": {k: mid[k] - before.get(k, 0) for k in mid}}
        store.add(TRAIN_STEP, args, live, static={
            "state_leaves": n_state, "seed": seed,
            "steps_per_epoch": TRAIN_STEPS_PER_EPOCH,
            "metrics": sorted(metrics)})
        report: Dict = {"root": out_dir, "device": str(dev),
                        "programs": [{"name": TRAIN_STEP}],
                        "verified": verify, "bit_equal": None}
        if verify:
            got_state, got_metrics = _train_step_fn(store.manifest(), cfg)(
                start, batch)
            after = kernels.launch_counts()
            launches["loaded"] = {k: after[k] - mid.get(k, 0)
                                  for k in after}
            eq = _bit_equal(live, train_step_outputs(got_state,
                                                     got_metrics))
            report["bit_equal"] = eq
            report["programs"][0]["bit_equal"] = eq
            if not eq:
                raise ExportMismatch(
                    "the loaded train step is NOT bit-equal to the live "
                    f"step from the same state under {PINNED_ALGORITHMS}: "
                    "refusing to commit a digest no process could be "
                    "held to")
        if dev.type == "cuda":
            store.add_kernels(sorted(k for k, v in launches["live"].items()
                                     if v))
        report["manifest"] = store.finish()
    m = store.manifest()
    report["kernels"] = {k: e["sha256"] for k, e in m["kernels"].items()}
    report["bytes"] = sum(e["bytes"] for e in m["kernels"].values())
    report["outputs_sha256"] = m["entries"][TRAIN_STEP]["outputs_sha256"]
    report["launches"] = launches
    report["algorithms"] = dict(PINNED_ALGORITHMS)
    report["metrics"] = {k: float(v) for k, v in sorted(metrics.items())}
    report["export_s"] = round(time.perf_counter() - t0, 3)
    return report


def load_train_step(store: "ExportStore", cfg, device="cuda") -> Callable:
    """The exported train step in this process: admission (``check``:
    the config fingerprint, versions, device, kernel library names), the
    recorded algorithm settings against this process's (run it under
    :func:`pinned_algorithms`), the bundled libraries installed; then
    ``(state, batch, draws=None) → (state, metrics)``, which refuses
    arguments of another leaf count or spec and updates ``state`` in
    place, as ``core/train.py``'s step does."""
    m = store.check(cfg, device=device)
    if not m.get("train_step") or TRAIN_STEP not in m["entries"]:
        raise ExportMismatch(f"export store {store.root} holds no train "
                             "step")
    fn = _train_step_fn(m, cfg)
    store.install_kernels()
    return fn
