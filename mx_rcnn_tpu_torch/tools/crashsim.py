"""crashsim runner — systematic crash-state enumeration over the port's
three persistence planes.

Counterpart of ``mx_rcnn_tpu/tools/crashsim.py``.  Records three REAL
workloads of the port through the interposition shim
(``analysis/crashsim.py — CrashRecorder``), enumerates every crash state
the persistence model allows, and runs each plane's REAL recovery path
against every state, asserting recover-or-refuse:

* **snapshotter** — the ft write path (``ft/snapshot.py —
  SyncSnapshotter`` over ``fetch_owned`` of a port ``TrainState``:
  epoch and interrupt commits, ``clear_interrupt``, retention GC)
  recovered via ``ft/integrity.py — latest_valid_checkpoint`` with a
  byte compare of the payload.  The state's model is a stand-in of a
  few KB (one dense layer), as the JAX arm's is, since every crash state
  materializes the payloads;
* **export** — an ``ExportStore`` commit of a tiny network's serving
  forward (``create`` → ``add`` → ``add_kernels`` on a card →
  ``add_variables`` → ``finish``) recovered via the port's real
  admission path: manifest parse, ``check(cfg, device=)``,
  ``install_kernels()``, the store's weights (sha-verified) into a
  predictor, ``load`` and the call, held to the recorded digest by
  ``require_digest``.  On a card every recovered state runs that
  forward, which launches K1 and K2; the report counts the launches;
* **bulk** — a ``BulkSink`` manifest + in-order shard commits,
  recovered via the resume path (manifest admission +
  ``committed_shards`` contiguity cursor + per-shard byte compare).

Sensitivity is proven, not assumed: two planted arms re-run workloads
with durability calls removed from the recorded log (the shim's
``drop=``) — ``planted_nofsync`` (the snapshotter with no fsync barriers
at all: the rename can publish torn data, GC can delete the only good
copy) and ``planted_nodirfsync`` (the export store without directory
fsyncs: a host crash loses the committed manifest).  ``--check`` fails
unless every real arm has ZERO violations over at least 10 states AND
every planted arm is flagged.

Kernels are built (a first forward) before the recorder is armed: the
shim patches ``open`` and ``os.*`` for the whole process while armed.
The record (the JAX tool's) is written only where ``--out`` names a
file.  The workloads run on ``--device`` (CUDA unless ``cpu``).

Usage::

    python -m mx_rcnn_tpu_torch.tools.crashsim [--smoke] [--check]
        [--device cuda|cpu] [--out FILE] [--max_states 256]
        [--workdir DIR]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.analysis.crashsim import CrashRecorder, simulate
from mx_rcnn_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("mx_rcnn_tpu_torch")

# the export arm's network: the tiny model on a 128x160 canvas, a
# serving batch of 2 (tests/test_torch_export.py's toy config)
EXPORT_OVERRIDES = dict(
    dataset__num_classes=4, bucket__scale=128, bucket__max_size=160,
    bucket__shapes=((128, 160), (160, 128)), test__rpn_pre_nms_top_n=256,
    test__rpn_post_nms_top_n=32, serve__batch_size=2,
    serve__score_thresh=0.0)
# the kernels the export arm's forward launches on a card (K1, K2)
EXPORT_KERNELS = ("nms_sweep", "roi_align_fwd")


# ---------------------------------------------------------------------------
# workload 1: snapshotter commit (the ft plane)
# ---------------------------------------------------------------------------

class _TinyNet(torch.nn.Module):
    """The snapshotter arm's model: one 8x8 dense layer (288 bytes of
    weights), so that a checkpoint is a few KB."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(8, 8)


def _tiny_state(step: int, device, seed: int = 0):
    """A port ``core/train.py — TrainState`` at update ``step``: the tiny
    model's weights and its SGD trace drawn from ``seed + step``, the
    optimizer's count at ``step``."""
    from mx_rcnn_tpu_torch.config import Config
    from mx_rcnn_tpu_torch.core.train import init_state

    rng = np.random.RandomState(seed + step)
    model = _TinyNet()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.rand(*p.shape).astype(np.float32)))
    model = model.to(device)
    state = init_state(model, Config(), steps_per_epoch=4, seed=seed)
    for t in state.optimizer.trace.values():
        t.copy_(torch.from_numpy(rng.rand(*t.shape).astype(np.float32)))
    state.optimizer.count = step
    return state


def run_snapshotter(root: str, drop: Tuple[str, ...] = (),
                    max_states: int = 256, device="cuda") -> Dict:
    """Drive the REAL snapshotter write path (epoch + interrupt commits,
    interrupt clearing, retention GC) under the recorder, then verify
    recover-or-refuse via ``latest_valid_checkpoint``."""
    from mx_rcnn_tpu_torch.config import Config
    from mx_rcnn_tpu_torch.ft.integrity import latest_valid_checkpoint
    from mx_rcnn_tpu_torch.ft.snapshot import SyncSnapshotter, fetch_owned
    from mx_rcnn_tpu_torch.utils.checkpoint import (serialize_interrupt,
                                                    serialize_state)

    dev = resolve_device(device)
    cfg = Config().replace_in("ft", keep_last=2, keep_every=0)
    work = os.path.join(root, "snap")
    os.makedirs(work)
    prefix = os.path.join(work, "model")
    # (ident, kind, epoch, state) in commit order; the interrupt sits
    # between epoch 1 and epoch 2 and is cleared by epoch 2's commit
    plan = [("epoch1", "epoch", 1, _tiny_state(10, dev)),
            ("interrupt15", "interrupt", None, _tiny_state(15, dev)),
            ("epoch2", "epoch", 2, _tiny_state(20, dev)),
            ("epoch3", "epoch", 3, _tiny_state(30, dev)),
            ("epoch4", "epoch", 4, _tiny_state(40, dev))]
    artifacts: Dict[str, bytes] = {}
    for ident, kind, _epoch, state in plan:
        host = fetch_owned(state)
        artifacts[ident] = (serialize_interrupt(host, 4)
                            if kind == "interrupt"
                            else serialize_state(host))
    snap = SyncSnapshotter(prefix, cfg, steps_per_epoch=4)
    with CrashRecorder(root, drop=drop) as rec:
        for ident, kind, epoch, state in plan:
            if kind == "interrupt":
                snap.save_interrupt(state)
            else:
                snap.save_epoch(epoch, state)
            rec.mark_commit(ident)

    def recover(d: str) -> Tuple[str, str]:
        ref = latest_valid_checkpoint(os.path.join(d, "snap", "model"))
        if ref is None:
            return ("refused", "no valid checkpoint under the prefix")
        with open(ref.path, "rb") as f:
            got = f.read()
        for ident, data in artifacts.items():
            if got == data:
                return ("recovered", ident)
        return ("corrupt",
                f"recovered {ref.path} matches no known payload")

    idents = [p[0] for p in plan]
    return _run("snapshotter", rec, root, recover, idents, max_states)


# ---------------------------------------------------------------------------
# workload 2: export-store commit (the serving plane)
# ---------------------------------------------------------------------------

def run_export(root: str, drop: Tuple[str, ...] = (),
               max_states: int = 256, device="cuda") -> Dict:
    """ExportStore create → add → add_kernels (on a card) →
    add_variables → finish under the recorder; recovery is the real
    admission path: manifest parse, ``check(cfg, device=)``, the bundled
    libraries installed, the bundled weights into a predictor, ``load``,
    the call and ``require_digest``."""
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.tester import Predictor
    from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
    from mx_rcnn_tpu_torch.serve.export import (ExportMismatch, ExportStore,
                                                _dummy_batch,
                                                predictor_from_variables,
                                                predictor_variables,
                                                serve_fwd_name)

    dev = resolve_device(device)
    cfg = generate_config("tiny", "synthetic", **EXPORT_OVERRIDES)
    store_dir = os.path.join(root, "store")
    bucket = tuple(cfg.bucket.shapes[0])
    n = cfg.serve.batch_size
    name = serve_fwd_name(bucket, n)
    images, im_info = _dummy_batch(bucket, n)
    predictor = Predictor(build_model(cfg, dev, seed=0), cfg, dev)
    # the first forward builds K1 and K2 on a card: before the recorder
    # is armed, so no build runs under the patched open
    outputs = predictor.raw(images, im_info)
    variables = predictor_variables(predictor)
    with CrashRecorder(root, drop=drop) as rec:
        store = ExportStore.create(store_dir, cfg, device=dev)
        store.add(name, (images, im_info), outputs)
        if dev.type == "cuda":
            store.add_kernels(list(EXPORT_KERNELS))
        store.add_variables(variables)
        store.finish()
        rec.mark_commit("store")

    def recover(d: str) -> Tuple[str, str]:
        sd = os.path.join(d, "store")
        try:
            store = ExportStore(sd)
            store.manifest()
        except (FileNotFoundError, ValueError) as e:
            return ("refused", f"no/unparseable manifest: {e}")
        try:
            store.check(cfg, device=dev)
            store.install_kernels()
            fn = store.load(name, predictor_from_variables(
                store.load_variables(), cfg, dev))
        except ExportMismatch as e:
            return ("refused", f"admission refused: {e}")
        except KeyError as e:
            return ("refused", f"manifest lists no such program: {e}")
        try:
            got = fn(images, im_info)
        except Exception as e:  # noqa: BLE001 — any crash here is a verdict
            return ("corrupt", f"admitted program failed to run: {e!r}")
        try:
            store.require_digest(name, got)
        except ExportMismatch:
            return ("corrupt", "admitted program computed different outputs")
        return ("recovered", "store")

    return _run("export", rec, root, recover, ["store"], max_states)


# ---------------------------------------------------------------------------
# workload 3: bulk shard commit (the bulk-inference plane)
# ---------------------------------------------------------------------------

def run_bulk(root: str, drop: Tuple[str, ...] = (),
             max_states: int = 256) -> Dict:
    """BulkSink manifest + three in-order shard commits under the
    recorder; recovery is the resume path: manifest admission, the
    committed-prefix cursor, per-shard byte compare."""
    from mx_rcnn_tpu_torch.serve.bulk import BulkSink, BulkSinkMismatch

    sink_dir = os.path.join(root, "sink")
    manifest = {"kind": "crashsim_bulk", "corpus_fingerprint": "f" * 16,
                "batches": 3}
    shards = {k: [f'{{"i":{k * 4 + j},"v":{j}}}' for j in range(4)]
              for k in range(3)}
    expected = {k: ("\n".join(lines) + "\n").encode()
                for k, lines in shards.items()}
    with CrashRecorder(root, drop=drop) as rec:
        sink = BulkSink(sink_dir, manifest=manifest)
        rec.mark_commit("manifest")
        for k in range(3):
            sink.commit(k, shards[k])
            rec.mark_commit(f"shard{k + 1}")

    def recover(d: str) -> Tuple[str, str]:
        sd = os.path.join(d, "sink")
        try:
            sink = BulkSink(sd)   # resume semantics: manifest REQUIRED
        except (ValueError, FileNotFoundError) as e:
            # includes BulkSinkMismatch and the no-manifest refusal
            return ("refused", f"sink admission refused: {e}")
        if sink.manifest != manifest:
            return ("refused", "manifest content mismatch")
        try:
            n = sink.committed_shards()
        except BulkSinkMismatch as e:
            return ("refused", f"non-contiguous cursor: {e}")
        for k in range(n):
            with open(sink.shard_path(k), "rb") as f:
                if f.read() != expected[k]:
                    return ("corrupt",
                            f"committed shard {k} is not byte-identical")
        return ("recovered", f"shard{n}" if n else "manifest")

    idents = ["manifest", "shard1", "shard2", "shard3"]
    return _run("bulk", rec, root, recover, idents, max_states)


# ---------------------------------------------------------------------------
# runner plumbing
# ---------------------------------------------------------------------------

def _run(name: str, rec: CrashRecorder, root: str, recover, idents,
         max_states: int) -> Dict:
    """``simulate`` over the recorded log, with the arm's seconds and the
    kernel launches its recoveries made."""
    t0 = time.perf_counter()
    scratch = os.path.join(root, "_scratch")
    before = kernels.launch_counts()
    level = logger.level
    logger.setLevel(logging.CRITICAL)   # the integrity scanner WARNs per
    try:                                # fallback — thousands of states
        report = simulate(rec.ops, root, recover, idents, scratch,
                          max_states_per_point=max_states)
    finally:
        logger.setLevel(level)
    after = kernels.launch_counts()
    report["workload"] = name
    report["idents"] = list(idents)
    report["kernel_launches"] = {k: after[k] - before.get(k, 0)
                                 for k in sorted(after)}
    report["elapsed_s"] = round(time.perf_counter() - t0, 2)
    return report


def _workload_root(base: str, tag: str) -> str:
    p = os.path.join(base, tag)
    if os.path.exists(p):
        shutil.rmtree(p)
    os.makedirs(p)
    return p


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="crashsim",
        description="crash-consistency enumeration over the port's "
                    "persistence planes")
    p.add_argument("--out", default=None,
                   help="write the JSON record here (default: none)")
    p.add_argument("--check", action="store_true",
                   help="exit 1 unless every real arm is violation-free "
                        "and every planted arm is flagged")
    p.add_argument("--smoke", action="store_true",
                   help="gate-scale run (smaller per-point state cap)")
    p.add_argument("--max_states", type=int, default=0,
                   help="per-crash-point state cap (0 = mode default)")
    p.add_argument("--workdir", default="",
                   help="capture workspace (default: a fresh tempdir)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    max_states = args.max_states or (128 if args.smoke else 256)
    own_base = not args.workdir
    base = args.workdir or tempfile.mkdtemp(prefix="crashsim-")
    if dev.type == "cuda":
        kernels.build_all()

    arms: List[Dict] = []
    print(f"crashsim: capture workspace {base} "
          f"(max_states/point={max_states}, device {dev})", flush=True)
    arms.append(run_snapshotter(_workload_root(base, "w1"),
                                max_states=max_states, device=dev))
    arms.append(run_export(_workload_root(base, "w2"),
                           max_states=max_states, device=dev))
    arms.append(run_bulk(_workload_root(base, "w3"),
                         max_states=max_states))
    # planted arms: the recorded log loses its durability barriers, as
    # if the code never called fsync / the dir-fsync — crashsim MUST
    # flag both, or the whole harness is a rubber stamp
    planted: List[Dict] = []
    planted.append(dict(run_snapshotter(
        _workload_root(base, "p1"), drop=("fsync", "dirfsync"),
        max_states=max_states, device=dev), workload="planted_nofsync"))
    planted.append(dict(run_export(
        _workload_root(base, "p2"), drop=("dirfsync",),
        max_states=max_states, device=dev), workload="planted_nodirfsync"))

    for rep in arms + planted:
        launched = {k: v for k, v in rep["kernel_launches"].items() if v}
        print(f"  {rep['workload']:>22}: ops={rep['ops']:3d} "
              f"states={rep['states_total']:5d} "
              f"(unique {rep['states_unique']}) recovered="
              f"{rep['recovered']} refused={rep['refused']} "
              f"violations={len(rep['violations'])} "
              f"launches={launched} [{rep['elapsed_s']}s]", flush=True)

    problems: List[str] = []
    for rep in arms:
        if rep["states_total"] < 10:
            problems.append(f"{rep['workload']}: only "
                            f"{rep['states_total']} crash states — the "
                            "recorder captured nothing meaningful")
        if rep["violations"]:
            v = rep["violations"][0]
            problems.append(f"{rep['workload']}: "
                            f"{len(rep['violations'])} recover-or-refuse "
                            f"violation(s), e.g. {v['problem']}")
    for rep in planted:
        if not rep["violations"]:
            problems.append(f"{rep['workload']}: the planted "
                            "removed-durability arm was NOT flagged — "
                            "zero sensitivity")

    record = {
        "metric": "crashsim_recover_or_refuse_violations",
        "value": sum(len(r["violations"]) for r in arms),
        "unit": "violations",
        "measured": True,
        "device": str(dev),
        "max_states_per_point": max_states,
        "workloads": {r["workload"]: _summ(r) for r in arms},
        "planted": {r["workload"]: _summ(r) for r in planted},
        "check": {"problems": problems, "ok": not problems},
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"crashsim: record -> {args.out}", flush=True)
    if own_base:
        # only sweep the tempdir THIS run created — an operator-supplied
        # --workdir (and whatever else lives in it) is theirs to keep
        shutil.rmtree(base, ignore_errors=True)
    if args.check:
        if problems:
            for pr in problems:
                print(f"CRASHSIM CHECK FAILED: {pr}", file=sys.stderr)
            return 1
        print("CRASHSIM CHECK OK: every crash state of every real arm "
              "recovered-or-refused; both planted arms flagged")
    return 0


def _summ(rep: Dict) -> Dict:
    out = {k: rep[k] for k in ("ops", "crash_points", "states_total",
                               "states_unique", "recovered", "refused",
                               "capped_points", "elapsed_s", "idents",
                               "kernel_launches")}
    out["violations"] = len(rep["violations"])
    out["violation_examples"] = rep["violations"][:3]
    return out


if __name__ == "__main__":
    raise SystemExit(main())
