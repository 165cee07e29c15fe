"""The port's background checkpoint writer, interrupt checkpoints,
verification and retention, held against the JAX package on the CPU.

Every checkpoint and interrupt file the port writes, from the background
writer or inline, is the JAX package's byte for byte, manifest included,
and each package restores the other's interrupt file; the snapshot owns
its copy before ``save_epoch`` returns; a writer's failure and a full
slot surface on the caller's thread; verification, the fallback order
and retention are the JAX package's exactly.
"""

import contextlib
import json
import logging
import os
import threading

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from mx_rcnn_tpu.core.train import TrainState as JTrainState
from mx_rcnn_tpu.ft import integrity as jintegrity
from mx_rcnn_tpu.utils import checkpoint as jckpt
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.ft import integrity, snapshot
from mx_rcnn_tpu_torch.utils import checkpoint as tckpt
from mx_rcnn_tpu_torch.utils.bridge import train_state_to_flax
from tests.test_torch_checkpoint import _TINY, _assert_same_tree

torch.set_num_threads(1)

FP = "0123456789abcdef"     # one fingerprint string for both packages
TOPO = {"devices": 1, "processes": 1, "grad_accum": 2, "global_batch": 4}


def _state(seed=5, count=3):
    """A tiny port train state with a random bf16 trace and ``count``
    updates."""
    cfg = generate_config("tiny", "PascalVOC", **_TINY)
    state = ttrain.setup_training(cfg, "cpu", seed=seed, steps_per_epoch=4)
    gen = torch.Generator().manual_seed(seed)
    for t in state.optimizer.trace.values():
        t.copy_(torch.randn(t.shape, generator=gen))
    state.optimizer.count = count
    return cfg, state


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _jax_state(path):
    """The JAX package's ``TrainState`` holding a checkpoint file's
    tree (read by flax)."""
    raw = serialization.msgpack_restore(_read(path))
    return JTrainState(raw["step"], raw["params"], raw["batch_stats"],
                       raw["opt_state"])


def _manifest(path):
    return json.loads(_read(tckpt.manifest_path(path)))


# ---- bytes ------------------------------------------------------------------

def test_async_sync_and_save_checkpoint_write_the_jax_packages_bytes(
        tmp_path):
    cfg, state = _state()
    paths = {}
    for kind in ("inline", "sync", "async"):
        prefix = str(tmp_path / kind / "m")
        if kind == "inline":
            paths[kind] = tckpt.save_checkpoint(
                prefix, 2, state, steps_per_epoch=4, config_fp=FP,
                topology=TOPO)
            continue
        snap = (snapshot.AsyncSnapshotter if kind == "async"
                else snapshot.SyncSnapshotter)(prefix, None, 4,
                                               topology=TOPO)
        snap.config_fp = FP
        paths[kind] = snap.save_epoch(2, state)
        snap.close()
    jprefix = str(tmp_path / "jax" / "m")
    jpath = jckpt.save_checkpoint(jprefix, 2, _jax_state(paths["inline"]),
                                  steps_per_epoch=4, config_fp=FP,
                                  topology=TOPO)
    for kind, path in paths.items():
        assert _read(path) == _read(jpath), kind
        assert _read(tckpt.manifest_path(path)) == \
            _read(tckpt.manifest_path(jpath)), kind
    assert _manifest(jpath)["data_cursor"] == {
        "epoch": 0, "steps_in_epoch": 3, "batches_consumed": 6,
        "images_consumed": 12}


@pytest.mark.parametrize("writer", ["inline", "async", "sync"])
def test_interrupt_bytes_equal_the_jax_packages_and_restore_both_ways(
        tmp_path, writer):
    cfg, state = _state(count=6)
    prefix = str(tmp_path / "port" / "m")
    if writer == "inline":
        path = tckpt.save_interrupt(prefix, state, 4, config_fp=FP,
                                    topology=TOPO)
    else:
        snap = (snapshot.AsyncSnapshotter if writer == "async"
                else snapshot.SyncSnapshotter)(prefix, None, 4,
                                               topology=TOPO)
        snap.config_fp = FP
        path = snap.save_interrupt(state)
        snap.close()
    assert path == tckpt.interrupt_path(prefix)
    m = _manifest(path)
    assert m["kind"] == "interrupt" and m["step"] == 6
    # the JAX package writes the same state to the same bytes
    epoch_path = tckpt.save_checkpoint(str(tmp_path / "e"), 1, state)
    jstate = _jax_state(epoch_path)
    jprefix = str(tmp_path / "jax" / "m")
    jpath = jckpt.save_interrupt(jprefix, jstate, 4, config_fp=FP,
                                 topology=TOPO)
    assert _read(path) == _read(jpath)
    assert _read(tckpt.manifest_path(path)) == \
        _read(tckpt.manifest_path(jpath))
    # the JAX package restores the port's file ...
    template = jax.tree.map(np.zeros_like, jstate)
    restored, spe = jckpt.restore_interrupt(template, prefix)
    assert spe == 4
    _assert_same_tree(serialization.to_state_dict(restored),
                      serialization.to_state_dict(jstate))
    # ... and the port the JAX package's
    _, fresh = _state(seed=9, count=0)
    _, spe = tckpt.restore_interrupt(fresh, jprefix)
    assert spe == 4 and fresh.step == 6
    _assert_same_tree(train_state_to_flax(fresh.model, fresh.optimizer),
                      train_state_to_flax(state.model, state.optimizer))


def test_clear_interrupt_removes_the_manifest_first(tmp_path, monkeypatch):
    _, state = _state()
    prefix = str(tmp_path / "m")
    path = tckpt.save_interrupt(prefix, state, 4)
    order = []
    real = os.unlink
    monkeypatch.setattr(tckpt.os, "unlink",
                        lambda p: (order.append(p), real(p)))
    tckpt.clear_interrupt(prefix)
    assert order == [tckpt.manifest_path(path), path]
    assert not os.path.exists(path)
    tckpt.clear_interrupt(prefix)   # nothing left: no error


# ---- the writer -------------------------------------------------------------

def test_the_snapshot_owns_its_copy_before_save_epoch_returns(tmp_path):
    """The model and the trace change right after ``save_epoch``, as the
    next in-place step changes them; the file holds the old values."""
    _, state = _state()
    want = train_state_to_flax(state.model, state.optimizer)
    snap = snapshot.AsyncSnapshotter(str(tmp_path / "m"), None, 4)
    path = snap.save_epoch(1, state)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        for t in state.optimizer.trace.values():
            t.add_(1.0)
        for name, b in state.model.named_buffers():
            b.add_(1.0)
    state.optimizer.count += 1
    snap.close()
    prefix = str(tmp_path / "m")
    got = tckpt.load_checkpoint(prefix, 1)
    _assert_same_tree(got, want)
    assert _manifest(path)["step"] == 3


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_a_writer_failure_surfaces_on_the_callers_thread(tmp_path,
                                                         monkeypatch, mode):
    _, state = _state()

    def disk_full(*args, **kw):
        raise OSError("No space left on device")

    monkeypatch.setattr(snapshot, "commit_checkpoint", disk_full)
    cfg = generate_config("tiny", "PascalVOC",
                          ft__async_snapshots=mode == "async")
    snap = snapshot.make_snapshotter(str(tmp_path / "m"), cfg, 4)
    if mode == "sync":
        with pytest.raises(OSError, match="No space"):
            snap.save_epoch(1, state)
        return
    snap.save_epoch(1, state)        # handed over: the write fails later
    with pytest.raises(snapshot.SnapshotError, match="No space"):
        snap.flush()
    snap.save_epoch(2, state)
    with pytest.raises(snapshot.SnapshotError, match="No space"):
        snap.close()
    with pytest.raises(snapshot.SnapshotError, match="closed"):
        snap.save_epoch(3, state)


def test_a_full_slot_fails_after_its_timeout(tmp_path, monkeypatch):
    """One write in flight and one queued: the third request waits
    ``slot_timeout_s`` and fails; the two accepted ones still commit."""
    _, state = _state()
    started, release = threading.Event(), threading.Event()
    real = snapshot.serialize_state

    def slow(host):
        started.set()
        release.wait(30)
        return real(host)

    monkeypatch.setattr(snapshot, "serialize_state", slow)
    snap = snapshot.AsyncSnapshotter(str(tmp_path / "m"), None, 4,
                                     slot_timeout_s=0.2)
    snap.save_epoch(1, state)
    assert started.wait(30)
    snap.save_epoch(2, state)
    with pytest.raises(snapshot.SnapshotError, match="still busy"):
        snap.save_epoch(3, state)
    release.set()
    snap.close()
    assert not snap._thread.is_alive()
    assert [e for e, _ in tckpt.list_checkpoints(str(tmp_path / "m"))] == \
        [1, 2]


def test_a_step_that_goes_backwards_is_refused(tmp_path):
    _, state = _state(count=5)
    snap = snapshot.SyncSnapshotter(str(tmp_path / "m"), None, 4)
    snap.save_epoch(1, state)
    state.optimizer.count = 4
    with pytest.raises(snapshot.SnapshotError, match="backwards"):
        snap.save_epoch(2, state)


# ---- verification, fallback, retention --------------------------------------

def _commit(prefix, kind, step, epoch=None, payload=None):
    path = (tckpt.checkpoint_path(prefix, epoch) if kind == "epoch"
            else tckpt.interrupt_path(prefix))
    return tckpt.commit_checkpoint(
        path, payload or f"{kind}-{step}-{epoch}".encode() * 64, kind=kind,
        step=step, epoch=epoch, steps_per_epoch=4)


def _corrupt(how, path):
    if how == "flipped byte":
        data = bytearray(_read(path))
        data[len(data) // 2] ^= 0x01
        open(path, "wb").write(bytes(data))
    elif how == "truncated":
        open(path, "wb").write(_read(path)[:-7])
    elif how == "no manifest":
        os.unlink(tckpt.manifest_path(path))
    elif how == "unparseable manifest":
        open(tckpt.manifest_path(path), "wb").write(b"{not json")
    elif how == "manifest lists no files":
        m = _manifest(path)
        m["files"] = {}
        open(tckpt.manifest_path(path), "w").write(json.dumps(m))
    elif how == "file missing":
        os.unlink(path)


CORRUPTIONS = ("flipped byte", "truncated", "no manifest",
               "unparseable manifest", "manifest lists no files",
               "file missing")


@pytest.mark.parametrize("how", ("none",) + CORRUPTIONS)
def test_verify_checkpoint_catches_each_corruption(tmp_path, how):
    path = _commit(str(tmp_path / "m"), "epoch", 4, 1)
    _corrupt(how, path)
    ok, reason = integrity.verify_checkpoint(path)
    assert (ok, reason) == jintegrity.verify_checkpoint(path)
    assert ok == (how == "none"), reason


# (kind, step, epoch) files; then the corruptions, by index
SCENARIOS = {
    "epochs only": ([("epoch", 4, 1), ("epoch", 8, 2), ("epoch", 12, 3)],
                    []),
    "fresh interrupt": ([("epoch", 4, 1), ("epoch", 8, 2),
                         ("interrupt", 10, None)], []),
    "stale interrupt": ([("epoch", 4, 1), ("interrupt", 6, None),
                         ("epoch", 8, 2)], []),
    "interrupt ties an epoch": ([("epoch", 4, 1), ("interrupt", 8, None),
                                 ("epoch", 8, 2)], []),
    "corrupt newest": ([("epoch", 4, 1), ("epoch", 8, 2), ("epoch", 12, 3)],
                       [(2, "flipped byte")]),
    "corrupt interrupt": ([("epoch", 4, 1), ("epoch", 8, 2),
                           ("interrupt", 10, None)], [(2, "truncated")]),
    "two bad": ([("epoch", 4, 1), ("epoch", 8, 2), ("interrupt", 10, None)],
                [(2, "no manifest"), (1, "flipped byte")]),
    "nothing valid": ([("epoch", 4, 1)], [(0, "truncated")]),
}


def _refs(refs):
    return [(c.kind, c.path, c.step, c.epoch) for c in refs]


@contextlib.contextmanager
def _warnings_of(name: str):
    """The messages ``name``'s logger emits at WARNING and above, with a
    handler of its own (other tests may stop it propagating)."""
    logger = logging.getLogger(name)
    records: list = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda r: records.append(r.getMessage())
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.WARNING)
    try:
        yield records
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fallback_order_is_the_jax_packages(tmp_path, name):
    files, bad = SCENARIOS[name]
    prefix = str(tmp_path / "m")
    paths = [_commit(prefix, *f) for f in files]
    for i, how in bad:
        _corrupt(how, paths[i])
    got = integrity.scan_candidates(prefix)
    assert _refs(got) == _refs(jintegrity.scan_candidates(prefix))
    with _warnings_of("mx_rcnn_tpu_torch") as ours, \
            _warnings_of("mx_rcnn_tpu") as theirs:
        ref = integrity.latest_valid_checkpoint(prefix)
        want = jintegrity.latest_valid_checkpoint(prefix)
    assert (ref is None) == (want is None)
    if ref is not None:
        assert _refs([ref]) == _refs([want])
    # one warning for each candidate fallen past, as in the JAX package
    assert ours == theirs
    assert all("SKIPPING" in m for m in ours)
    passed = [c.path for c in got]
    assert len(ours) == (passed.index(ref.path) if ref is not None
                         else len(passed))


@pytest.mark.parametrize("keep_last", [0, 1, 3])
@pytest.mark.parametrize("keep_every", [0, 1, 2, 5])
def test_retention_is_the_jax_packages(tmp_path, keep_last, keep_every):
    epochs = [1, 2, 3, 4, 5, 6, 7, 9, 10, 12]
    want = jintegrity.retention_keep_set(epochs, keep_last, keep_every)
    assert integrity.retention_keep_set(epochs, keep_last, keep_every) == \
        want
    prefix = str(tmp_path / "m")
    for e in epochs:
        _commit(prefix, "epoch", 4 * e, e)
    deleted = integrity.gc_checkpoints(prefix, keep_last, keep_every)
    assert sorted(deleted) == sorted(tckpt.checkpoint_path(prefix, e)
                                     for e in epochs if e not in want)
    assert {e for e, _ in tckpt.list_checkpoints(prefix)} == want
    for e in want:
        assert integrity.verify_checkpoint(
            tckpt.checkpoint_path(prefix, e))[0]
    assert not [n for n in os.listdir(tmp_path)
                if n.endswith(".manifest.json")
                and not os.path.exists(tmp_path / n[:-len(".manifest.json")])]


def test_the_writer_clears_the_interrupt_and_runs_retention(tmp_path):
    cfg = generate_config("tiny", "PascalVOC", ft__keep_last=2,
                          ft__keep_every=0)
    _, state = _state(count=1)
    prefix = str(tmp_path / "m")
    snap = snapshot.make_snapshotter(prefix, cfg, 4)
    assert isinstance(snap, snapshot.AsyncSnapshotter)
    snap.save_interrupt(state)
    assert os.path.exists(tckpt.interrupt_path(prefix))
    for e in (1, 2, 3):
        state.optimizer.count = 4 * e
        snap.save_epoch(e, state)
    snap.close()
    assert not os.path.exists(tckpt.interrupt_path(prefix))
    assert [e for e, _ in tckpt.list_checkpoints(prefix)] == [2, 3]


@pytest.mark.parametrize("step,spe,topology", [
    (0, 4, TOPO), (7, 4, TOPO), (12, 4, TOPO), (5, None, TOPO),
    (5, 4, None), (9, 3, {"devices": 2, "processes": 1, "grad_accum": 1,
                          "global_batch": 4}),
    (9, 3, jckpt.make_topology(4, 2, 3, 2)),
])
@pytest.mark.parametrize("kind", ["epoch", "interrupt"])
def test_manifest_topology_and_cursor_are_the_jax_packages(
        tmp_path, step, spe, topology, kind):
    assert tckpt.make_topology(4, 2, 3, 2) == jckpt.make_topology(4, 2, 3, 2)
    assert tckpt.make_topology(1, grad_accum=2, batch_images=2) == TOPO
    data = b"payload" * 9
    a, b = str(tmp_path / "a" / "x.ckpt"), str(tmp_path / "b" / "x.ckpt")
    os.makedirs(os.path.dirname(a))
    os.makedirs(os.path.dirname(b))
    kw = dict(kind=kind, step=step, epoch=None if kind == "interrupt" else 2,
              steps_per_epoch=spe, config_fp=FP, topology=topology)
    tckpt.write_manifest(a, data, **kw)
    jckpt.write_manifest(b, data, **kw)
    assert _read(tckpt.manifest_path(a)) == _read(tckpt.manifest_path(b))
