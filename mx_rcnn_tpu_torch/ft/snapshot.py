"""Checkpoints written on a background thread.

Counterpart of ``mx_rcnn_tpu/ft/snapshot.py``.  A save splits at its
seam:

* the step's thread takes an owned host copy of the train state
  (:func:`fetch_owned`: every weight, frozen-BN statistic and momentum
  trace, and the update count) and hands it over.  The port's step
  updates the model and the trace in place, so the copy must be whole
  before the next step runs; it is, since :func:`fetch_owned` waits for
  its device-to-host copies before it returns;
* one writer thread serialises the copy, writes it durably (tmp, fsync,
  rename, directory fsync), commits its manifest, clears a superseded
  interrupt checkpoint and runs retention.

At most one snapshot is being written and one waits, so at most two host
copies are alive; the request that would make a third waits up to
``ft.slot_timeout_s`` and then fails.  On a card the copies land in
pinned buffers that the snapshotter keeps for the run and reuses once a
write has committed: page-locking a ResNet-101 state's 285 MB costs far
more than the copy (PERF.md §6).  :meth:`prepare` allocates two sets
before the first step (``core/fit.py`` calls it), so no snapshot pays
it.  A writer's error is raised again
on the step's thread at the next request, ``flush`` or ``close``.

:class:`SyncSnapshotter` (``ft.async_snapshots=false``) does the same
work on the calling thread, through the same :func:`_write_job`, so the
bytes on disk do not depend on the mode and equal what
``utils/checkpoint.py — save_checkpoint`` writes.

With ``cfg.obs.enabled`` a snapshotter records into the process
registry: ``snapshot.stall_ms`` (what a request costs the step's thread:
the host copy and the hand-over, or the whole write when synchronous),
and from the writer ``snapshot.commits``, ``snapshot.bytes`` and
``snapshot.commit_ms`` (serialise to durable commit).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import List, Optional

from mx_rcnn_tpu_torch.ft.integrity import gc_checkpoints
from mx_rcnn_tpu_torch.utils.bridge import HostTrainState, host_train_state
from mx_rcnn_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                clear_interrupt,
                                                commit_checkpoint,
                                                config_fingerprint,
                                                interrupt_path,
                                                serialize_interrupt,
                                                serialize_state)

logger = logging.getLogger("mx_rcnn_tpu_torch")


def fetch_owned(state, buffers: Optional[HostTrainState] = None
                ) -> HostTrainState:
    """Owned host copies of a ``core/train.py — TrainState`` at its
    current step, complete when this returns (into ``buffers``' pinned
    tensors, whose owner the caller must be)."""
    return host_train_state(state.model, state.optimizer, buffers)


class _PinnedPool:
    """A snapshotter's pinned host copies, reused once written: the step
    thread takes a set, the writer gives it back after its commit."""

    def __init__(self):
        self._free: List[HostTrainState] = []
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._free)

    def take(self) -> Optional[HostTrainState]:
        with self._lock:
            return self._free.pop() if self._free else None

    def give(self, host: HostTrainState) -> None:
        # a CPU state's copies are plain clones: nothing worth keeping
        if any(t.is_pinned() for t in host.state_dict.values()):
            with self._lock:
                self._free.append(host)


class SnapshotError(RuntimeError):
    """A snapshot could not be taken: the writer is closed or dead, the
    slot stayed busy past its timeout, or an earlier write failed."""


class _Job:
    """One write: a host copy and what its manifest records."""

    def __init__(self, kind: str, path: str, host: HostTrainState,
                 epoch: Optional[int], steps_per_epoch: Optional[int],
                 config_fp: Optional[str], clear_interrupt_after: bool,
                 gc_fn=None, topology=None, rec=None, release=None):
        self.kind = kind
        self.path = path
        self.host = host
        self.epoch = epoch
        self.steps_per_epoch = steps_per_epoch
        self.config_fp = config_fp
        self.clear_interrupt_after = clear_interrupt_after
        self.gc_fn = gc_fn
        self.topology = topology
        self.release = release
        self.rec = rec


def _write_job(job: _Job, prefix: str) -> str:
    """Serialise and commit one snapshot, then clear the interrupt file
    (only once the epoch checkpoint that supersedes it is durable) and
    run retention."""
    t0 = time.perf_counter()
    if job.kind == "interrupt":
        data = serialize_interrupt(job.host, job.steps_per_epoch)
    else:
        data = serialize_state(job.host)
    commit_checkpoint(job.path, data, kind=job.kind, step=job.host.step,
                      epoch=job.epoch, steps_per_epoch=job.steps_per_epoch,
                      config_fp=job.config_fp, topology=job.topology)
    if job.release is not None:
        job.release(job.host)  # the bytes are written: the copy is free
    if job.rec is not None:
        job.rec.inc("snapshot.commits")
        job.rec.inc("snapshot.bytes", len(data))
        job.rec.observe("snapshot.commit_ms",
                        (time.perf_counter() - t0) * 1e3)
    if job.clear_interrupt_after:
        clear_interrupt(prefix)
    if job.gc_fn is not None:
        job.gc_fn()
    return job.path


class _SnapshotterBase:
    """The job construction both snapshotters share.  ``cfg`` gives the
    config fingerprint and the retention policy; ``steps_per_epoch`` and
    ``topology`` (``utils/checkpoint.py — make_topology``) go into every
    manifest."""

    def __init__(self, prefix: str, cfg=None,
                 steps_per_epoch: Optional[int] = None, topology=None):
        self.prefix = prefix
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.topology = topology
        self.config_fp = config_fingerprint(cfg) if cfg is not None else None
        self._last_step: Optional[int] = None
        self._pool = _PinnedPool()
        self._rec = None
        if cfg is not None and cfg.obs.enabled:
            from mx_rcnn_tpu_torch.obs.metrics import registry

            self._rec = registry()

    def prepare(self, state, copies: int = 2) -> None:
        """Allocate the pinned copies of ``state`` that snapshots reuse
        (none on the CPU): before the first step, so that no step pays
        the page-locking."""
        if not next(state.model.parameters()).is_cuda:
            return
        for _ in range(copies - len(self._pool)):
            self._pool.give(fetch_owned(state))

    def _observe_stall(self, t0: float) -> None:
        """The step thread's cost of one snapshot request."""
        if self._rec is not None:
            self._rec.observe("snapshot.stall_ms",
                              (time.perf_counter() - t0) * 1e3)

    def _gc_fn(self):
        if self.cfg is None or not self.cfg.ft.keep_last:
            return None
        cfg, prefix = self.cfg, self.prefix
        return lambda: gc_checkpoints(prefix, keep_last=cfg.ft.keep_last,
                                      keep_every=cfg.ft.keep_every)

    def _check_step(self, host: HostTrainState) -> None:
        """Within one snapshotter the step only moves forward; a negative
        or backward step means a corrupt state, refused before anything
        commits."""
        step = host.step
        if step < 0 or (self._last_step is not None
                        and step < self._last_step):
            raise SnapshotError(
                f"refusing to commit a snapshot at step {step} (last "
                f"committed {self._last_step}): the training step went "
                f"backwards; restart from the last valid checkpoint")
        self._last_step = step

    def _epoch_job(self, epoch: int, state) -> _Job:
        host = fetch_owned(state, self._pool.take())
        self._check_step(host)
        return _Job("epoch", checkpoint_path(self.prefix, epoch), host,
                    epoch, self.steps_per_epoch, self.config_fp,
                    clear_interrupt_after=True, gc_fn=self._gc_fn(),
                    topology=self.topology, rec=self._rec,
                    release=self._pool.give)

    def _interrupt_job(self, state) -> _Job:
        host = fetch_owned(state, self._pool.take())
        self._check_step(host)
        return _Job("interrupt", interrupt_path(self.prefix), host, None,
                    self.steps_per_epoch, self.config_fp,
                    clear_interrupt_after=False, topology=self.topology,
                    rec=self._rec, release=self._pool.give)


class AsyncSnapshotter(_SnapshotterBase):
    """Snapshots under ``prefix`` written and committed by one background
    thread."""

    def __init__(self, prefix: str, cfg=None,
                 steps_per_epoch: Optional[int] = None,
                 slot_timeout_s: Optional[float] = None, topology=None):
        super().__init__(prefix, cfg, steps_per_epoch, topology)
        self.slot_timeout_s = float(
            slot_timeout_s if slot_timeout_s is not None
            else (cfg.ft.slot_timeout_s if cfg is not None else 120.0))
        # one job written by the thread and one waiting here
        self._q: "queue.Queue[Optional[_Job]]" = queue.Queue(maxsize=1)
        self._error: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._writer_loop,
                                        name="ft-snapshot-writer",
                                        daemon=True)
        self._thread.start()

    def _writer_loop(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                path = _write_job(job, self.prefix)
                logger.info("snapshot committed: %s (step %d, background)",
                            path, job.host.step)
            except BaseException as e:  # noqa: BLE001 — raised to the caller
                logger.error("background snapshot write FAILED: %s", e)
                # threadlint: disable=TL201 single writer thread, single reader (train); a reference store is atomic — worst case the error surfaces one snapshot later
                self._error = e
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise SnapshotError(
                f"a previous background snapshot write failed: {err!r}"
            ) from err

    def _submit(self, job: _Job) -> str:
        self._raise_pending()
        if self._closed or not self._thread.is_alive():
            raise SnapshotError("snapshotter is closed or its writer died")
        try:
            self._q.put(job, timeout=self.slot_timeout_s)
        except queue.Full:
            raise SnapshotError(
                f"snapshot writer still busy after {self.slot_timeout_s:.0f}s "
                f"— disk cannot keep up with the snapshot cadence") from None
        return job.path

    def save_epoch(self, epoch: int, state) -> str:
        """Copy ``state`` to the host here and hand the write to the
        thread; returns the path the checkpoint will commit to."""
        t0 = time.perf_counter()
        path = self._submit(self._epoch_job(epoch, state))
        self._observe_stall(t0)
        return path

    def save_interrupt(self, state) -> str:
        """Copy ``state`` here, write it on the thread and wait for the
        commit: the caller is about to stop."""
        t0 = time.perf_counter()
        path = self._submit(self._interrupt_job(state))
        self._observe_stall(t0)
        self.flush()
        return path

    def flush(self) -> None:
        """Wait until every queued snapshot is committed; raises if a
        write failed."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """Flush and stop the writer (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join()
        self._raise_pending()


class SyncSnapshotter(_SnapshotterBase):
    """The same interface, written on the calling thread
    (``ft.async_snapshots=false``)."""

    def save_epoch(self, epoch: int, state) -> str:
        t0 = time.perf_counter()
        path = _write_job(self._epoch_job(epoch, state), self.prefix)
        self._observe_stall(t0)
        return path

    def save_interrupt(self, state) -> str:
        t0 = time.perf_counter()
        path = _write_job(self._interrupt_job(state), self.prefix)
        self._observe_stall(t0)
        return path

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def make_snapshotter(prefix: str, cfg, steps_per_epoch: Optional[int] = None,
                     topology=None):
    """``core/fit.py``'s snapshotter: background writes unless
    ``ft.async_snapshots`` is off."""
    if cfg is not None and cfg.ft.async_snapshots:
        return AsyncSnapshotter(prefix, cfg, steps_per_epoch,
                                topology=topology)
    return SyncSnapshotter(prefix, cfg, steps_per_epoch, topology=topology)
