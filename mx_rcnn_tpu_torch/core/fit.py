"""The training loop: epochs of the train step, a Speedometer log, a
checkpoint after each epoch and an interrupt checkpoint on a stop.

Counterpart of ``mx_rcnn_tpu/core/fit.py — fit`` with its staging,
gradient accumulation, snapshots, mid-epoch resume and multi-process
data parallelism, and without observability: each epoch's batches come
from the loader
in the order its (seed, epoch) plan gives, reach the device through a
:class:`DeviceStager` (the next batch is copied while the step runs;
``data.staging``, on by default) or a plain copy, are grouped
``grad_accum`` at a time (a partial trailing group is dropped) and go
through the step.  Every ``frequent`` steps one line reports samples/s,
the share of the window's wall time spent waiting for a batch and the
window's mean metrics (which stay on the device until then); each epoch
ends with a line of its wall time and data wait, and after each whole
epoch the state is saved as ``prefix-%04d.ckpt`` with the number of
epochs done, through ``ft/snapshot.py`` (written in the background
unless ``ft.async_snapshots`` is off).

A state whose step lies inside ``begin_epoch`` resumes mid-epoch: the
loader skips the batches that step consumed, by the data cursor
(``StreamLoader.resume_at``) or by ``skip_next_batches``.  ``stop_flag``
is polled after every step; once it returns True the loop writes the
step's interrupt checkpoint (or, on an epoch's last step, the epoch
checkpoint) and returns.

In a data-parallel run (a ``world`` of several ranks, ``parallel/dp.py``)
every rank runs this loop on its row shard of the global plan; rank 0
alone writes the checkpoints, whose manifests record the world's
topology, and the logs, whose images/s count the global batch.  The
stop decision is collective: each rank's flag is reduced over the world
after every step, so that all ranks stop after the same one.  The JAX
loop needs no such step, because its step is one collective program; a
rank that stopped alone here would leave the others blocked in the next
all-reduce.  A normal return ends with a barrier, so that no rank tears
the group down while rank 0 still writes.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.train import TrainState, to_device
from mx_rcnn_tpu_torch.data.staging import DeviceStager
from mx_rcnn_tpu_torch.ft.snapshot import make_snapshotter
from mx_rcnn_tpu_torch.parallel.dp import World, any_rank
from mx_rcnn_tpu_torch.utils.checkpoint import make_topology

_END = object()


class Speedometer:
    """Samples/s, the data-wait share and the window's metric means on
    each log call (ref ``rcnn/core/callback.py — Speedometer``).  Call
    once per batch with the seconds it waited for that batch, and with
    the window's metrics on log batches and ``None`` otherwise."""

    def __init__(self, batch_size: int, log: Callable[[str], None] = print):
        self.batch_size = batch_size
        self.log = log
        self._tic = time.perf_counter()
        self._since = 0
        self._wait = 0.0

    def __call__(self, epoch: int, nbatch: int,
                 metrics: Optional[Dict[str, float]],
                 wait_s: float = 0.0) -> None:
        self._since += 1
        self._wait += wait_s
        if not metrics:
            return
        elapsed = max(time.perf_counter() - self._tic, 1e-9)
        speed = self._since * self.batch_size / elapsed
        parts = ", ".join(f"{k}={v:.4f}" for k, v in metrics.items())
        self.log(f"Epoch[{epoch}] Batch [{nbatch}] "
                 f"Speed: {speed:.2f} samples/sec, data wait "
                 f"{100 * self._wait / elapsed:.1f}%, {parts}")
        self._tic = time.perf_counter()
        self._since = 0
        self._wait = 0.0


def mean_metrics(window: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Host-side mean of a window of metric dicts, with one device sync."""
    if not window:
        return {}
    keys = list(window[0])
    means = torch.stack([torch.stack([m[k] for m in window]).mean()
                         for k in keys]).tolist()
    return dict(zip(keys, means))


def _accum_iter(batches: Iterator, grad_accum: int) -> Iterator[list]:
    """Lists of ``grad_accum`` consecutive batches; a partial trailing
    group is dropped."""
    while True:
        group = []
        for _ in range(grad_accum):
            b = next(batches, _END)
            if b is _END:
                return
            group.append(b)
        yield group


def fit(state: TrainState, cfg: Config, step_fn, loader, end_epoch: int,
        begin_epoch: int = 0, prefix: Optional[str] = None,
        max_steps: Optional[int] = None, frequent: Optional[int] = None,
        log: Callable[[str], None] = print,
        stop_flag: Optional[Callable[[], bool]] = None,
        grad_accum: int = 1, data_cursor: Optional[Dict] = None,
        world: Optional[World] = None) -> Dict[str, float]:
    """Run epochs ``begin_epoch .. end_epoch - 1``, saving a checkpoint
    under ``prefix`` (when given) after each whole one; ``max_steps`` ends
    the run early, and an epoch it cuts is not saved.  ``step_fn`` takes
    lists of ``grad_accum`` batches when that is above 1; an epoch has
    ``len(loader) // grad_accum`` optimizer steps.  ``data_cursor``
    (``tools/train.py`` reads it from an interrupt checkpoint's manifest):
    ``loader_batch_images`` and ``images_consumed_in_epoch`` of the run
    that wrote it.  ``world``: this rank's place in a data-parallel run,
    whose ``loader`` has the global plan and yields this rank's rows (a
    world of one by default).  Returns the last log window's mean
    metrics."""
    if len(loader) == 0:
        raise ValueError("the loader yields no full batch")
    if grad_accum > len(loader):
        raise ValueError(
            f"grad_accum={grad_accum} exceeds the loader's {len(loader)} "
            f"batches an epoch: every epoch would run no step")
    frequent = cfg.default.frequent if frequent is None else frequent
    device = next(state.model.parameters()).device
    world = world or World.single(device)
    if not world.lead:
        log = lambda line: None  # noqa: E731
    steps_per_epoch = len(loader) // grad_accum
    speed = Speedometer(loader.batch_images * grad_accum, log)
    snap = None
    if prefix is not None and world.lead:
        snap = make_snapshotter(prefix, cfg, steps_per_epoch, make_topology(
            world.size, num_processes=world.size, grad_accum=grad_accum,
            batch_images=loader.batch_images // world.size))
    last: Dict[str, float] = {}
    done = state.step
    step = 0
    stager = None
    failed = False
    try:
        for epoch in range(begin_epoch, end_epoch):
            loader.set_epoch(epoch)
            skip = 0
            if epoch == begin_epoch:
                skip = min(max(done - epoch * steps_per_epoch, 0),
                           steps_per_epoch)
            if skip:
                cur = data_cursor or {}
                if hasattr(loader, "resume_at"):
                    loader.resume_at(
                        cur.get("images_consumed_in_epoch",
                                skip * grad_accum * loader.batch_images),
                        cur.get("loader_batch_images"))
                else:
                    loader.skip_next_batches(skip * grad_accum)
                log(f"Epoch[{epoch}] resuming mid-epoch: skipping {skip} "
                    f"consumed steps")
            window: List[Dict[str, torch.Tensor]] = []
            nbatch = skip - 1
            if cfg.data.staging:
                stager = DeviceStager(loader, device, cfg.data.stage_depth)
                batches = iter(stager)
            else:
                batches = (to_device(b, device) for b in loader)
            if grad_accum > 1:
                batches = _accum_iter(batches, grad_accum)
            t_epoch, wait_epoch = time.perf_counter(), 0.0
            interrupt = False
            while True:
                t0 = time.perf_counter()
                batch = next(batches, _END)
                wait_s = time.perf_counter() - t0
                if batch is _END:
                    break
                wait_epoch += wait_s
                nbatch += 1
                window.append(step_fn(state, batch))
                step += 1
                stop = step == max_steps
                interrupt = any_rank(stop_flag is not None and stop_flag(),
                                     world)
                is_log = ((nbatch + 1) % frequent == 0 or stop or interrupt
                          or (epoch == end_epoch - 1
                              and nbatch == steps_per_epoch - 1))
                if is_log:
                    last, window = mean_metrics(window), []
                speed(epoch, nbatch, last if is_log else None, wait_s)
                if stop:
                    return last
                if interrupt:
                    if nbatch < steps_per_epoch - 1:
                        # mid-epoch: the step-exact interrupt checkpoint;
                        # on the epoch's last step the epoch checkpoint
                        # below supersedes it
                        if snap is not None:
                            path = snap.save_interrupt(state)
                            log(f"stop requested: saved interrupt "
                                f'checkpoint to "{path}" (step '
                                f"{state.step}); rerun with --resume to "
                                f"continue")
                        else:
                            log("stop requested: no prefix, state not "
                                "saved")
                        return last
                    break
            if stager is not None:
                stager.close()
                stager = None
            wall = time.perf_counter() - t_epoch
            log(f"Epoch[{epoch}] {nbatch + 1 - skip} steps in {wall:.3f} s, "
                f"data wait {wait_epoch:.3f} s "
                f"({100 * wait_epoch / max(wall, 1e-9):.1f}%)")
            if snap is not None and nbatch == steps_per_epoch - 1:
                path = snap.save_epoch(epoch + 1, state)
                log(f'Epoch[{epoch}] Saved checkpoint to "{path}"')
            if interrupt:
                log(f"stop requested at the end of epoch {epoch}")
                return last
        return last
    except BaseException:
        failed = True
        raise
    finally:
        if stager is not None:
            stager.close()
        if snap is not None:
            snap.close()
        if not failed:
            world.barrier()
