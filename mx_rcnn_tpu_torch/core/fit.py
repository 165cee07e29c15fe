"""The training loop: epochs of the train step, a Speedometer log, a
checkpoint after each epoch and an interrupt checkpoint on a stop.

Counterpart of ``mx_rcnn_tpu/core/fit.py — fit`` with its staging,
gradient accumulation, snapshots, mid-epoch resume, multi-process data
parallelism and observability: each epoch's batches come from the
loader
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

With ``device_cache`` the loader runs once, its epoch 0 is staged on the
device (``data/device_cache.py``), and every step gathers its batch there
by the state's step: no stager, no host batch, a data wait of about 0.
It takes a one-bucket epoch and one batch per step (``grad_accum`` 1);
each rank of a data-parallel run stages its own row shard
(``parallel/dp.py — make_dp_cached_step``).  ``profile_dir`` records
steps [skip+2, skip+5) of the first epoch with ``torch.profiler`` into a
Chrome trace there (the JAX loop's ``jax.profiler`` window).

With ``cfg.obs.enabled`` the loop records into the process registry
(``obs/metrics.py``): ``train.steps``, ``train.epochs``, ``train.step_ms``,
``train.data_wait_ms``, the per-step ``train.data_wait_frac`` (gauge and
percent histogram), ``train.samples_per_sec`` and ``train.metric.<k>``
(the Speedometer's), ``train.loss_ema`` and ``train.epoch_s``; it opens
the spans ``train.data_wait``, ``train.dispatch`` (the step's launches:
the step is asynchronous, so the span ends before its kernels do),
``train.sync`` (the log window's one device sync) and ``train.snapshot``;
it runs the ``obs.profile_at_step`` window (``obs/profiler.py``), opens
and closes a SIGUSR2 window after the step the signal came in, and
appends ``epoch_start``, ``log``, ``epoch_end``, ``snapshot`` and
``interrupt`` events to ``run_record``.  Off, every touch is behind one
``rec is None`` branch, and the spans are one flag read each.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.train import TrainState, to_device
from mx_rcnn_tpu_torch.data.device_cache import (build_caches,
                                                 make_cached_step)
from mx_rcnn_tpu_torch.data.staging import DeviceStager
from mx_rcnn_tpu_torch.ft.snapshot import make_snapshotter
from mx_rcnn_tpu_torch.obs import trace as obs_trace
from mx_rcnn_tpu_torch.obs.profiler import poll_sigusr2
from mx_rcnn_tpu_torch.parallel.dp import (World, any_rank,
                                           make_dp_cached_step)
from mx_rcnn_tpu_torch.utils.checkpoint import make_topology

_END = object()


class Speedometer:
    """Samples/s, the data-wait share and the window's metric means on
    each log call (ref ``rcnn/core/callback.py — Speedometer``).  Call
    once per batch with the seconds it waited for that batch, and with
    the window's metrics on log batches and ``None`` otherwise.  With a
    ``registry`` each log call also sets ``train.samples_per_sec`` and
    ``train.metric.<name>``; the line stays the same."""

    def __init__(self, batch_size: int, log: Callable[[str], None] = print,
                 registry=None):
        self.batch_size = batch_size
        self.log = log
        self.registry = registry
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
        if self.registry is not None:
            self.registry.set_gauge("train.samples_per_sec", speed)
            for k, v in metrics.items():
                self.registry.set_gauge(f"train.metric.{k}", float(v))
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


def _stage_epoch(loader, step_fn, world: World, grad_accum: int,
                 log: Callable[[str], None]):
    """The device-cache path: the loader's epoch 0 staged on this rank's
    device, and ``step_fn`` wrapped to gather from it.  Refuses what the
    cache cannot feed: several buckets, several batches a step."""
    if grad_accum > 1:
        raise ValueError(
            "device_cache does not compose with grad_accum > 1 (the device "
            "epoch cache gathers exactly one batch per step); use the "
            "streaming loader")
    loader.set_epoch(0)
    caches = build_caches(loader, device=world.device)
    if len(caches) != 1:
        raise ValueError(
            f"device_cache needs a single-bucket dataset (got {len(caches)} "
            f"buckets); use the streaming loader")
    cache = caches[0]
    if world.group is None:
        step = make_cached_step(step_fn, cache.num_batches, loader.shuffle)
    else:
        step = make_dp_cached_step(step_fn, world, cache, loader.shuffle)
    log(f"device cache: {cache.num_batches} batches of "
        f"{cache.batch_images} images staged on {world.device} "
        f"({cache.nbytes / 1e6:.1f} MB), shuffle={loader.shuffle}")
    return cache, step


def _start_profile(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str, world: World,
                  log: Callable[[str], None]) -> None:
    if world.device.type == "cuda":
        torch.cuda.synchronize(world.device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json" if world.size == 1
                        else f"trace-rank{world.rank}.json")
    prof.export_chrome_trace(path)
    log(f"profiler trace written to {path}")


def _step_profiler(cfg: Config, run_record, world: World):
    """The ``obs.profile_at_step`` window, or None."""
    if cfg.obs.profile_at_step <= 0:
        return None
    from mx_rcnn_tpu_torch.obs.profiler import StepProfiler

    pdir = cfg.obs.profile_dir or os.path.join(
        run_record.dir if run_record is not None else "obs_trace", "profile")
    if world.size > 1 and cfg.obs.profile_dir:
        pdir = os.path.join(pdir, f"rank{world.rank}")
    return StepProfiler(pdir, cfg.obs.profile_at_step, cfg.obs.profile_steps)


def _device_sync(device: torch.device) -> Optional[Callable[[], None]]:
    if device.type != "cuda":
        return None
    return lambda: torch.cuda.synchronize(device)


def fit(state: TrainState, cfg: Config, step_fn, loader, end_epoch: int,
        begin_epoch: int = 0, prefix: Optional[str] = None,
        max_steps: Optional[int] = None, frequent: Optional[int] = None,
        log: Callable[[str], None] = print,
        stop_flag: Optional[Callable[[], bool]] = None,
        grad_accum: int = 1, data_cursor: Optional[Dict] = None,
        world: Optional[World] = None, device_cache: bool = False,
        profile_dir: Optional[str] = None, run_record=None,
        step_callback: Optional[Callable[[int], None]] = None
        ) -> Dict[str, float]:
    """Run epochs ``begin_epoch .. end_epoch - 1``, saving a checkpoint
    under ``prefix`` (when given) after each whole one; ``max_steps`` ends
    the run early, and an epoch it cuts is not saved.  ``step_fn`` takes
    lists of ``grad_accum`` batches when that is above 1; an epoch has
    ``len(loader) // grad_accum`` optimizer steps.  ``data_cursor``
    (``tools/train.py`` reads it from an interrupt checkpoint's manifest):
    ``loader_batch_images`` and ``images_consumed_in_epoch`` of the run
    that wrote it.  ``world``: this rank's place in a data-parallel run,
    whose ``loader`` has the global plan and yields this rank's rows (a
    world of one by default).  ``device_cache``: stage the epoch on the
    device and gather each step's batch there; ``profile_dir``: trace
    three steps of the first epoch there (module docstring).
    ``run_record``: an ``obs/runrec.py`` RunRecord the loop appends its
    events to.  ``step_callback``: called with the global step after
    each step.  Returns the last log window's mean metrics."""
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
    # observability: rec stays None when cfg.obs is off, and every touch
    # below hides behind that one check
    rec = sprof = loss_ema = None
    if cfg.obs.enabled:
        from mx_rcnn_tpu_torch.obs.metrics import registry

        rec = registry()
        sprof = _step_profiler(cfg, run_record, world)
    sync = _device_sync(world.device)
    speed = Speedometer(loader.batch_images * grad_accum, log, registry=rec)
    snap = None
    if prefix is not None and world.lead:
        snap = make_snapshotter(prefix, cfg, steps_per_epoch, make_topology(
            world.size, num_processes=world.size, grad_accum=grad_accum,
            batch_images=loader.batch_images // world.size))
    last: Dict[str, float] = {}
    done = state.step
    step = 0
    stager = None
    prof = None
    failed = False
    cache = None
    try:
        if device_cache:
            cache, step_fn = _stage_epoch(loader, step_fn, world,
                                          grad_accum, log)
        for epoch in range(begin_epoch, end_epoch):
            loader.set_epoch(epoch)
            skip = 0
            if epoch == begin_epoch:
                skip = min(max(done - epoch * steps_per_epoch, 0),
                           steps_per_epoch)
            if skip and cache is None:
                cur = data_cursor or {}
                if hasattr(loader, "resume_at"):
                    loader.resume_at(
                        cur.get("images_consumed_in_epoch",
                                skip * grad_accum * loader.batch_images),
                        cur.get("loader_batch_images"))
                else:
                    loader.skip_next_batches(skip * grad_accum)
            if skip:
                log(f"Epoch[{epoch}] resuming mid-epoch: skipping {skip} "
                    f"consumed steps")
            window: List[Dict[str, torch.Tensor]] = []
            nbatch = skip - 1
            if cache is not None:
                # the step gathers by state.step, past the skipped prefix
                batches = itertools.repeat(cache, steps_per_epoch - skip)
            elif cfg.data.staging:
                stager = DeviceStager(loader, device, cfg.data.stage_depth,
                                      rec=rec)
                batches = iter(stager)
            else:
                batches = (to_device(b, device) for b in loader)
            if grad_accum > 1:
                batches = _accum_iter(batches, grad_accum)
            if run_record is not None:
                run_record.event("epoch_start", epoch=epoch, skip=skip,
                                 steps_per_epoch=steps_per_epoch)
            t_epoch, wait_epoch = time.perf_counter(), 0.0
            interrupt = False
            while True:
                t0 = time.perf_counter()
                if rec is None:
                    batch = next(batches, _END)
                else:
                    with obs_trace.span("train.data_wait"):
                        batch = next(batches, _END)
                wait_s = time.perf_counter() - t0
                if batch is _END:
                    break
                wait_epoch += wait_s
                nbatch += 1
                if (profile_dir is not None and epoch == begin_epoch
                        and nbatch == skip + 2):
                    prof = _start_profile(world.device)
                if rec is None:
                    window.append(step_fn(state, batch))
                else:
                    with obs_trace.span("train.dispatch"):
                        window.append(step_fn(state, batch))
                    step_s = time.perf_counter() - t0
                    frac = wait_s / max(step_s, 1e-9)
                    rec.inc("train.steps")
                    rec.observe("train.step_ms", step_s * 1e3)
                    rec.observe("train.data_wait_ms", wait_s * 1e3)
                    rec.set_gauge("train.data_wait_frac", frac)
                    # the per-step share as a distribution (percent, for
                    # the log buckets): its p50 is the honest statistic
                    rec.observe("train.data_wait_frac_pct", 100.0 * frac,
                                lo=0.01, hi=1000.0)
                step += 1
                if prof is not None and nbatch == skip + 4:
                    _stop_profile(prof, profile_dir, world, log)
                    prof = None
                stop = step == max_steps
                interrupt = any_rank(stop_flag is not None and stop_flag(),
                                     world)
                is_log = ((nbatch + 1) % frequent == 0 or stop or interrupt
                          or (epoch == end_epoch - 1
                              and nbatch == steps_per_epoch - 1))
                if is_log:
                    if rec is None:
                        last = mean_metrics(window)
                    else:
                        with obs_trace.span("train.sync"):
                            last = mean_metrics(window)
                    window = []
                speed(epoch, nbatch, last if is_log else None, wait_s)
                # after the log window's sync: a window opened here starts
                # on an idle device when every step logs
                global_step = epoch * steps_per_epoch + nbatch + 1
                if sprof is not None:
                    sprof.on_step(global_step, sync=sync)
                if rec is not None:
                    poll_sigusr2(sync)
                if step_callback is not None:
                    step_callback(global_step)
                if is_log and rec is not None:
                    loss = last.get("loss")
                    if loss is not None:
                        a = cfg.obs.loss_ema
                        loss_ema = (loss if loss_ema is None
                                    else a * loss_ema + (1 - a) * loss)
                        rec.set_gauge("train.loss_ema", loss_ema)
                if is_log and run_record is not None:
                    run_record.event(
                        "log", epoch=epoch, nbatch=nbatch,
                        samples_per_sec=(None if rec is None else
                                         rec.gauge("train.samples_per_sec")),
                        **last)
                if stop:
                    return last
                if interrupt:
                    if nbatch < steps_per_epoch - 1:
                        # mid-epoch: the step-exact interrupt checkpoint;
                        # on the epoch's last step the epoch checkpoint
                        # below supersedes it
                        if snap is not None:
                            with obs_trace.span("train.snapshot",
                                                kind="interrupt"):
                                path = snap.save_interrupt(state)
                            if run_record is not None:
                                run_record.event("interrupt", epoch=epoch,
                                                 nbatch=nbatch, path=path)
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
            if prof is not None:  # an epoch shorter than the window
                _stop_profile(prof, profile_dir, world, log)
                prof = None
            wall = time.perf_counter() - t_epoch
            log(f"Epoch[{epoch}] {nbatch + 1 - skip} steps in {wall:.3f} s, "
                f"data wait {wait_epoch:.3f} s "
                f"({100 * wait_epoch / max(wall, 1e-9):.1f}%)")
            if rec is not None:
                rec.inc("train.epochs")
                rec.set_gauge("train.epoch_s", wall)
            if run_record is not None:
                run_record.event("epoch_end", epoch=epoch, nbatch=nbatch,
                                 epoch_s=round(wall, 3),
                                 data_wait_s=round(wait_epoch, 3), **last)
            if snap is not None and nbatch == steps_per_epoch - 1:
                with obs_trace.span("train.snapshot", kind="epoch"):
                    path = snap.save_epoch(epoch + 1, state)
                if run_record is not None:
                    run_record.event("snapshot", epoch=epoch, path=path)
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
        if prof is not None:
            _stop_profile(prof, profile_dir, world, log)
        if sprof is not None:
            sprof.close(sync)  # a run shorter than the window
        if snap is not None:
            snap.close()
        if not failed:
            world.barrier()
