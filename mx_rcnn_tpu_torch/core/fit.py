"""The training loop: epochs of the train step, a Speedometer log and a
checkpoint after each epoch.

Counterpart of ``mx_rcnn_tpu/core/fit.py — fit`` with its staging and
without interrupt checkpoints, data parallelism or observability: each
epoch's batches come from the loader in the order its (seed, epoch) plan
gives, reach the device through a :class:`DeviceStager` (the next batch
is copied while the step runs; ``data.staging``, on by default) or a
plain copy, and go through the step.  Every ``frequent`` steps one line
reports samples/s, the share of the window's wall time spent waiting for
a batch and the window's mean metrics (which stay on the device until
then); each epoch ends with a line of its wall time and data wait, and
after each whole epoch the state is saved as ``prefix-%04d.ckpt`` with
the number of epochs done.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.train import TrainState, to_device
from mx_rcnn_tpu_torch.data.staging import DeviceStager
from mx_rcnn_tpu_torch.utils.checkpoint import (config_fingerprint,
                                                save_checkpoint)

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


def fit(state: TrainState, cfg: Config, step_fn, loader, end_epoch: int,
        begin_epoch: int = 0, prefix: Optional[str] = None,
        max_steps: Optional[int] = None, frequent: Optional[int] = None,
        log: Callable[[str], None] = print) -> Dict[str, float]:
    """Run epochs ``begin_epoch .. end_epoch - 1``, saving a checkpoint
    under ``prefix`` (when given) after each whole one; ``max_steps`` ends
    the run early, and an epoch it cuts is not saved.  Returns the last
    log window's mean metrics."""
    if len(loader) == 0:
        raise ValueError("the loader yields no full batch")
    frequent = cfg.default.frequent if frequent is None else frequent
    device = next(state.model.parameters()).device
    speed = Speedometer(loader.batch_images, log)
    fingerprint = config_fingerprint(cfg)
    last: Dict[str, float] = {}
    step = 0
    for epoch in range(begin_epoch, end_epoch):
        loader.set_epoch(epoch)
        window: List[Dict[str, torch.Tensor]] = []
        nbatch = -1
        stager = None
        if cfg.data.staging:
            stager = DeviceStager(loader, device, cfg.data.stage_depth)
            batches = iter(stager)
        else:
            batches = (to_device(b, device) for b in loader)
        t_epoch, wait_epoch = time.perf_counter(), 0.0
        try:
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
                is_log = ((nbatch + 1) % frequent == 0 or stop
                          or (epoch == end_epoch - 1
                              and nbatch == len(loader) - 1))
                if is_log:
                    last, window = mean_metrics(window), []
                speed(epoch, nbatch, last if is_log else None, wait_s)
                if stop:
                    return last
        finally:
            if stager is not None:
                stager.close()
        wall = time.perf_counter() - t_epoch
        log(f"Epoch[{epoch}] {nbatch + 1} steps in {wall:.3f} s, data wait "
            f"{wait_epoch:.3f} s ({100 * wait_epoch / max(wall, 1e-9):.1f}%)")
        if prefix is not None and nbatch == len(loader) - 1:
            path = save_checkpoint(prefix, epoch + 1, state,
                                   steps_per_epoch=len(loader),
                                   config_fp=fingerprint)
            log(f'Epoch[{epoch}] Saved checkpoint to "{path}"')
    return last
