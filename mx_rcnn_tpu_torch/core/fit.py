"""The training loop: epochs of the train step, a Speedometer log and a
checkpoint after each epoch.

Counterpart of ``mx_rcnn_tpu/core/fit.py — fit`` without interrupt
checkpoints, data parallelism, staging or observability: each epoch's
batches come from the loader in the order its (seed, epoch) plan gives,
move to the device and go through the step; every ``frequent`` steps one
line reports samples/s and the window's mean metrics (which stay on the
device until then); after each whole epoch the state is saved as
``prefix-%04d.ckpt`` with the number of epochs done.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.train import TrainState, to_device
from mx_rcnn_tpu_torch.utils.checkpoint import (config_fingerprint,
                                                save_checkpoint)


class Speedometer:
    """Samples/s and the window's metric means on each log call (ref
    ``rcnn/core/callback.py — Speedometer``).  Call once per batch, with
    the window's metrics on log batches and ``None`` otherwise."""

    def __init__(self, batch_size: int, log: Callable[[str], None] = print):
        self.batch_size = batch_size
        self.log = log
        self._tic = time.perf_counter()
        self._since = 0

    def __call__(self, epoch: int, nbatch: int,
                 metrics: Optional[Dict[str, float]]) -> None:
        self._since += 1
        if not metrics:
            return
        elapsed = time.perf_counter() - self._tic
        speed = self._since * self.batch_size / max(elapsed, 1e-9)
        parts = ", ".join(f"{k}={v:.4f}" for k, v in metrics.items())
        self.log(f"Epoch[{epoch}] Batch [{nbatch}] "
                 f"Speed: {speed:.2f} samples/sec, {parts}")
        self._tic = time.perf_counter()
        self._since = 0


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
        for nbatch, batch in enumerate(loader):
            window.append(step_fn(state, to_device(batch, device)))
            step += 1
            stop = step == max_steps
            is_log = ((nbatch + 1) % frequent == 0 or stop
                      or (epoch == end_epoch - 1
                          and nbatch == len(loader) - 1))
            if is_log:
                last, window = mean_metrics(window), []
            speed(epoch, nbatch, last if is_log else None)
            if stop:
                return last
        if prefix is not None and nbatch == len(loader) - 1:
            path = save_checkpoint(prefix, epoch + 1, state,
                                   steps_per_epoch=len(loader),
                                   config_fp=fingerprint)
            log(f'Epoch[{epoch}] Saved checkpoint to "{path}"')
    return last
