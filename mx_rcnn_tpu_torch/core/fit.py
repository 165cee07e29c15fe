"""The training loop: N steps of the train step with a Speedometer log.

Counterpart of ``mx_rcnn_tpu/core/fit.py — fit`` without checkpoints,
data parallelism, staging or observability: batches come from the loader
(epoch after epoch), move to the device, go through the step, and every
``frequent`` steps one line reports samples/s and the window's mean
metrics.  Metrics stay on the device until a log line reads them.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.train import TrainState, to_device


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


def fit(state: TrainState, cfg: Config, step_fn, loader, num_steps: int,
        frequent: Optional[int] = None,
        log: Callable[[str], None] = print) -> Dict[str, float]:
    """Run ``num_steps`` steps over as many epochs of ``loader`` as that
    takes; returns the last log window's mean metrics."""
    if len(loader) == 0:
        raise ValueError("the loader yields no full batch")
    frequent = cfg.default.frequent if frequent is None else frequent
    device = next(state.model.parameters()).device
    speed = Speedometer(loader.batch_images, log)
    window: List[Dict[str, torch.Tensor]] = []
    last: Dict[str, float] = {}
    step, epoch = 0, 0
    while step < num_steps:
        for nbatch, batch in enumerate(loader):
            window.append(step_fn(state, to_device(batch, device)))
            step += 1
            is_log = (nbatch + 1) % frequent == 0 or step == num_steps
            if is_log:
                last, window = mean_metrics(window), []
            speed(epoch, nbatch, last if is_log else None)
            if step == num_steps:
                break
        epoch += 1
    return last
