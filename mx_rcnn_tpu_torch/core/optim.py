"""SGD with momentum, weight decay, an elementwise clip and step-decay lr,
with the reference's ``FIXED_PARAMS`` freeze.

Counterpart of ``mx_rcnn_tpu/core/optim.py``, whose optax chain is
``masked(chain(clip, add_decayed_weights, sgd(momentum, lr schedule,
accumulator_dtype)))`` plus ``set_to_zero`` on the frozen leaves.  The
update here is that chain's arithmetic, written as plain tensor code
(``torch.optim.SGD`` keeps its buffer in the parameter dtype and has no
elementwise clip).  Parameters are updated in place.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from mx_rcnn_tpu_torch.config import Config

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_lr_step(lr_step: str) -> Tuple[int, ...]:
    """'7' or '5,7' → (7,) / (5, 7): epochs at which lr drops."""
    return tuple(int(s) for s in str(lr_step).split(",") if s.strip())


def lr_schedule(base_lr: float, lr_step_epochs: Sequence[int],
                steps_per_epoch: int, factor: float = 0.1,
                warmup_step: int = 0, warmup_lr: float = 0.0
                ) -> Callable[[int], float]:
    """count → lr, in fp32 as optax computes it: multiplied by ``factor``
    from each boundary ``epoch * steps_per_epoch`` on (count >= boundary),
    with an optional linear warmup from ``warmup_lr`` over the first
    ``warmup_step`` updates."""
    boundaries = sorted({int(e) * steps_per_epoch: factor
                         for e in lr_step_epochs if int(e) > 0}.items())
    f32 = np.float32

    def schedule(count: int) -> float:
        v = f32(base_lr)
        for threshold, scale in boundaries:
            if count >= threshold:
                v = f32(f32(scale) * v)
        if warmup_step > 0 and count < warmup_step:
            frac = min(f32(count) / f32(warmup_step), f32(1.0))
            v = f32(f32(warmup_lr) + f32(f32(base_lr - warmup_lr) * frac))
        return float(v)

    return schedule


def frozen_mask(names: Iterable[str], fixed_prefixes: Iterable[str]
                ) -> Dict[str, bool]:
    """Parameter name → trainable.

    A parameter is frozen when a component of its dotted name starts with
    one of the prefixes.  The tokens ``'gamma'``/``'beta'`` (MXNet's BN
    affine names) freeze the ``weight``/``bias`` of every module named
    ``bn*``, the port's frozen BNs."""
    prefixes = tuple(fixed_prefixes)
    freeze = {"weight": "gamma" in prefixes, "bias": "beta" in prefixes}
    out = {}
    for name in names:
        parts = name.split(".")
        trainable = not any(p.startswith(prefixes) for p in parts)
        if len(parts) > 1 and parts[-2].startswith("bn") and \
                freeze.get(parts[-1], False):
            trainable = False
        out[name] = trainable
    return out


class SGD:
    """optax's ``clip → add_decayed_weights → trace → scale_by_lr`` on
    the trainable parameters, in place:

    1. ``g = clip(grad, ±clip_gradient)``, then ``g += wd * p``;
    2. ``new_trace = g + momentum * trace`` in fp32, ``momentum`` rounded
       to the trace's dtype (the jitted JAX step computes the product of
       the bf16 scalar and trace without rounding it to bf16: XLA allows
       excess precision inside a fusion); the update uses this fp32 trace,
       and the stored trace is then cast to ``momentum_dtype``;
    3. ``p -= lr(count) * new_trace``, ``count`` being the number of
       updates applied before this one.

    Frozen parameters get no update, no weight decay and no trace."""

    def __init__(self, params: Sequence[Tuple[str, nn.Parameter]],
                 lr: Callable[[int], float], momentum: float = 0.9,
                 wd: float = 0.0005, clip_gradient: float = 5.0,
                 momentum_dtype: torch.dtype = torch.bfloat16):
        self.params: List[Tuple[str, nn.Parameter]] = list(params)
        self.lr = lr
        self.wd = wd
        self.clip_gradient = clip_gradient
        # the scalar rounded to the trace dtype, as a weak-typed jnp scalar is
        self.momentum = float(torch.tensor(momentum, dtype=momentum_dtype))
        self.trace = {name: torch.zeros_like(p, dtype=momentum_dtype)
                      for name, p in self.params}
        self.count = 0

    def zero_grad(self) -> None:
        for _, p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        lr = self.lr(self.count)
        for name, p in self.params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
            g = g + self.wd * p
            new_trace = g + self.trace[name].float() * self.momentum
            self.trace[name].copy_(new_trace)
            p.sub_(new_trace * lr)
        self.count += 1


def make_optimizer(cfg: Config, model: nn.Module, steps_per_epoch: int,
                   base_lr: Optional[float] = None,
                   lr_step: Optional[str] = None,
                   frozen_prefixes: Optional[Sequence[str]] = None) -> SGD:
    """The training SGD for ``model``: the frozen mask sets each
    parameter's ``requires_grad``, so autograd skips the frozen ones."""
    d = cfg.default
    base_lr = d.e2e_lr if base_lr is None else base_lr
    lr_step = d.e2e_lr_step if lr_step is None else lr_step
    if frozen_prefixes is None:
        frozen_prefixes = cfg.network.fixed_params
    named = list(model.named_parameters())
    mask = frozen_mask((n for n, _ in named), frozen_prefixes)
    for name, p in named:
        p.requires_grad_(mask[name])
    sched = lr_schedule(base_lr, parse_lr_step(lr_step), steps_per_epoch,
                        d.lr_factor, d.warmup_step, d.warmup_lr)
    return SGD([(n, p) for n, p in named if mask[n]], sched, d.momentum,
               d.wd, d.clip_gradient, _DTYPES[d.momentum_dtype])
