"""The training step, in its three modes.

Counterpart of ``mx_rcnn_tpu/core/train.py``.
``mode='e2e'``: backbone → RPN head → anchor targets and the two RPN
losses → proposals (no gradient; NMS kernel K1) → ``proposal_target``
sampling → ROIAlign (K2 forward, K3 backward) → head → the two RCNN
losses → backward → SGD.  The alternate schedule's stages run one half
each: ``mode='rpn'`` the backbone, RPN head and RPN losses of a
:class:`Batch`; ``mode='rcnn'`` the backbone and, from the precomputed
proposals of an :class:`RCNNBatch`, the sampling, ROIAlign, head and
RCNN losses.

Loss layout as in the reference train symbol:
  rpn_cls:  softmax CE, ignore -1, divided by the valid anchors,
  rpn_bbox: smooth_l1(sigma=3) · weights / (rpn_batch_size · N),
  rcnn_cls: softmax CE over the sampled ROIs, divided by the valid ones,
  rcnn_bbox: smooth_l1(sigma=1) · weights / (batch_rois · N),
summed; the six training metrics, ``num_fg`` and ``loss`` come back with
them.

``jax.random`` has no torch counterpart, so the subsampling takes its
uniforms from ``draws(site, image, shape)``: by default the step's
``torch.Generator``, re-seeded at each step from (seed, step) as the JAX
step folds ``state.step`` into its key, so a run resumed from a
checkpoint draws what the unbroken run drew; in a test, the JAX step's
own uniforms.  Sites are
``anchor_fg``/``anchor_bg`` (one uniform per anchor),
``proposal_fg``/``proposal_bg`` (one per pooled candidate) and the
head's ``dropout_sites`` (VGG's ``dropout_fc6``/``dropout_fc7``: one per
element of the image's (batch_rois, 4096) activations).

With ``grad_accum=N > 1`` a step takes N microbatches, runs one forward
and backward per microbatch (each loss scaled by 1/N, so peak memory is
that of one microbatch), averages the metrics and makes one SGD update;
microbatch ``i`` of step ``s`` draws from a generator seeded by (seed,
s, i), as the JAX step folds ``i`` into the step's key.  With
``train.remat_backbone`` the backbone's activations are recomputed in
the backward pass (``torch.utils.checkpoint``): the same gradients for
less memory.

Given a data-parallel :class:`~mx_rcnn_tpu_torch.parallel.dp.World`,
the step runs on this rank's rows, seeds its generator with
``rank_seed`` of the step's (or microbatch's) seed (the JAX DP step
folds the device's mesh position into its key) and,
after the local backward (after the last microbatch's under
``grad_accum``), averages the gradients and the metrics over the world
with one all-reduce before the SGD update, as the JAX step's
``lax.pmean`` does.

Unlike the JAX step, which returns a new state, this one updates the
model's parameters and the optimizer's trace in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.optim import SGD, make_optimizer
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN, build_model
from mx_rcnn_tpu_torch.obs.profiler import scope
from mx_rcnn_tpu_torch.ops.losses import (accuracy_with_ignore,
                                          softmax_cross_entropy_with_ignore,
                                          weighted_smooth_l1)
from mx_rcnn_tpu_torch.ops.proposal import propose_batch
from mx_rcnn_tpu_torch.ops.roi_pool import roi_align_batched
from mx_rcnn_tpu_torch.ops.targets import (anchor_target, proposal_pool_size,
                                           proposal_target)
from mx_rcnn_tpu_torch.parallel.dp import World, all_reduce_mean_, rank_seed

Draws = Callable[[str, int, Tuple[int, ...]], torch.Tensor]
StageHook = Callable[[str], None]

# the stages a ``stage_hook`` is called at, in order; a mode marks only
# the stages it runs
STAGES = ("backbone", "rpn", "proposal", "proposal_target", "roi_align",
          "head", "backward", "optimizer")


class Batch(NamedTuple):
    """Static-shape training batch.

    images (N, H, W, 3) uint8 RGB padded into the bucket (normalised on
    the device) or fp32 mean-subtracted; im_info (N, 3) = (real_h, real_w,
    scale); gt_boxes (N, G, 4) in input coordinates; gt_classes (N, G) class
    ids (0 is background); gt_valid (N, G) bool."""

    images: torch.Tensor
    im_info: torch.Tensor
    gt_boxes: torch.Tensor
    gt_classes: torch.Tensor
    gt_valid: torch.Tensor


class RCNNBatch(NamedTuple):
    """A :class:`Batch` with precomputed proposals (the alternate
    schedule's RCNN stages): rois (N, R, 4) in input coordinates and
    rois_valid (N, R) bool."""

    images: torch.Tensor
    im_info: torch.Tensor
    gt_boxes: torch.Tensor
    gt_classes: torch.Tensor
    gt_valid: torch.Tensor
    rois: torch.Tensor
    rois_valid: torch.Tensor


def to_device(batch, device: torch.device):
    """A :class:`Batch` or :class:`RCNNBatch` of numpy arrays → the same
    of tensors on ``device`` (pinned and non-blocking on CUDA)."""
    out = []
    for x in batch:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            t = t.pin_memory()
        out.append(t.to(device, non_blocking=True))
    return type(batch)(*out)


def generator_draws(generator: torch.Generator) -> Draws:
    """Uniforms in [0, 1) from ``generator``, on its device."""
    return lambda site, image, shape: torch.rand(
        shape, generator=generator, device=generator.device)


def _stacked(draws: Draws, site: str, n: int, shape: Tuple[int, ...],
             device: torch.device) -> torch.Tensor:
    return torch.stack([draws(site, i, shape).to(device, torch.float32)
                        for i in range(n)])


def _rpn_losses(rpn_cls, rpn_box, anchors, batch: Batch, draws: Draws,
                cfg: Config):
    """Anchor targets and the two RPN losses → (cls, bbox, metrics)."""
    tr = cfg.train
    n, a = batch.images.shape[0], anchors.shape[0]
    with torch.no_grad():
        at = anchor_target(
            anchors, batch.gt_boxes, batch.gt_valid, batch.im_info,
            uniforms=tuple(_stacked(draws, f"anchor_{k}", n, (a,),
                                    anchors.device) for k in ("fg", "bg")),
            rpn_batch_size=tr.rpn_batch_size,
            rpn_fg_fraction=tr.rpn_fg_fraction,
            positive_overlap=tr.rpn_positive_overlap,
            negative_overlap=tr.rpn_negative_overlap,
            clobber_positives=tr.rpn_clobber_positives,
            allowed_border=tr.rpn_allowed_border,
            bbox_weights=tr.rpn_bbox_weights)
    rpn_cls32 = rpn_cls.to(torch.float32).reshape(-1, 2)
    labels = at.labels.reshape(-1)
    cls_loss = softmax_cross_entropy_with_ignore(rpn_cls32, labels, -1,
                                                 "valid")
    bbox_loss = weighted_smooth_l1(rpn_box.to(torch.float32), at.bbox_targets,
                                   at.bbox_weights, sigma=3.0,
                                   grad_norm=tr.rpn_batch_size * n)
    metrics = {"rpn_acc": accuracy_with_ignore(rpn_cls32, labels),
               "rpn_logloss": cls_loss, "rpn_l1loss": bbox_loss}
    return cls_loss, bbox_loss, metrics


def _rcnn_losses(model: FasterRCNN, feat, rois, rois_valid, batch: Batch,
                 draws: Draws, cfg: Config, mark: StageHook):
    """ROI sampling, pooled head (in train mode) and the two RCNN losses
    → (cls, bbox, metrics).  ``rois`` come from the step's proposals
    (e2e) or from the batch (rcnn)."""
    tr = cfg.train
    n, r = rois.shape[:2]
    pool = proposal_pool_size(r, batch.gt_boxes.shape[1], tr.batch_rois,
                              tr.gt_append)
    with torch.no_grad():
        pt = proposal_target(
            rois, rois_valid, batch.gt_boxes, batch.gt_classes,
            batch.gt_valid,
            uniforms=tuple(_stacked(draws, f"proposal_{k}", n, (pool,),
                                    rois.device) for k in ("fg", "bg")),
            num_classes=model.num_classes, batch_rois=tr.batch_rois,
            fg_fraction=tr.fg_fraction, fg_thresh=tr.fg_thresh,
            bg_thresh_hi=tr.bg_thresh_hi, bg_thresh_lo=tr.bg_thresh_lo,
            bbox_means=tr.bbox_means, bbox_stds=tr.bbox_stds,
            gt_append=tr.gt_append)
    mark("proposal_target")
    with scope("roi_align"):
        pooled = roi_align_batched(feat, pt.rois, model.pooled_size,
                                   1.0 / model.feat_stride)
    mark("roi_align")
    flat = pooled.reshape((-1,) + pooled.shape[2:])
    b, width = pooled.shape[1], model.head.out_channels
    uniforms = tuple(_stacked(draws, site, n, (b, width), flat.device)
                     .reshape(n * b, width)
                     for site in model.head.dropout_sites)
    with scope("head"):
        cls_logits, bbox_deltas = model.roi_head(flat, uniforms)
    cls_logits = cls_logits.to(torch.float32)
    bbox_deltas = bbox_deltas.to(torch.float32)
    labels = pt.labels.reshape(-1)
    cls_loss = softmax_cross_entropy_with_ignore(cls_logits, labels, -1,
                                                 "valid")
    bbox_loss = weighted_smooth_l1(
        bbox_deltas, pt.bbox_targets.reshape(bbox_deltas.shape),
        pt.bbox_weights.reshape(bbox_deltas.shape), sigma=1.0,
        grad_norm=tr.batch_rois * n)
    metrics = {"rcnn_acc": accuracy_with_ignore(cls_logits, labels),
               "rcnn_logloss": cls_loss, "rcnn_l1loss": bbox_loss,
               "num_fg": pt.fg_mask.sum().to(torch.float32)}
    return cls_loss, bbox_loss, metrics


def _features(model: FasterRCNN, batch, cfg: Config) -> torch.Tensor:
    """The backbone's features of ``batch``, their activations recomputed
    in the backward pass when ``cfg.train.remat_backbone``."""
    if cfg.train.remat_backbone:
        return torch.utils.checkpoint.checkpoint(
            model.features, batch.images, batch.im_info, use_reentrant=False)
    return model.features(batch.images, batch.im_info)


def loss_and_metrics(model: FasterRCNN, batch: Batch, cfg: Config,
                     draws: Draws, stage_hook: Optional[StageHook] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full train-mode forward → (total loss, metrics).  ``stage_hook``,
    when given, is called as each of the first six :data:`STAGES` ends."""
    tr = cfg.train
    mark = stage_hook or (lambda name: None)
    feat = _features(model, batch, cfg)
    mark("backbone")
    rpn_cls, rpn_box = model.rpn_raw(feat)
    _, fh, fw, _ = feat.shape
    anchors = model.anchors_for(fh, fw)
    rpn_cls_loss, rpn_bbox_loss, rpn_metrics = _rpn_losses(
        rpn_cls, rpn_box, anchors, batch, draws, cfg)
    mark("rpn")
    # proposals carry no gradient (the JAX step's stop_gradient)
    with torch.no_grad(), scope("proposal"):
        fg_scores = torch.softmax(rpn_cls.detach().to(torch.float32),
                                  dim=-1)[..., 1]
        rois, _, rois_valid = propose_batch(
            fg_scores, rpn_box.detach().to(torch.float32), anchors,
            batch.im_info.to(torch.float32),
            pre_nms_top_n=tr.rpn_pre_nms_top_n,
            post_nms_top_n=tr.rpn_post_nms_top_n,
            nms_thresh=tr.rpn_nms_thresh, min_size=tr.rpn_min_size)
    mark("proposal")
    rcnn_cls_loss, rcnn_bbox_loss, rcnn_metrics = _rcnn_losses(
        model, feat, rois, rois_valid, batch, draws, cfg, mark)
    total = rpn_cls_loss + rpn_bbox_loss + rcnn_cls_loss + rcnn_bbox_loss
    mark("head")
    return total, {**rpn_metrics, **rcnn_metrics, "loss": total}


def loss_and_metrics_rpn(model: FasterRCNN, batch: Batch, cfg: Config,
                         draws: Draws, stage_hook: Optional[StageHook] = None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """RPN-only loss (alternate stages 1 and 3): backbone → RPN head →
    anchor targets → the two RPN losses."""
    mark = stage_hook or (lambda name: None)
    feat = _features(model, batch, cfg)
    mark("backbone")
    rpn_cls, rpn_box = model.rpn_raw(feat)
    anchors = model.anchors_for(*feat.shape[1:3])
    cls_loss, bbox_loss, metrics = _rpn_losses(rpn_cls, rpn_box, anchors,
                                               batch, draws, cfg)
    mark("rpn")
    total = cls_loss + bbox_loss
    return total, {**metrics, "loss": total}


def loss_and_metrics_rcnn(model: FasterRCNN, batch: RCNNBatch, cfg: Config,
                          draws: Draws, stage_hook: Optional[StageHook] = None
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """RCNN-only loss from the batch's precomputed proposals (alternate
    stages 2 and 4): backbone → sampling → ROIAlign → head → the two RCNN
    losses."""
    mark = stage_hook or (lambda name: None)
    feat = _features(model, batch, cfg)
    mark("backbone")
    cls_loss, bbox_loss, metrics = _rcnn_losses(
        model, feat, batch.rois, batch.rois_valid, batch, draws, cfg, mark)
    total = cls_loss + bbox_loss
    mark("head")
    return total, {**metrics, "loss": total}


LOSS_FNS = {"e2e": loss_and_metrics, "rpn": loss_and_metrics_rpn,
            "rcnn": loss_and_metrics_rcnn}


@dataclass
class TrainState:
    """The model (fp32 master weights), its optimizer, and the generator
    the step draws its uniforms from by default, with the seed that
    generator is re-seeded from at each step."""

    model: FasterRCNN
    optimizer: SGD
    generator: torch.Generator
    seed: int = 0

    @property
    def step(self) -> int:
        return self.optimizer.count


_M64 = 2 ** 64 - 1


def mix64(*words: int) -> int:
    """splitmix64 over ``words``: each word is added into the state and
    the state finalised, so all 64 bits depend on every word (and, for
    fixed earlier words, the last maps one to one).  Torch's CPU
    generator keeps only the low 32 bits of a seed, so a seed must carry
    everything that distinguishes it there."""
    z = 0
    for w in words:
        z = ((z ^ (w & _M64)) + 0x9E3779B97F4A7C15) & _M64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        z ^= z >> 31
    return z


def step_seed(seed: int, step: int) -> int:
    """The generator seed of step ``step`` of a run seeded ``seed``: the
    mix of both, top bit clear."""
    return mix64(seed, step) >> 1


def microbatch_seed(seed: int, step: int, micro: int) -> int:
    """The generator seed of microbatch ``micro`` of step ``step`` when a
    step accumulates several (``grad_accum > 1``): the top bit set, so no
    :func:`step_seed` (below 2**63) is one."""
    return 1 << 63 | mix64(seed, step, micro) >> 1


def init_state(model: FasterRCNN, cfg: Config, steps_per_epoch: int,
               seed: int = 0, **optimizer_kw) -> TrainState:
    """Optimizer and generator for a model built with ``train=True``;
    ``optimizer_kw`` goes to :func:`make_optimizer` (``base_lr``,
    ``lr_step``, ``frozen_prefixes``)."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    return TrainState(model, make_optimizer(cfg, model, steps_per_epoch,
                                            **optimizer_kw), generator, seed)


def setup_training(cfg: Config, device="cuda", seed: int = 0,
                   steps_per_epoch: int = 1, **optimizer_kw) -> TrainState:
    """Build the model from ``seed`` with fp32 master weights on
    ``device`` (CUDA by default; without a card this raises unless
    ``device='cpu'``) and its optimizer."""
    model = build_model(cfg, device, seed, train=True)
    return init_state(model, cfg, steps_per_epoch, seed, **optimizer_kw)


def make_train_step(cfg: Config, mode: str = "e2e", grad_accum: int = 1,
                    world: Optional[World] = None):
    """The train step of ``mode`` (``'e2e'``, ``'rpn'`` or ``'rcnn'``, the
    last on :class:`RCNNBatch` es), ``step(state, batch, draws=None,
    stage_hook=None) → metrics``: forward, backward and one SGD update,
    in place.  With ``grad_accum`` N > 1, ``batch`` is a sequence of N
    microbatches and ``draws``, when given, one draws function per
    microbatch; the gradient is the mean of the microbatches' gradients
    and the metrics their means.  ``stage_hook`` is called as each of
    the :data:`STAGES` the mode runs ends (the forward and backward
    stages once per microbatch).  With a ``world``, ``batch`` holds this
    rank's rows, the default draws are seeded through ``rank_seed``,
    and one all-reduce before the update makes the gradients and the
    returned metrics the world's means; ``world=None`` is the
    single-process step."""
    if mode not in LOSS_FNS:
        raise ValueError(f"unknown mode {mode!r}; have {sorted(LOSS_FNS)}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    loss_fn = LOSS_FNS[mode]
    rank = 0 if world is None else world.rank
    ranked = lambda seed: rank_seed(seed, rank)  # noqa: E731

    def step(state: TrainState, batch, draws=None,
             stage_hook: Optional[StageHook] = None
             ) -> Dict[str, torch.Tensor]:
        mark = stage_hook or (lambda name: None)
        state.optimizer.zero_grad()
        if grad_accum == 1:
            if draws is None:
                state.generator.manual_seed(
                    ranked(step_seed(state.seed, state.step)))
                draws = generator_draws(state.generator)
            with scope("loss"):
                total, metrics = loss_fn(state.model, batch, cfg, draws,
                                         stage_hook)
            with scope("backward"):
                total.backward()
            mark("backward")
        else:
            metrics = _accumulate(state, batch, draws, stage_hook)
        if world is not None:
            metrics = all_reduce_mean_(state.optimizer.params, metrics,
                                       world)
        with scope("optimizer"):
            state.optimizer.step()
        mark("optimizer")
        return {k: v.detach() for k, v in metrics.items()}

    def _accumulate(state: TrainState, batches: Sequence, draws,
                    stage_hook: Optional[StageHook]
                    ) -> Dict[str, torch.Tensor]:
        """Forward and backward of each microbatch, the loss scaled by
        1/N so that the summed gradients are their mean; the metrics'
        means."""
        mark = stage_hook or (lambda name: None)
        if len(batches) != grad_accum or (draws is not None
                                          and len(draws) != grad_accum):
            raise ValueError(f"a step takes {grad_accum} microbatches (and "
                             f"as many draws)")
        window = []
        for i, mb in enumerate(batches):
            if draws is None:
                state.generator.manual_seed(
                    ranked(microbatch_seed(state.seed, state.step, i)))
                mb_draws = generator_draws(state.generator)
            else:
                mb_draws = draws[i]
            with scope("loss"):
                total, metrics = loss_fn(state.model, mb, cfg, mb_draws,
                                         stage_hook)
            with scope("backward"):
                (total / grad_accum).backward()
            mark("backward")
            window.append({k: v.detach() for k, v in metrics.items()})
        return {k: torch.stack([m[k] for m in window]).mean()
                for k in window[0]}

    return step
