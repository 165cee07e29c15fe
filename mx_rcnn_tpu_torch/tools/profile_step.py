"""Train-step time breakdown: where do the milliseconds go?

Counterpart of ``mx_rcnn_tpu/tools/profile_step.py``: the train step is
taken apart into its stages (the backbone forward, the backbone forward
and backward on a dummy loss, the proposal sweep (K1), the anchor and
proposal targets, ROIAlign (K2), the head forward and backward, the full
loss forward, the full loss forward and backward (K3 inside), the
optimizer update), each run ``--iters`` times in a chain after a warm-up
and timed, then the whole step; the stages' sum is held against it.
The chain carries an unfoldable dependency: iteration i+1's input is
offset by 1e-30 times a scalar read from iteration i's output, so every
iteration runs, in order.  On a card the chain is timed by CUDA events,
on the CPU by the host clock (``--device cpu``, structure only).  Each
stage line gives its kernel launches a chained iteration (K1 1, K2 1 and
K3 1 a full step, K1 once per image under ``--nms_mode per_image``).

Per-stage gauges go to the obs registry (``profile/stage_ms/<stage>``,
``profile/self_check_ratio``).  ``--check`` asks for finite stages, zero
kernel builds during every timed pass (``kernels.load_events``, the JAX
tool's zero relowerings), a chain self-check (the stages' sum within
[0.1, 10] of the full step) and the gauges, and exits 1 otherwise.
``--trace_dir`` records three full steps with ``torch.profiler``;
``--trace_summary`` rolls the trace up by stage and op class
(``obs/profiler.py``, the JAX tool's ``utils/xplane.py``).

Levers: ``--quant`` also times the test-mode forward fp against
quantized (``--quant_dtype``, ``--quant_mode``: K4-K6 on a card),
calibrated on the batch; ``--nms_mode per_image`` runs the proposal
stage one image at a time (``ops/proposal.py — propose``; the loss
stages keep the batched sweep); ``--pad_stem N`` zero-pads the stem's
input channels (``network.stem_channel_pad``); ``--prenms`` sets
``train.rpn_pre_nms_top_n``.  ``--roi_backend`` other than ``auto``,
``--roi_chunk`` and ``--nms_backend`` other than ``auto`` name XLA-only
levers the port does not have, and raise.

Stated differences: the optimizer stage applies its update (the port's
SGD updates in place, so the full step starts from there), and the full
step's label keeps the JAX tool's "(donated)" though nothing is donated.

    python -m mx_rcnn_tpu_torch.tools.profile_step --network resnet101 \\
        --batch_images 2 --shape 608x1024 --prenms 6000 --iters 8 --check
    python -m mx_rcnn_tpu_torch.tools.profile_step --device cpu \\
        --network tiny --dataset synthetic --shape 128x160 \\
        --batch_images 1 --iters 2 --check
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.config import NETWORKS
from mx_rcnn_tpu_torch.core.train import Batch

EPS = 1e-30
FULL_STEP = "FULL train step (donated)"
SUM = "sum of pieces (approx)"
# the stages summed against the full step (the JAX tool's six)
PIECES = ("backbone fwd+bwd (dummy loss)", "proposal (decode+topk+NMS)",
          "anchor_target", "proposal_target", "roi_align",
          "roi head fwd+bwd (dummy loss)")
_SHORT = {"nms_sweep": "K1", "roi_align_fwd": "K2", "roi_align_bwd": "K3",
          "quantize_act": "K4", "qconv_s8": "K5", "qconv_e4m3": "K6"}
# the JAX tool's backend switches: every value but 'auto' is an XLA one
_AUTO_ONLY = ("roi_backend", "nms_backend")


def make_batch(cfg, batch_images: int, h: int, w: int, seed: int = 0,
               raw: bool = False, device="cuda") -> Batch:
    """A synthetic training batch on ``device`` (CUDA unless the caller
    asks for the CPU): the JAX tool's arrays from the same seed, 8 gt
    boxes an image; ``raw=True`` gives uint8 images (normalised on the
    device) in place of fp32 ones."""
    from mx_rcnn_tpu_torch.core.train import to_device
    from mx_rcnn_tpu_torch.utils.device import resolve_device

    rng = np.random.RandomState(seed)
    g = cfg.train.max_gt_boxes
    n_gt = 8
    gt_boxes = np.zeros((batch_images, g, 4), np.float32)
    gt_classes = np.zeros((batch_images, g), np.int32)
    gt_valid = np.zeros((batch_images, g), bool)
    for i in range(batch_images):
        xy = rng.uniform(0, [w * 0.8, h * 0.8], (n_gt, 2))
        wh = rng.uniform(0.05, 0.4, (n_gt, 2)) * [w, h]
        gt_boxes[i, :n_gt, :2] = xy
        gt_boxes[i, :n_gt, 2:] = np.minimum(xy + wh, [w - 1, h - 1])
        gt_classes[i, :n_gt] = rng.randint(1, cfg.dataset.num_classes, n_gt)
        gt_valid[i, :n_gt] = True
    if raw:
        images = rng.randint(0, 256, (batch_images, h, w, 3)).astype(
            np.uint8)
    else:
        images = rng.randn(batch_images, h, w, 3).astype(np.float32)
    im_info = np.tile(np.array([[float(h), float(w), 1.0]], np.float32),
                      (batch_images, 1))
    return to_device(Batch(images, im_info, gt_boxes, gt_classes, gt_valid),
                     resolve_device(device))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--network", default="resnet101", choices=NETWORKS)
    p.add_argument("--dataset", default="coco")
    p.add_argument("--batch_images", type=int, default=2)
    p.add_argument("--shape", default="608x1024")
    p.add_argument("--iters", type=int, default=8,
                   help="chained iterations a timed pass")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--trace_dir", default=None,
                   help="also record three full steps with torch.profiler")
    p.add_argument("--trace_summary", action="store_true",
                   help="roll the trace up by stage and op class "
                        "(obs/profiler.py)")
    p.add_argument("--prenms", type=int, default=None,
                   help="override train.rpn_pre_nms_top_n")
    p.add_argument("--roi_backend", default="auto",
                   help="only 'auto': the JAX tool's 'jnp', 'blocked' and "
                        "'pallas' are XLA backends")
    p.add_argument("--roi_chunk", type=int, default=None,
                   help="the JAX blocked ROIAlign's block size: refused")
    p.add_argument("--nms_mode", default="batched",
                   choices=("batched", "per_image"),
                   help="the proposal stage's sweep: one over the batch, or "
                        "one an image")
    p.add_argument("--nms_backend", default="auto",
                   help="only 'auto': the JAX tool's 'jnp' and 'pallas' "
                        "are XLA backends")
    p.add_argument("--check", action="store_true",
                   help="exit 1 unless every stage is finite, no kernel "
                        "was built in a timed pass, the stages' sum is "
                        "within [0.1, 10] of the full step and the gauges "
                        "are in the registry")
    p.add_argument("--quant", action="store_true",
                   help="also time the test-mode forward, fp against "
                        "quantized")
    p.add_argument("--quant_dtype", default="int8", choices=("int8", "fp8"))
    p.add_argument("--quant_mode", default="native",
                   choices=("native", "sim"))
    p.add_argument("--pad_stem", type=int, default=0,
                   help="zero-pad the stem's input channels 3 -> N "
                        "(network.stem_channel_pad)")
    args = p.parse_args(argv)
    for name in _AUTO_ONLY:
        if getattr(args, name) != "auto":
            raise SystemExit(
                f"--{name} {getattr(args, name)} names an XLA backend of "
                f"the JAX tool; the port runs its hand kernels on a card "
                f"(K1, K2/K3) and their plain versions on the CPU, so only "
                f"--{name} auto exists here")
    if args.roi_chunk is not None:
        raise SystemExit("--roi_chunk sizes the JAX package's blocked "
                         "ROIAlign (roi_align_blocked), an XLA-only lever "
                         "the port does not have")
    return args


class _Timer:
    """Chained timing of one stage: CUDA events on a card, the host clock
    on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device

    def __call__(self, fn: Callable[[], None]) -> float:
        """Seconds ``fn`` took, device work included."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0


def _carry(x) -> torch.Tensor:
    """The chain's scalar: the first element of the first tensor in
    ``x``, as fp32."""
    while isinstance(x, (tuple, list)):
        x = next(t for t in x if t is not None)
    return x.reshape(-1)[0].detach().to(torch.float32)


def _grads_carry(loss: torch.Tensor, params) -> torch.Tensor:
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return _carry([g for g in grads if g is not None])


def main(argv=None) -> Dict:
    """Runs the profile; returns ``{"stage_ms", "launches", "builds",
    "self_check_ratio", "device"}`` (launches per chained iteration by
    kernel name, kernel builds during each timed pass)."""
    args = parse_args(argv)
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.train import (loss_and_metrics,
                                              make_train_step,
                                              setup_training)
    from mx_rcnn_tpu_torch.obs.metrics import registry
    from mx_rcnn_tpu_torch.ops.proposal import propose, propose_batch
    from mx_rcnn_tpu_torch.ops.roi_pool import roi_align_batched
    from mx_rcnn_tpu_torch.ops.targets import anchor_target, proposal_target
    from mx_rcnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    h, w = (int(v) for v in args.shape.split("x"))
    n = args.batch_images
    N = args.iters
    over = dict(train__batch_images=n)
    if args.prenms is not None:
        over["train__rpn_pre_nms_top_n"] = args.prenms
    if args.pad_stem:
        over["network__stem_channel_pad"] = args.pad_stem
    cfg = generate_config(args.network, args.dataset, **over)
    tr = cfg.train
    if dev.type == "cuda":
        kernels.build_all()
    state = setup_training(cfg, dev, 0, steps_per_epoch=10_000)
    model = state.model
    params = [p for _, p in state.optimizer.params]
    batch = make_batch(cfg, n, h, w, device=dev)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {dev} ({name}); chain N={N}", file=sys.stderr)
    timer = _Timer(dev)
    stage_ms: Dict[str, float] = {}
    launches: Dict[str, Dict[str, float]] = {}
    builds: Dict[str, int] = {}

    def record_stage(label: str, per_s: float, per_launch=None,
                     n_builds: int = 0, note: str = "") -> None:
        ms = per_s * 1e3
        slug = "".join(ch if ch.isalnum() else "_" for ch in label.lower())
        slug = "_".join(filter(None, slug.split("_")))
        stage_ms[label] = ms
        builds[label] = n_builds
        registry().set_gauge(f"profile/stage_ms/{slug}", round(ms, 4))
        shown = ""
        if per_launch is not None:
            launches[label] = per_launch
            shown = " ".join(f"{_SHORT[k]} {v:g}"
                             for k, v in per_launch.items() if v)
            shown = f"  launches/iter: {shown or 'none'}"
        print(f"{label:<34s} {ms:9.3f} ms  {note}{shown}", flush=True)

    def timed_loop(stage: Callable[[torch.Tensor], torch.Tensor],
                   label: str, note: str = "") -> None:
        """``stage``: carry → carry, chained N times after one warm-up
        run, recorded in the stage table."""
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        _carry(stage(zero)).item()  # warm-up (and kernel loads)
        carry = [zero]

        def chain():
            c = zero
            for _ in range(N):
                c = stage(c)
            carry[0] = c

        b0 = kernels.load_events()["builds"]
        l0 = kernels.launch_counts()
        per = timer(chain) / N
        l1 = kernels.launch_counts()
        per_launch = {k: (l1[k] - l0[k]) / N for k in l1}
        if not math.isfinite(float(carry[0].item())):
            per = float("nan")  # a stage computing garbage fails --check
        record_stage(label, per, per_launch,
                     kernels.load_events()["builds"] - b0, note)

    # --- stages --------------------------------------------------------
    def feat_of(images):
        return model.features(images, batch.im_info)

    with torch.no_grad():
        timed_loop(lambda c: _carry(feat_of(batch.images + c * EPS)),
                   "backbone fwd")

    def feat_bwd(c):
        y = feat_of(batch.images + c * EPS)
        return _grads_carry((y.to(torch.float32) ** 2).mean(), params)

    timed_loop(feat_bwd, "backbone fwd+bwd (dummy loss)")

    with torch.no_grad():
        feat = feat_of(batch.images)
        _, fh, fw, _ = feat.shape
        anchors = model.anchors_for(fh, fw)
        rpn_cls, rpn_box = model.rpn_raw(feat)
        fg = torch.softmax(rpn_cls.to(torch.float32), dim=-1)[..., 1]
        box32 = rpn_box.to(torch.float32)
        info32 = batch.im_info.to(torch.float32)
    prop_kw = dict(pre_nms_top_n=tr.rpn_pre_nms_top_n,
                   post_nms_top_n=tr.rpn_post_nms_top_n,
                   nms_thresh=tr.rpn_nms_thresh, min_size=tr.rpn_min_size)

    def prop_fn(scores):
        if args.nms_mode == "batched":
            return propose_batch(scores, box32, anchors, info32, **prop_kw)
        outs = [propose(scores[i], box32[i], anchors, info32[i], **prop_kw)
                for i in range(n)]
        return tuple(torch.stack(t) for t in zip(*outs))

    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        timed_loop(
            lambda c: _carry(prop_fn(fg + c * EPS)),
            "proposal (decode+topk+NMS)",
            f"pre={tr.rpn_pre_nms_top_n} post={tr.rpn_post_nms_top_n} "
            f"nms={args.nms_mode}/{args.nms_backend}")
        rois, _, rois_valid = prop_fn(fg)
        at_kw = dict(rpn_batch_size=tr.rpn_batch_size,
                     rpn_fg_fraction=tr.rpn_fg_fraction,
                     positive_overlap=tr.rpn_positive_overlap,
                     negative_overlap=tr.rpn_negative_overlap,
                     clobber_positives=tr.rpn_clobber_positives,
                     allowed_border=tr.rpn_allowed_border,
                     bbox_weights=tr.rpn_bbox_weights)
        timed_loop(
            lambda c: _carry(anchor_target(
                anchors, batch.gt_boxes + c * EPS, batch.gt_valid,
                batch.im_info, generator=gen, **at_kw).bbox_targets),
            "anchor_target", f"anchors={anchors.shape[0]}")
        pt_kw = dict(num_classes=model.num_classes, batch_rois=tr.batch_rois,
                     fg_fraction=tr.fg_fraction, fg_thresh=tr.fg_thresh,
                     bg_thresh_hi=tr.bg_thresh_hi,
                     bg_thresh_lo=tr.bg_thresh_lo,
                     bbox_means=tr.bbox_means, bbox_stds=tr.bbox_stds,
                     gt_append=tr.gt_append)

        def pt_of(r):
            return proposal_target(r, rois_valid, batch.gt_boxes,
                                   batch.gt_classes, batch.gt_valid,
                                   generator=gen, **pt_kw)

        timed_loop(lambda c: _carry(pt_of(rois + c * EPS).rois),
                          "proposal_target")
        pt_rois = pt_of(rois).rois
        ra = (lambda f: roi_align_batched(f, pt_rois, model.pooled_size,
                                          1.0 / model.feat_stride))
        timed_loop(lambda c: _carry(ra(feat + (c * EPS).to(
            feat.dtype))), "roi_align",
            f"rois={pt_rois.shape[0] * pt_rois.shape[1]}")
        pooled = ra(feat)
    flat = pooled.reshape((-1,) + pooled.shape[2:])
    b, width = pooled.shape[1], model.head.out_channels
    head_u = tuple(torch.rand((n * b, width), generator=gen, device=dev)
                   for _ in model.head.dropout_sites)

    def head_stage(c):
        cls, box = model.roi_head(flat + (c * EPS).to(flat.dtype), head_u)
        loss = (cls.to(torch.float32) ** 2).mean() + \
            (box.to(torch.float32) ** 2).mean()
        return _grads_carry(loss, params)

    timed_loop(head_stage, "roi head fwd+bwd (dummy loss)",
                        f"rois={flat.shape[0]}")

    draws = (lambda site, image, shape: torch.rand(
        shape, generator=gen, device=dev))

    def shifted(c):
        return Batch(batch.images + c * EPS, *batch[1:])

    with torch.no_grad():
        timed_loop(lambda c: loss_and_metrics(model, shifted(c), cfg,
                                              draws)[0].to(torch.float32),
                   "full loss fwd (no bwd)")
    timed_loop(lambda c: _grads_carry(
        loss_and_metrics(model, shifted(c), cfg, draws)[0], params),
        "full loss fwd+bwd (no update)")
    loss, _ = loss_and_metrics(model, batch, cfg, draws)
    grads = torch.autograd.grad(loss, params, allow_unused=True)

    def opt_stage(c):
        for p, g in zip(params, grads):
            p.grad = None if g is None else g + (c * EPS).to(g.dtype)
        state.optimizer.step()
        return _carry(params)

    timed_loop(opt_stage, "optimizer update")
    state.optimizer.zero_grad()

    # --- the full step, chained through the state -------------------------
    step = make_train_step(cfg)
    step(state, batch)["loss"].item()  # warm-up
    b0 = kernels.load_events()["builds"]
    l0 = kernels.launch_counts()
    last = {}

    def full():
        for _ in range(N):
            last["m"] = step(state, batch)

    t_full = timer(full) / N
    l1 = kernels.launch_counts()
    record_stage(FULL_STEP, t_full, {k: (l1[k] - l0[k]) / N for k in l1},
                 kernels.load_events()["builds"] - b0,
                 f"imgs/s={n / t_full:.1f}")
    if not math.isfinite(float(last["m"]["loss"])):
        stage_ms[FULL_STEP] = float("nan")

    acct = sum(stage_ms[label] for label in PIECES) / 1e3
    record_stage(SUM, acct)
    ratio = acct / t_full if t_full > 0 else -1.0
    registry().set_gauge("profile/self_check_ratio", round(ratio, 4))

    if args.quant:
        _quant_arms(args, cfg, state, batch, timed_loop)
    out = {"stage_ms": stage_ms, "launches": launches, "builds": builds,
           "self_check_ratio": ratio, "device": name}
    if args.check:
        _run_check(stage_ms, builds, acct, t_full)
    if args.trace_dir:
        _trace(step, state, batch, dev, args.trace_dir)
        if args.trace_summary:
            out["trace"] = summarize_trace(args.trace_dir)
    return out


def _quant_arms(args, cfg, state, batch, timed_loop) -> None:
    """The test-mode forward, fp against quantized, chained like the
    stages; the quantized model is calibrated on the batch."""
    from mx_rcnn_tpu_torch.core.tester import quant_predictor
    from mx_rcnn_tpu_torch.models.faster_rcnn import build_model

    dev = batch.images.device
    fp32 = {k: v.detach().to("cpu", torch.float32)
            for k, v in state.model.state_dict().items()}
    fp_model = build_model(cfg, dev, seed=None)
    fp_model.load_state_dict(fp32)
    images, info = batch.images, batch.im_info
    with torch.no_grad():
        timed_loop(lambda c: _carry(fp_model(images + c * EPS, info)[2]),
                   "inference fwd (fp)",
                   f"batch={args.batch_images} "
                   f"post={fp_model.test_post_nms_top_n}")
        qcfg = cfg.replace_in("quant", enabled=True, dtype=args.quant_dtype,
                              mode=args.quant_mode)
        qmodel = quant_predictor(
            qcfg, fp32, dev,
            batches=[(images.cpu().numpy(), info.cpu().numpy())]).model
        timed_loop(lambda c: _carry(qmodel(images + c * EPS, info)[2]),
                   f"inference fwd ({args.quant_dtype}/{args.quant_mode})",
                   f"batch={args.batch_images}")


def _run_check(stage_ms: Dict[str, float], builds: Dict[str, int],
               acct: float, t_full: float) -> None:
    """``--check``: every stage finite, no kernel built in a timed pass,
    the stages' sum within [0.1, 10] of the full step (structural
    breakage, not noise), the gauges in the registry; raises
    SystemExit(1) on a violation."""
    from mx_rcnn_tpu_torch.obs.metrics import registry

    failures = []
    for label, ms in stage_ms.items():
        if not math.isfinite(ms):
            failures.append(f"stage {label!r} not finite: {ms}")
    for label, n in builds.items():
        if n:
            failures.append(f"stage {label!r} built {n} kernel "
                            f"librar{'y' if n == 1 else 'ies'} on its "
                            f"timed pass")
    if not t_full > 0:
        failures.append(f"full step non-positive: {t_full * 1e3:.3f} ms")
    elif not 0.1 <= acct / t_full <= 10.0:
        failures.append(
            f"chain self-check failed: sum of stages {acct * 1e3:.2f} ms "
            f"vs full step {t_full * 1e3:.2f} ms (ratio "
            f"{acct / t_full:.2f} outside [0.1, 10])")
    gauges = registry().snapshot().get("gauges", {})
    missing = [k for k in ("profile/stage_ms/full_train_step_donated",
                           "profile/self_check_ratio") if k not in gauges]
    if missing:
        failures.append(f"obs registry gauges missing: {missing}")
    if failures:
        for f in failures:
            print(f"CHECK FAIL: {f}", file=sys.stderr)
        raise SystemExit(1)
    print(f"CHECK OK: {len(stage_ms)} stages, zero timed-pass kernel "
          f"builds, self-check ratio {acct / t_full:.2f}", flush=True)


def _trace(step, state, batch, dev: torch.device, trace_dir: str) -> None:
    """Three full steps under ``torch.profiler``, its chrome trace written
    under ``trace_dir``."""
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(3):
            m = step(state, batch)
        float(m["loss"])
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "profile_step.pt.trace.json")
    prof.export_chrome_trace(path)
    print(f"trace written to {path}", file=sys.stderr)


def summarize_trace(trace_dir: str, top: int = 15) -> Optional[Dict]:
    """Print the newest trace's device time (the host's ops on the CPU)
    by stage (``obs/profiler.py — scope``) and by op class, each hand
    kernel its own class; returns the rollup."""
    from mx_rcnn_tpu_torch.obs.profiler import rollup

    roll = rollup(trace_dir)
    if not roll:
        print("no trace found under trace dir", file=sys.stderr)
        return None
    for title, key in (("stage", "by_scope"), ("op class", "by_op_class")):
        groups = roll.get(key) or {}
        total = sum(groups.values())
        if not total:
            continue
        print(f"-- {roll['device']} by {title} (total {total:.2f} ms over "
              f"the traced steps)")
        for g, ms in list(groups.items())[:top]:
            print(f"   {g:<42s} {ms:9.3f} ms  {100 * ms / total:5.1f}%")
    return roll


if __name__ == "__main__":
    main()
