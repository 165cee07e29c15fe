"""The port's multi-device dry run: ``dryrun_multichip``.

Counterpart of ``__graft_entry__.py — dryrun_multichip`` (and its
``_dryrun_state_surgery`` and ``_dryrun_eval``): the flagship model,
ResNet-101, at tiny shapes (64x64 images, the JAX dry run's proposal
numbers) over ``n`` ranks of :func:`parallel.dp.launch`:

1. one data-parallel train step, its loss finite and the replicas equal
   after it (``dp.check_replicas``), then the same step from the same
   state in a world that records ``dcn_size=2`` (for an even ``n``),
   whose parameters must equal the flat world's bit for bit (the port
   reduces over the whole world either way; ``parallel/dp.py``);
2. state surgery: rank 0 saves the stepped state, which a world of one
   restores bit for bit (checksum equal to every rank's) and steps on;
3. one eval batch of ``n + 1`` images (pad rows) through a
   ``Predictor`` split over the ``n`` devices, equal to one device's
   forward of the same padded slices, and its RPN-only and RCNN-only
   forwards.

It raises on any failure.

    python -m mx_rcnn_tpu_torch.parallel.dryrun 2 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import Config, generate_config
from mx_rcnn_tpu_torch.core.train import (Batch, make_train_step,
                                          setup_training, to_device)
from mx_rcnn_tpu_torch.parallel.dp import (World, check_replicas, launch,
                                           local_devices, replicate,
                                           state_checksum)

SIZE = 64


def small_config(device_type: str) -> Config:
    """ResNet-101 at the JAX dry run's numbers (``_small_cfg``), one image
    per rank; fp32 on the CPU, the preset's dtype on a card."""
    over = dict(train__batch_images=1, train__rpn_pre_nms_top_n=256,
                train__rpn_post_nms_top_n=64, train__batch_rois=32,
                train__max_gt_boxes=8, train__rpn_min_size=2,
                test__rpn_pre_nms_top_n=256, test__rpn_post_nms_top_n=64,
                test__proposal_pre_nms_top_n=256,
                test__proposal_post_nms_top_n=64,
                bucket__scale=SIZE, bucket__max_size=SIZE,
                bucket__shapes=((SIZE, SIZE),))
    if device_type == "cpu":
        over["network__compute_dtype"] = "float32"
    return generate_config("resnet101", "PascalVOC", **over)


def dryrun_batch(cfg: Config, n: int) -> Batch:
    """``n`` seeded 64x64 mean-subtracted images, one gt box each."""
    rng = np.random.RandomState(0)
    g = cfg.train.max_gt_boxes
    gt_boxes = np.zeros((n, g, 4), np.float32)
    gt_boxes[:, 0] = (8.0, 8.0, 40.0, 40.0)
    gt_classes = np.zeros((n, g), np.int32)
    gt_classes[:, 0] = 3
    gt_valid = np.zeros((n, g), bool)
    gt_valid[:, 0] = True
    return Batch(rng.randn(n, SIZE, SIZE, 3).astype(np.float32),
                 np.tile(np.float32([[SIZE, SIZE, 1.0]]), (n, 1)),
                 gt_boxes, gt_classes, gt_valid)


def _rows(batch: Batch, world: World) -> Batch:
    per = len(batch.images) // world.size
    return Batch(*(x[world.rank * per:(world.rank + 1) * per]
                   for x in batch))


def _step_rank(world: World, cfg: Config, prefix: str) -> Dict:
    """Steps 1 and 2 on one rank: the flat step, the recorded-dcn step
    from the same state, and rank 0's checkpoint of the stepped state."""
    from mx_rcnn_tpu_torch.utils.checkpoint import save_checkpoint

    state = setup_training(cfg, world.device, seed=0, steps_per_epoch=1000)
    replicate(state.model, state.optimizer, world)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    trace = {k: v.clone() for k, v in state.optimizer.trace.items()}
    batch = to_device(_rows(dryrun_batch(cfg, world.size), world),
                      world.device)
    metrics = make_train_step(cfg, world=world)(state, batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss in the dry run: {metrics}")
    check_replicas(state.model, state.optimizer, world)
    flat = {k: v.clone() for k, v in state.model.state_dict().items()}
    out = dict(loss=loss, checksum=state_checksum(state.model,
                                                  state.optimizer))
    if world.size % 2 == 0:
        state.model.load_state_dict(start)
        for k, v in trace.items():
            state.optimizer.trace[k].copy_(v)
        state.optimizer.count = 0
        hier = dataclasses.replace(world, dcn_size=2)
        m = make_train_step(cfg, world=hier)(state, batch)
        same = all(torch.equal(flat[k], v)
                   for k, v in state.model.state_dict().items())
        if not same or float(m["loss"]) != loss:
            raise RuntimeError("the dcn_size=2 step differs from the flat "
                               "one")
        out["dcn_loss"] = float(m["loss"])
    else:
        state.model.load_state_dict(flat)
    if world.lead:
        save_checkpoint(prefix, 1, state)
    world.barrier()
    return out


def _eval(cfg: Config, devices: Sequence[str], n: int) -> Dict:
    """Step 3: the split forward against the single-device one."""
    from mx_rcnn_tpu_torch.core.tester import Predictor
    from mx_rcnn_tpu_torch.models.faster_rcnn import build_model

    batch = dryrun_batch(cfg, n + 1)
    split = Predictor(build_model(cfg, devices[0], seed=1), cfg,
                      devices=devices)
    single = Predictor(build_model(cfg, devices[0], seed=1), cfg,
                       devices[0])
    # the reference runs each device's padded slice on one device
    per = -(-(n + 1) // n)
    images = np.concatenate([batch.images, np.zeros(
        (per * n - n - 1,) + batch.images.shape[1:], np.float32)])
    im_info = np.concatenate([batch.im_info, np.ones(
        (per * n - n - 1, 3), np.float32)])
    parts = [single.raw(images[i:i + per], im_info[i:i + per])
             for i in range(0, per * n, per)]
    want = [torch.cat([p[j].cpu() for p in parts])[:n + 1]
            for j in range(4)]
    got = split.raw(batch.images, batch.im_info)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise RuntimeError("the split eval forward differs from the "
                           "single-device one")
    rois, scores, valid = split.rpn(batch.images, batch.im_info)
    cls_prob = split.raw_rois(batch.images, batch.im_info, rois.numpy(),
                              valid.numpy())[2]
    if rois.shape[0] != n + 1 or cls_prob.shape[0] != n + 1 or not (
            torch.isfinite(scores).all() and torch.isfinite(cls_prob).all()):
        raise RuntimeError(f"the split RPN-only or RCNN-only forward is "
                           f"wrong: {tuple(rois.shape)}, "
                           f"{tuple(cls_prob.shape)}")
    return dict(images=n + 1, proposals=int(valid.sum()))


def dryrun_multichip(n: int, devices: Optional[Sequence[str]] = None,
                     backend: Optional[str] = None,
                     log=print) -> Dict:
    """Steps 1–3 (module docstring) over ``n`` ranks on ``devices`` (the
    first ``n`` cards by default; a test rig may name one card twice, or
    the CPU) through ``backend`` (NCCL on cards, gloo on the CPU by
    default).  Raises on any failure; returns what it checked."""
    from mx_rcnn_tpu_torch.utils.checkpoint import restore_state

    devices = local_devices("cuda", n, devices)
    cfg = small_config(torch.device(devices[0]).type)
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "surgery")
        ranks = launch(_step_rank, n, devices, backend, args=(cfg, prefix),
                       timeout_s=600)
        log(f"dryrun_multichip({n}): OK — step on {devices} "
            f"({backend or 'default backend'}), loss={ranks[0]['loss']:.4f}"
            + (f"; dcn_size=2 step equal, loss={ranks[0]['dcn_loss']:.4f}"
               if "dcn_loss" in ranks[0] else ""))
        state = setup_training(cfg, devices[0], seed=5, steps_per_epoch=1000)
        restore_state(state, prefix, 1)
    restored = state_checksum(state.model, state.optimizer)
    if not all(torch.equal(restored, r["checksum"]) for r in ranks):
        raise RuntimeError("state surgery: the state restored in a world "
                           "of one differs from the ranks' replicas")
    m = make_train_step(cfg)(state, to_device(dryrun_batch(cfg, n),
                                              torch.device(devices[0])))
    if not np.isfinite(float(m["loss"])):
        raise RuntimeError(f"state surgery: non-finite loss {m}")
    log(f"dryrun_multichip({n}): OK — state surgery: saved by {n} ranks, "
        f"restored bit for bit in a world of one, stepped "
        f"(loss={float(m['loss']):.4f})")
    ev = _eval(cfg, devices, n)
    log(f"dryrun_multichip({n}): OK — eval split over {devices}: "
        f"{ev['images']} images (pad rows), equal to one device; "
        f"RPN-only and RCNN-only forwards")
    return dict(loss=ranks[0]["loss"], surgery_loss=float(m["loss"]), **ev)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--backend", default=None)
    args = p.parse_args(argv)
    dryrun_multichip(args.n, ["cpu"] * args.n if args.device == "cpu"
                     else None, args.backend)


if __name__ == "__main__":
    main()
