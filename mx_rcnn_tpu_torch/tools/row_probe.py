"""Does an image's result on the card depend on its row in the batch?

The serving model (ResNet-101, 81 COCO classes, bf16, batch 4, seeded
weights with phase 11's scaled classifier) on four generated images per
bucket.  Three parts, each printed as one JSON line:

* ``ops``: each op of the RPN head run batched, and of the ROI head, fed
  the same inputs with image 0 moved to row 1, 2 or 3: the largest
  difference of its output against row 0's (0.0: bit-equal); the RPN's
  1x1 convolutions on its 3x3 convolution's output as that comes (its
  memory layout under ``layout``) and on an NHWC copy, and the three
  chained.
* ``stages``: the whole test forward (features, RPN logits, rois, class
  probabilities, detection scores) with image 0 at each row, beside
  other neighbours and beside zero pads, against row 0: the model as it
  is (its RPN head one image at a time in eval mode, ``models/rpn.py``),
  and with the RPN head batched, with cuDNN's default and its
  deterministic algorithms.
* ``ms``: the batch's forward in each arm (CUDA events).

On the card unless given ``--device cpu`` (with ``--network tiny``, a
quick check of the script itself).

    python -m mx_rcnn_tpu_torch.tools.row_probe [--out probe.json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.tester import _postprocess_batch, tiled_bbox_stats
from mx_rcnn_tpu_torch.data.image import prepare_image
from mx_rcnn_tpu_torch.ops.roi_pool import roi_align
from mx_rcnn_tpu_torch.tools.loadgen import init_predictor
from mx_rcnn_tpu_torch.utils.device import resolve_device

N = 4                   # serve.batch_size
CLS_SCALE = 0.01        # chip_smoke.SERVE_CLS_SCALE


def diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return 0.0 if torch.equal(a, b) else float(
        (a.float() - b.float()).abs().max())


def at_row(r: int):
    """The batch order that puts image 0 at row ``r``."""
    perm = list(range(N))
    perm[0], perm[r] = perm[r], perm[0]
    return perm


@contextlib.contextmanager
def arm(model, name: str):
    """The model as it is (``as_is``), or with its RPN head run on the
    whole batch (``batched_rpn``), also under cuDNN's deterministic
    algorithms (``batched_rpn_deterministic``)."""
    was = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    if name == "batched_rpn_deterministic":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    if name.startswith("batched_rpn"):
        model.rpn_raw = lambda feat: model.rpn._head(feat.permute(0, 3, 1, 2))
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was
        model.__dict__.pop("rpn_raw", None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the records here")
    p.add_argument("--network", default="resnet101")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        kernels.build_all()
    cfg = generate_config(args.network, "coco", serve__score_thresh=0.01)
    pred = init_predictor(cfg, device=dev)
    m = pred.model
    with torch.no_grad():
        m.cls_score.weight.mul_(CLS_SCALE)
    stds, means = tiled_bbox_stats(cfg, cfg.num_classes, dev)
    rng = np.random.RandomState(19)
    recs = {"card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"), "ops": {}, "layout": {}, "stages": {},
            "ms": {}}

    for hw in ((480, 640), (640, 480)):
        canv = [prepare_image(rng.randint(0, 256, hw + (3,), np.uint8), cfg)
                for _ in range(N)]
        bh, bw = canv[0][2]
        label = f"{bh}x{bw}"

        def batch(rows):
            images = np.zeros((N, bh, bw, 3), np.float32)
            info = np.tile(np.array([bh, bw, 1.0], np.float32), (N, 1))
            for j, i in enumerate(rows):
                if i is not None:
                    images[j], info[j] = canv[i][0], canv[i][1]
            return pred._inputs(images, info)

        def stages(rows):
            im, inf = batch(rows)
            feat = m.features(im, inf)
            rpn_cls, _ = m.rpn_raw(feat)
            out = m(im, inf)
            post = _postprocess_batch(*out, inf, inf[:, 2], stds, means,
                                      nms_thresh=cfg.test.nms,
                                      score_thresh=cfg.serve.score_thresh)
            return {"features": feat, "rpn_logits": rpn_cls, "rois": out[0],
                    "cls_prob": out[2], "det_scores": post[1]}

        with torch.inference_mode():
            # each op alone, on the same inputs in another order
            im, inf = batch(range(N))
            feat = m.features(im, inf)
            rpn = m.rpn
            mid = F.relu(rpn.rpn_conv_3x3(feat.permute(0, 3, 1, 2)))
            recs["layout"][label] = {
                "rpn_conv_3x3 out strides": list(mid.stride()),
                "channels_last": mid.is_contiguous(
                    memory_format=torch.channels_last)}
            nhwc = mid.permute(0, 2, 3, 1).contiguous()
            rois = m(im, inf)[0]
            pooled = roi_align(feat, rois, m.pooled_size, 1.0 / m.feat_stride)
            r = pooled.shape[1]
            hidden = m.head(pooled.reshape((N * r,) + pooled.shape[2:]))
            hidden = hidden.reshape(N, r, -1)
            ops = {
                "rpn_conv_3x3": (feat, lambda t: rpn.rpn_conv_3x3(
                    t.permute(0, 3, 1, 2))),
                "rpn_cls_score as it comes": (mid, rpn.rpn_cls_score),
                "rpn_bbox_pred as it comes": (mid, rpn.rpn_bbox_pred),
                "rpn_cls_score on NHWC": (nhwc, lambda t: rpn.rpn_cls_score(
                    t.permute(0, 3, 1, 2))),
                "rpn_bbox_pred on NHWC": (nhwc, lambda t: rpn.rpn_bbox_pred(
                    t.permute(0, 3, 1, 2))),
                "rpn_conv_3x3, relu, rpn_cls_score": (
                    feat, lambda t: rpn.rpn_cls_score(F.relu(
                        rpn.rpn_conv_3x3(t.permute(0, 3, 1, 2))))),
                "head": (pooled, lambda t: m.head(
                    t.reshape((N * r,) + t.shape[2:])).reshape(N, r, -1)),
                "cls_score": (hidden, lambda t: m.cls_score(
                    t.reshape(N * r, -1)).reshape(N, r, -1)),
                "bbox_pred": (hidden, lambda t: m.bbox_pred(
                    t.reshape(N * r, -1)).reshape(N, r, -1)),
            }
            for name, (x, fn) in ops.items():
                ref = fn(x)[0]
                recs["ops"][f"{label} {name}"] = {
                    f"row {k}": diff(fn(x[at_row(k)])[k], ref)
                    for k in range(1, N)}

            # the whole forward in each arm
            for a in ("as_is", "batched_rpn", "batched_rpn_deterministic"):
                with arm(m, a):
                    ref = {k: v[0] for k, v in stages(range(N)).items()}
                    cases = {"row 0, other neighbours": ([0, 3, 2, 1], 0),
                             "row 0, zero pads": ([0, None, None, None], 0)}
                    cases.update({f"row {k}": (at_row(k), k)
                                  for k in range(1, N)})
                    res = {}
                    for case, (rows, j) in cases.items():
                        got = stages(rows)
                        res[case] = {k: diff(got[k][j], ref[k]) for k in ref}
                    recs["stages"][f"{label} {a}"] = res
                    # its time: 3 warm-up batches, then 10 timed
                    im, inf = batch(range(N))
                    for _ in range(3):
                        m(im, inf)
                    if dev.type == "cuda":
                        t0 = torch.cuda.Event(enable_timing=True)
                        t1 = torch.cuda.Event(enable_timing=True)
                        t0.record()
                        for _ in range(10):
                            m(im, inf)
                        t1.record()
                        torch.cuda.synchronize()
                        recs["ms"][f"{label} {a}"] = t0.elapsed_time(t1) / 10
        for part in ("ops", "layout", "stages", "ms"):
            print(json.dumps({part: {k: v for k, v in recs[part].items()
                                     if k.startswith(label)}}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
