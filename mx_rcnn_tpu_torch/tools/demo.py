"""Detection demo: images in, per-image detections printed or drawn.

Counterpart of ``mx_rcnn_tpu/tools/demo.py``: resize → bucket → test
forward → decode + per-class NMS above ``--vis_thresh``.  With
``--prefix``, ``--epoch`` and ``--image`` it runs the JAX tool's path:
the checkpoint's weights (``utils/checkpoint.py``, the JAX layout), one
image, its labelled boxes drawn with PIL into ``--out`` (default
``<image>_det.png``).  Without ``--prefix`` the weights are random, made
from ``--seed``, and each image's detections are printed, ``--batch``
images a forward.

    python -m mx_rcnn_tpu_torch.tools.demo --prefix model/e2e --epoch 10 \\
        --image street.jpg --out street_det.png                  # card
    python -m mx_rcnn_tpu_torch.tools.demo --synthetic 4
    python -m mx_rcnn_tpu_torch.tools.demo --device cpu --network tiny \\
        --synthetic 2
    python -m mx_rcnn_tpu_torch.tools.demo a.jpg b.jpg --batch 2
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import (NETWORKS, generate_config,
                                      parse_set_overrides)
from mx_rcnn_tpu_torch.core.tester import (Predictor, _postprocess_batch,
                                           detections_from_keep,
                                           tiled_bbox_stats)
from mx_rcnn_tpu_torch.data.image import (RESIZE_BACKEND, imread_rgb,
                                          prepare_image)
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.utils.checkpoint import load_model


def synthetic_images(n: int, seed: int, size: Tuple[int, int] = (375, 500)
                     ) -> List[np.ndarray]:
    """``n`` seeded RGB uint8 images of VOC-like size: noise plus a few
    filled rectangles."""
    rng = np.random.RandomState(seed)
    h, w = size
    out = []
    for _ in range(n):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for _ in range(4):
            y0, x0 = rng.randint(0, h - 40), rng.randint(0, w - 40)
            y1, x1 = y0 + rng.randint(30, h - y0), x0 + rng.randint(30, w - x0)
            img[y0:y1, x0:x1] = rng.randint(0, 256, 3)
        out.append(img)
    return out


def read_image(path: str) -> np.ndarray:
    """An image file as contiguous RGB uint8 (H, W, 3)."""
    return np.ascontiguousarray(imread_rgb(path))


def batches(prepared: Sequence, batch: int) -> List[List[int]]:
    """Image indices grouped into batches of at most ``batch`` that share
    a bucket, in input order."""
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, (_, _, bucket) in enumerate(prepared):
        groups.setdefault(bucket, []).append(i)
    out = []
    for idx in groups.values():
        out.extend(idx[k:k + batch] for k in range(0, len(idx), batch))
    return sorted(out)


def postprocess(predictor: Predictor, outputs, im_info: torch.Tensor,
                score_thresh: float):
    """Device postprocess of one forward's outputs: (boxes, scores, keep)."""
    rois, roi_valid, cls_prob, deltas = outputs
    stds, means = tiled_bbox_stats(predictor.cfg, cls_prob.shape[-1],
                                   cls_prob.device)
    with torch.inference_mode():
        return _postprocess_batch(
            rois, roi_valid, cls_prob, deltas, im_info, im_info[:, 2],
            stds, means, nms_thresh=predictor.cfg.test.nms,
            score_thresh=score_thresh)


def detect(predictor: Predictor, images: Sequence[np.ndarray], batch: int,
           score_thresh: float) -> List[Dict[int, np.ndarray]]:
    """Detections for each image, ``{class_id: (k, 5)}`` in raw-image
    coordinates, running ``batch`` images per forward."""
    prepared = [prepare_image(img, predictor.cfg) for img in images]
    dets: List[Dict[int, np.ndarray]] = [{} for _ in images]
    for idx in batches(prepared, batch):
        canvases = np.stack([prepared[i][0] for i in idx])
        info = np.stack([prepared[i][1] for i in idx])
        outputs = predictor.raw(canvases, info)
        info_t = torch.from_numpy(info).to(predictor.device)
        boxes_b, scores_b, keep_b = (
            t.cpu().numpy() for t in postprocess(predictor, outputs, info_t,
                                                 score_thresh))
        for j, i in enumerate(idx):
            dets[i] = detections_from_keep(boxes_b, scores_b, keep_b, j)
    return dets


def detect_image(predictor: Predictor, img: np.ndarray,
                 vis_thresh: float = 0.5) -> Dict[int, np.ndarray]:
    """Detections of one RGB uint8 image, ``{class_id: (k, 5) [x1 y1 x2
    y2 score]}`` in raw image coordinates, through the eval's
    postprocess at ``score_thresh = vis_thresh``."""
    return detect(predictor, [img], 1, vis_thresh)[0]


_COLORS = [(230, 60, 60), (60, 200, 80), (70, 110, 240), (240, 200, 50),
           (200, 70, 220), (70, 210, 210), (250, 140, 50), (150, 150, 150)]


def draw_detections(img: np.ndarray, dets: Dict[int, np.ndarray],
                    class_names: List[str] = None) -> np.ndarray:
    """Labelled boxes drawn with PIL (ref ``vis_all_detection``); returns
    the annotated RGB uint8 array, of the image's size."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(img.astype(np.uint8))
    draw = ImageDraw.Draw(im)
    for c, arr in sorted(dets.items()):
        color = _COLORS[c % len(_COLORS)]
        name = class_names[c] if class_names and c < len(class_names) \
            else f"cls{c}"
        for x1, y1, x2, y2, score in arr:
            draw.rectangle([float(x1), float(y1), float(x2), float(y2)],
                           outline=color, width=2)
            draw.text((float(x1) + 2, float(y1) + 2),
                      f"{name} {score:.2f}", fill=color)
    return np.asarray(im)


def demo(cfg, *, prefix: str, epoch: int, image: str, out_path: str,
         vis_thresh: float = 0.5, class_names: List[str] = None,
         device="cuda") -> Dict[int, np.ndarray]:
    """The checkpoint ``prefix``@``epoch`` on ``device`` (CUDA unless the
    caller asks for the CPU) over ``image``: its detections above
    ``vis_thresh``, drawn into ``out_path``; returns them."""
    from PIL import Image

    predictor = Predictor(load_model(cfg, prefix, epoch, device), cfg,
                          device)
    img = read_image(image)
    dets = detect_image(predictor, img, vis_thresh)
    n = sum(len(v) for v in dets.values())
    print(f"{n} detections over {vis_thresh} in {image}")
    Image.fromarray(draw_detections(img, dets, class_names)).save(out_path)
    print(f'wrote the annotated image to "{out_path}"')
    return dets


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("images", nargs="*", help="image files to detect on")
    p.add_argument("--prefix", default=None,
                   help="checkpoint prefix: detect on --image with the "
                        "weights of --epoch and draw into --out")
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--image", default=None, help="the image of --prefix")
    p.add_argument("--out", default=None,
                   help="the drawn image (default: <image>_det.png)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="add this many seeded synthetic images")
    p.add_argument("--network", default="resnet101",
                   choices=NETWORKS)
    p.add_argument("--dataset", default="PascalVOC")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--batch", type=int, default=1, help="images per forward")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights and synthetic images")
    p.add_argument("--vis_thresh", type=float, default=0.5,
                   help="score floor of the printed or drawn detections")
    p.add_argument("--set", action="append", metavar="SEC__FIELD=VAL",
                   help="override a config field (repeatable)")
    return p.parse_args(argv)


def main(argv=None) -> List[Dict[int, np.ndarray]]:
    args = parse_args(argv)
    cfg = generate_config(args.network, args.dataset,
                          **parse_set_overrides(args.set))
    if args.prefix is not None:
        if args.epoch is None or args.image is None:
            raise SystemExit("--prefix needs --epoch and --image")
        out = args.out or (os.path.splitext(args.image)[0] + "_det.png")
        return [demo(cfg, prefix=args.prefix, epoch=args.epoch,
                     image=args.image, out_path=out,
                     vis_thresh=args.vis_thresh, device=args.device)]
    if not args.images and args.synthetic <= 0:
        raise SystemExit("give image paths, --synthetic N or --prefix")
    images = [read_image(p) for p in args.images]
    names = list(args.images)
    images += synthetic_images(args.synthetic, args.seed)
    names += [f"synthetic{i}" for i in range(args.synthetic)]
    predictor = Predictor(build_model(cfg, args.device, args.seed), cfg,
                          args.device)
    print(f"network={cfg.network.name} dtype={cfg.network.compute_dtype} "
          f"device={predictor.device} resize={RESIZE_BACKEND}")
    dets = detect(predictor, images, args.batch, args.vis_thresh)
    for name, d in zip(names, dets):
        n = sum(len(v) for v in d.values())
        print(f"{name}: {n} detections over {args.vis_thresh}")
        for c, arr in sorted(d.items()):
            for x1, y1, x2, y2, s in arr:
                print(f"  class {c} score {s:.3f} box "
                      f"[{x1:.1f} {y1:.1f} {x2:.1f} {y2:.1f}]")
    return dets


if __name__ == "__main__":
    main()
