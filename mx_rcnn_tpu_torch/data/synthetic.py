"""Synthetic detection images: coloured rectangles on a noise background.

Counterpart of ``mx_rcnn_tpu/data/synthetic.py``.  :class:`SyntheticDataset`
is an :class:`IMDB` rendered in memory (no PNG cache).  The specs come
from the same ``RandomState`` sequence, seeded from ``crc32(image_set)``,
so the two packages generate the same boxes, classes and pixels, and
score detections with the same VOC07 evaluator.  Class k fills its
rectangles with a class-specific colour, which makes the task learnable.

The generated benchmark sets, :class:`HardSyntheticDataset`
(``synthetic_hard``: scale, crowding, occlusion, appearance noise and
distractors on a 240x320 canvas) and :class:`StreamSyntheticDataset`
(``synthetic_stream``: COCO's cardinality and 80 classes on a tiled
240x320 background), write their images once as PNG files under the
dataset directory, as the JAX sets do, stamped with the signature of
their specs (``.spec-<crc>``): their roidb ``image`` fields are real
files, so the decode cache and the decode pool read them, which is what
``synthetic_stream`` exists to measure.  Specs, pixels and stamps equal
the JAX package's.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from mx_rcnn_tpu_torch.data.image import imwrite_rgb
from mx_rcnn_tpu_torch.data.roidb import IMDB, Roidb
from mx_rcnn_tpu_torch.data.voc_eval import voc_eval

VOC_IMAGE_SIZE = (375, 500)


# the canvas (h, w) of each generated set
_CANVAS = {"synthetic": (320, 400), "synthetic_hard": (240, 320),
           "synthetic_stream": (240, 320)}


def default_image_size(dataset: str) -> Tuple[int, int]:
    """(h, w) of the synthetic stand-in images for a dataset preset: a
    generated set's own canvas, else VOC's typical 375x500."""
    return _CANVAS.get(dataset, VOC_IMAGE_SIZE)


def _class_color(c: int) -> np.ndarray:
    rng = np.random.RandomState(1234 + c)
    return rng.randint(40, 255, size=3).astype(np.uint8)


def _iou(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]) + 1)
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]) + 1)
    inter = ix * iy
    area = lambda r: (r[2] - r[0] + 1) * (r[3] - r[1] + 1)
    return inter / (area(a) + area(b) - inter)


class SyntheticDataset(IMDB):
    """``num_images`` deterministic images of ``image_size`` (h, w), each
    with 1..max_objects low-overlap rectangles of classes 1..C-1."""

    def __init__(self, image_set: str = "train",
                 num_images: Optional[int] = None, num_classes: int = 4,
                 image_size: Tuple[int, int] = (320, 400),
                 max_objects: int = 3, root_path: str = "data",
                 dataset_path: Optional[str] = None):
        if num_images is None:
            num_images = 64 if "train" in image_set else 16
        super().__init__("synthetic", image_set, root_path,
                         dataset_path or os.path.join(root_path, "synthetic"))
        self.classes = ["__background__"] + [
            f"class{i}" for i in range(1, num_classes)]
        self.num_images = num_images
        self.image_size = tuple(image_size)
        self.max_objects = max_objects
        self._rng = np.random.RandomState(
            zlib.crc32(image_set.encode()) % (2 ** 31))
        self.specs = self._make_specs()
        self.image_index = list(range(num_images))

    def _make_specs(self) -> List[Dict]:
        h, w = self.image_size
        rng = self._rng
        specs = []
        for _ in range(self.num_images):
            n = rng.randint(1, self.max_objects + 1)
            boxes, classes = [], []
            for _ in range(n):
                # rejection-sample low-overlap placements
                for _attempt in range(20):
                    bw = rng.randint(max(16, w // 5), max(17, w // 2))
                    bh = rng.randint(max(16, h // 5), max(17, h // 2))
                    x1 = rng.randint(0, w - bw)
                    y1 = rng.randint(0, h - bh)
                    cand = [x1, y1, x1 + bw - 1, y1 + bh - 1]
                    if all(_iou(cand, b) < 0.2 for b in boxes):
                        boxes.append(cand)
                        classes.append(rng.randint(1, self.num_classes))
                        break
            specs.append(dict(
                boxes=np.asarray(boxes, np.float32),
                gt_classes=np.asarray(classes, np.int32),
                noise_seed=int(rng.randint(0, 2 ** 31)),
            ))
        return specs

    def render(self, i: int) -> np.ndarray:
        """Image ``i`` as RGB uint8 (h, w, 3)."""
        return self._render(self.specs[i])

    def _render(self, spec: Dict) -> np.ndarray:
        h, w = self.image_size
        rng = np.random.RandomState(spec["noise_seed"])
        img = rng.randint(0, 60, size=(h, w, 3)).astype(np.uint8)
        for box, cls in zip(spec["boxes"], spec["gt_classes"]):
            x1, y1, x2, y2 = box.astype(int)
            img[y1:y2 + 1, x1:x2 + 1] = _class_color(int(cls))
        return img

    def gt_roidb(self) -> Roidb:
        h, w = self.image_size
        return [dict(image=f"{self.image_set}_{i:05d}", index=i, height=h,
                     width=w, boxes=spec["boxes"].copy(),
                     gt_classes=spec["gt_classes"].copy(), flipped=False)
                for i, spec in enumerate(self.specs)]

    def load_image(self, rec: Dict) -> np.ndarray:
        return self.render(rec["index"])

    def evaluate_detections(self, all_boxes, out_dir: Optional[str] = None
                            ) -> Dict[str, float]:
        """VOC07 AP of each class that has a gt box, and their mean;
        nothing is written, so ``out_dir`` is unused."""
        gt = {i: dict(boxes=spec["boxes"], gt_classes=spec["gt_classes"],
                      difficult=np.zeros(len(spec["boxes"]), bool))
              for i, spec in enumerate(self.specs)}
        aps = []
        results = {}
        for c in range(1, self.num_classes):
            if not any((g["gt_classes"] == c).any() for g in gt.values()):
                continue
            dets = {i: np.asarray(all_boxes[c][i]).reshape(-1, 5)
                    for i in range(self.num_images)}
            ap = voc_eval(dets, gt, c, ovthresh=0.5, use_07_metric=True)
            results[self.classes[c]] = ap
            aps.append(ap)
        results["mAP"] = float(np.mean(aps)) if aps else 0.0
        return results


class _GeneratedFiles(SyntheticDataset):
    """A generated set whose images are PNG files under
    ``<dataset_path>/<image_set>``, written on the first :meth:`gt_roidb`
    (and again whenever the stamp of the specs is missing); its
    :meth:`load_image` is :meth:`IMDB.load_image`, which decodes the
    record's file."""

    load_image = IMDB.load_image

    def __init__(self, image_set: str, subdir: str, root_path: str,
                 dataset_path: Optional[str], **kw):
        super().__init__(image_set, root_path=root_path,
                         dataset_path=dataset_path
                         or os.path.join(root_path, subdir), **kw)
        self.image_dir = os.path.join(self.data_path, self.image_set)

    def image_path(self, i: int) -> str:
        return os.path.join(self.image_dir, f"{self.image_set}_{i:05d}.png")

    def _spec_signature(self) -> str:
        """crc32 of the generation parameters and every spec: the PNGs on
        disk are valid only for exactly these (the JAX base signature)."""
        h = zlib.crc32(repr((self.num_images, self.num_classes,
                             self.image_size, self.max_objects)).encode())
        for spec in self.specs:
            h = zlib.crc32(spec["boxes"].tobytes(), h)
            h = zlib.crc32(spec["gt_classes"].tobytes(), h)
            h = zlib.crc32(str(spec["noise_seed"]).encode(), h)
        return f"{h:08x}"

    def _materialize(self) -> None:
        """Write the PNGs unless this signature's stamp is there and every
        file exists; a fresh write drops other signatures' stamps, whose
        pixels it overwrote."""
        os.makedirs(self.image_dir, exist_ok=True)
        stamp = os.path.join(self.image_dir,
                             f".spec-{self._spec_signature()}")
        fresh = os.path.exists(stamp)
        for i, spec in enumerate(self.specs):
            path = self.image_path(i)
            if not fresh or not os.path.exists(path):
                imwrite_rgb(path, self._render(spec))
        if not fresh:
            for name in os.listdir(self.image_dir):
                if name.startswith(".spec-"):
                    os.unlink(os.path.join(self.image_dir, name))
            with open(stamp, "w"):
                pass

    def gt_roidb(self) -> Roidb:
        self._materialize()
        return [dict(rec, image=self.image_path(i))
                for i, rec in enumerate(super().gt_roidb())]


# a fixed, well-separated palette: the hue is the class; scale, stripes,
# brightness, occlusion and distractors vary within a class
_HARD_PALETTE = np.array([
    [220, 40, 40],    # red
    [40, 200, 40],    # green
    [50, 80, 230],    # blue
    [230, 220, 40],   # yellow
    [220, 50, 220],   # magenta
    [40, 220, 220],   # cyan
    [240, 140, 30],   # orange
    [150, 60, 220],   # purple
], np.uint8)


class HardSyntheticDataset(_GeneratedFiles):
    """The harder generated set (``synthetic_hard``): per image 2..8
    objects of log-uniform size (canvas/12 .. canvas/2), overlapping up to
    IoU 0.4 while each keeps at least :attr:`MIN_VISIBLE` of its pixels
    (an owner grid, painter's order), brightness jitter and optional
    stripes within a class, and 2..4 grey distractors that are no class.
    9 classes, 400 train / 100 test images on 240x320 by default."""

    MIN_VISIBLE = 0.5

    def __init__(self, image_set: str = "train",
                 num_images: Optional[int] = None, num_classes: int = 9,
                 image_size: Tuple[int, int] = (240, 320),
                 max_objects: int = 8, root_path: str = "data",
                 dataset_path: Optional[str] = None):
        if num_images is None:
            num_images = 400 if "train" in image_set else 100
        if num_classes > len(_HARD_PALETTE) + 1:
            raise ValueError(
                f"num_classes <= {len(_HARD_PALETTE) + 1} supported")
        super().__init__(image_set, "synthetic_hard", root_path,
                         dataset_path, num_images=num_images,
                         num_classes=num_classes, image_size=image_size,
                         max_objects=max_objects)

    def _make_specs(self) -> List[Dict]:
        h, w = self.image_size
        rng = self._rng
        lo, hi = np.log(max(12.0, w / 12)), np.log(w / 2)
        specs = []
        for _ in range(self.num_images):
            n = rng.randint(2, self.max_objects + 1)
            boxes, classes = [], []
            owner = np.full((h, w), -1, np.int32)
            visible, areas = [], []
            for _ in range(n):
                for _attempt in range(25):
                    bw = int(round(np.exp(rng.uniform(lo, hi))))
                    bh = int(round(np.exp(rng.uniform(lo, hi))))
                    bw, bh = min(bw, w - 2), min(bh, h - 2)
                    x1 = rng.randint(0, w - bw)
                    y1 = rng.randint(0, h - bh)
                    cand = [x1, y1, x1 + bw - 1, y1 + bh - 1]
                    if not all(_iou(cand, b) < 0.4 for b in boxes):
                        continue
                    # what each earlier box keeps visible after this draw
                    region = owner[y1:y1 + bh, x1:x1 + bw]
                    covered = np.bincount(region[region >= 0],
                                          minlength=len(boxes))
                    if any((visible[e] - covered[e]) / areas[e]
                           < self.MIN_VISIBLE for e in range(len(boxes))):
                        continue
                    for e in range(len(boxes)):
                        visible[e] -= int(covered[e])
                    owner[y1:y1 + bh, x1:x1 + bw] = len(boxes)
                    boxes.append(cand)
                    classes.append(rng.randint(1, self.num_classes))
                    visible.append(bh * bw)
                    areas.append(bh * bw)
                    break
            distract = []
            for _ in range(rng.randint(2, 5)):
                dw = rng.randint(12, max(13, w // 4))
                dh = rng.randint(12, max(13, h // 4))
                dx = rng.randint(0, w - dw)
                dy = rng.randint(0, h - dh)
                cand = [dx, dy, dx + dw - 1, dy + dh - 1]
                if all(_iou(cand, b) < 0.2 for b in boxes):
                    distract.append(cand)
            specs.append(dict(
                boxes=np.asarray(boxes, np.float32),
                gt_classes=np.asarray(classes, np.int32),
                distractors=np.asarray(distract, np.float32).reshape(-1, 4),
                noise_seed=int(rng.randint(0, 2 ** 31)),
            ))
        return specs

    def _render(self, spec: Dict) -> np.ndarray:
        h, w = self.image_size
        rng = np.random.RandomState(spec["noise_seed"])
        img = rng.randint(0, 90, size=(h, w, 3)).astype(np.uint8)
        for box in spec["distractors"]:  # first: never over an object
            x1, y1, x2, y2 = box.astype(int)
            g = rng.randint(60, 140)
            jit = rng.randint(-15, 16, 3)
            img[y1:y2 + 1, x1:x2 + 1] = np.clip(g + jit, 0, 255
                                                ).astype(np.uint8)
        for box, cls in zip(spec["boxes"], spec["gt_classes"]):
            x1, y1, x2, y2 = box.astype(int)
            color = _HARD_PALETTE[int(cls) - 1].astype(np.float32)
            color = np.clip(color * rng.uniform(0.75, 1.25), 0, 255)
            patch = np.broadcast_to(
                color, (y2 - y1 + 1, x2 - x1 + 1, 3)).copy()
            if rng.rand() < 0.5:  # darker stripes along a random axis
                period = rng.randint(4, 9)
                axis = rng.randint(2)
                idx = np.arange(patch.shape[axis])
                stripe = (idx // max(1, period // 2)) % 2 == 1
                if axis == 0:
                    patch[stripe, :, :] *= 0.6
                else:
                    patch[:, stripe, :] *= 0.6
            img[y1:y2 + 1, x1:x2 + 1] = patch.astype(np.uint8)
            # a dark outline delineates occluded stacks of one colour
            img[y1:y2 + 1, [x1, x2]] = 20
            img[[y1, y2], x1:x2 + 1] = 20
        return img

    def _spec_signature(self) -> str:
        base = super()._spec_signature()
        h = zlib.crc32(b"hard", int(base, 16))
        for spec in self.specs:
            h = zlib.crc32(spec["distractors"].tobytes(), h)
        return f"{h:08x}"


class StreamSyntheticDataset(_GeneratedFiles):
    """The cardinality set (``synthetic_stream``): 10,000 train / 1,000
    test images and 81 classes by default, on a 240x320 canvas whose
    background is one 16x16 noise tile repeated (small PNGs, cheap
    decodes), rectangles in :func:`_class_color`, up to 6 an image."""

    def __init__(self, image_set: str = "train",
                 num_images: Optional[int] = None, num_classes: int = 81,
                 image_size: Tuple[int, int] = (240, 320),
                 max_objects: int = 6, root_path: str = "data",
                 dataset_path: Optional[str] = None):
        if num_images is None:
            num_images = 10_000 if "train" in image_set else 1_000
        super().__init__(image_set, "synthetic_stream", root_path,
                         dataset_path, num_images=num_images,
                         num_classes=num_classes, image_size=image_size,
                         max_objects=max_objects)

    def _render(self, spec: Dict) -> np.ndarray:
        h, w = self.image_size
        rng = np.random.RandomState(spec["noise_seed"])
        tile = rng.randint(0, 60, size=(16, 16, 3)).astype(np.uint8)
        img = np.ascontiguousarray(
            np.tile(tile, ((h + 15) // 16, (w + 15) // 16, 1))[:h, :w])
        for box, cls in zip(spec["boxes"], spec["gt_classes"]):
            x1, y1, x2, y2 = box.astype(int)
            img[y1:y2 + 1, x1:x2 + 1] = _class_color(int(cls))
        return img

    def _spec_signature(self) -> str:
        # apart from the base signature: the pixels differ
        base = super()._spec_signature()
        return f"{zlib.crc32(b'stream', int(base, 16)):08x}"
