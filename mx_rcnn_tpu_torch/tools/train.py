"""Train Faster R-CNN end to end on seeded synthetic images.

Counterpart of ``mx_rcnn_tpu/tools/train.py`` for the single-device
end-to-end path, without checkpoints: synthetic images (the JAX package's
rectangles, rendered in memory; 375x500 like VOC unless the dataset is a
synthetic one) → loader → ``--steps`` train steps → Speedometer lines.
Weights are random, made from ``--seed``.

    python -m mx_rcnn_tpu_torch.tools.train --network resnet101 \\
        --dataset PascalVOC --synthetic 8 --batch_images 2 --steps 8   # card
    python -m mx_rcnn_tpu_torch.tools.train --device cpu --network tiny \\
        --dataset synthetic --synthetic 4 --batch_images 2 --steps 2
"""

from __future__ import annotations

import argparse
from typing import Dict

from mx_rcnn_tpu_torch.config import generate_config, parse_set_overrides
from mx_rcnn_tpu_torch.core.fit import fit
from mx_rcnn_tpu_torch.core.train import make_train_step, setup_training
from mx_rcnn_tpu_torch.data.loader import AnchorLoader
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset

VOC_IMAGE_SIZE = (375, 500)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--network", default="resnet101",
                   choices=["resnet50", "resnet101", "tiny"])
    p.add_argument("--dataset", default="PascalVOC")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on this many seeded synthetic images")
    p.add_argument("--batch_images", type=int, default=None,
                   help="images per step")
    p.add_argument("--steps", type=int, default=8, help="train steps")
    p.add_argument("--lr", type=float, default=None,
                   help="base learning rate (default: default__e2e_lr)")
    p.add_argument("--frequent", type=int, default=None,
                   help="log every this many steps")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights, the draws and the shuffle")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", action="append", metavar="SEC__FIELD=VAL",
                   help="override a config field (repeatable)")
    return p.parse_args(argv)


def main(argv=None) -> Dict[str, float]:
    args = parse_args(argv)
    if args.synthetic <= 0:
        raise SystemExit("only synthetic data is ported: give --synthetic N")
    overrides = parse_set_overrides(args.set)
    if args.batch_images:
        overrides["train__batch_images"] = args.batch_images
    cfg = generate_config(args.network, args.dataset, **overrides)
    image_size = ((320, 400) if cfg.dataset.name.startswith("synthetic")
                  else VOC_IMAGE_SIZE)
    dataset = SyntheticDataset(cfg.dataset.image_set, args.synthetic,
                               cfg.num_classes, image_size)
    loader = AnchorLoader(dataset, cfg, seed=args.seed)
    state = setup_training(cfg, args.device, args.seed,
                           steps_per_epoch=max(len(loader), 1),
                           base_lr=args.lr)
    print(f"network={cfg.network.name} dtype={cfg.network.compute_dtype} "
          f"device={next(state.model.parameters()).device} "
          f"batch_images={loader.batch_images} images={dataset.num_images} "
          f"steps={args.steps}", flush=True)
    metrics = fit(state, cfg, make_train_step(cfg), loader, args.steps,
                  args.frequent, log=lambda line: print(line, flush=True))
    print("final " + ", ".join(f"{k}={v:.4f}" for k, v in metrics.items()),
          flush=True)
    return metrics


if __name__ == "__main__":
    main()
