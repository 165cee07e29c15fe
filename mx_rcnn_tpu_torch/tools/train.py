"""Train Faster R-CNN end to end on seeded synthetic images.

Counterpart of ``mx_rcnn_tpu/tools/train.py`` for the single-device
end-to-end path: synthetic images (the JAX package's rectangles, rendered
in memory; 375x500 like VOC unless the dataset is a synthetic one) →
loader → epochs ``--begin_epoch .. --end_epoch`` of train steps →
Speedometer lines, and with ``--prefix`` a checkpoint after each epoch
(``prefix-%04d.ckpt``, the JAX package's layout).  ``--resume`` starts
from the newest checkpoint under ``--prefix``, ``--begin_epoch N`` from
epoch N's; the resumed run ends bit-equal to an unbroken one.
``--steps`` ends the run after that many steps.  Weights start random,
made from ``--seed``.

    python -m mx_rcnn_tpu_torch.tools.train --network resnet101 \\
        --dataset PascalVOC --synthetic 8 --batch_images 2 \\
        --prefix model/e2e --end_epoch 1                              # card
    python -m mx_rcnn_tpu_torch.tools.train --device cpu --network tiny \\
        --dataset synthetic --synthetic 4 --batch_images 2 \\
        --prefix /tmp/p --end_epoch 1
"""

from __future__ import annotations

import argparse
import math
from typing import Dict

from mx_rcnn_tpu_torch.config import generate_config, parse_set_overrides
from mx_rcnn_tpu_torch.core.fit import fit
from mx_rcnn_tpu_torch.core.train import make_train_step, setup_training
from mx_rcnn_tpu_torch.data.loader import AnchorLoader
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset, default_image_size
from mx_rcnn_tpu_torch.utils.checkpoint import latest_checkpoint, restore_state


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--network", default="resnet101",
                   choices=["resnet50", "resnet101", "tiny"])
    p.add_argument("--dataset", default="PascalVOC")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on this many seeded synthetic images")
    p.add_argument("--batch_images", type=int, default=None,
                   help="images per step")
    p.add_argument("--prefix", default=None,
                   help="checkpoint prefix: save prefix-%%04d.ckpt after "
                        "each epoch")
    p.add_argument("--begin_epoch", type=int, default=0,
                   help="start from this epoch's checkpoint under --prefix")
    p.add_argument("--end_epoch", type=int, default=None,
                   help="train up to this epoch (default: default__e2e_epoch,"
                        " or as many as --steps needs)")
    p.add_argument("--resume", action="store_true",
                   help="start from the newest checkpoint under --prefix")
    p.add_argument("--steps", type=int, default=None,
                   help="end the run after this many steps")
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
    if (args.resume or args.begin_epoch) and not args.prefix:
        raise SystemExit("--resume and --begin_epoch need --prefix")
    cfg = generate_config(args.network, args.dataset, **overrides)
    dataset = SyntheticDataset(cfg.dataset.image_set, args.synthetic,
                               cfg.num_classes,
                               default_image_size(cfg.dataset.name))
    loader = AnchorLoader(dataset, cfg, seed=args.seed)
    state = setup_training(cfg, args.device, args.seed,
                           steps_per_epoch=max(len(loader), 1),
                           base_lr=args.lr)
    begin_epoch = args.begin_epoch
    if args.resume:
        found = latest_checkpoint(args.prefix)
        begin_epoch = found[0] if found else 0
    end_epoch = args.end_epoch
    if end_epoch is None:
        end_epoch = (begin_epoch + math.ceil(args.steps / max(len(loader), 1))
                     if args.steps else cfg.default.e2e_epoch)
    print(f"network={cfg.network.name} dtype={cfg.network.compute_dtype} "
          f"device={next(state.model.parameters()).device} "
          f"batch_images={loader.batch_images} images={dataset.num_images} "
          f"epochs={begin_epoch}..{end_epoch} steps={args.steps}", flush=True)
    if begin_epoch > 0:
        restore_state(state, args.prefix, begin_epoch)
        print(f"resumed from {args.prefix} epoch {begin_epoch} (step "
              f"{state.step})", flush=True)
    metrics = fit(state, cfg, make_train_step(cfg), loader, end_epoch,
                  begin_epoch, args.prefix, args.steps, args.frequent,
                  log=lambda line: print(line, flush=True))
    print("final " + ", ".join(f"{k}={v:.4f}" for k, v in metrics.items()),
          flush=True)
    return metrics


if __name__ == "__main__":
    main()
