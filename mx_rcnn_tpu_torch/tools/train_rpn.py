"""Train the RPN stage of the alternate schedule (stages 1 and 3).

Counterpart of ``mx_rcnn_tpu/tools/train_rpn.py``: :func:`train_net`
with ``mode='rpn'`` on the training roidb (the dataset's, read as
``tools/train.py`` reads it, or ``--synthetic N`` seeded synthetic
images) and its flipped copies.  ``--init_from PREFIX
--init_from_epoch E`` starts from a stage checkpoint's weights (a fresh
optimizer); ``--frozen_shared`` freezes ``network.fixed_params_shared``
(stage 3: the shared convs stay as they were).  The reference's
``--pretrained`` ImageNet start waits for weights in the repository.

    python -m mx_rcnn_tpu_torch.tools.train_rpn --network vgg \\
        --dataset PascalVOC --synthetic 8 --batch_images 2 \\
        --prefix model/rpn --end_epoch 1                             # card
    python -m mx_rcnn_tpu_torch.tools.train_rpn --device cpu \\
        --network tiny --dataset synthetic --synthetic 4 \\
        --prefix /tmp/rpn --end_epoch 1
"""

from __future__ import annotations

import argparse
import pickle
from typing import Dict

from mx_rcnn_tpu_torch.config import NETWORKS
from mx_rcnn_tpu_torch.tools import dataset_args
from mx_rcnn_tpu_torch.tools.train import config_from_args, train_net


def common_args(p: argparse.ArgumentParser, default_prefix: str) -> None:
    """The flags every stage tool shares."""
    p.add_argument("--network", default="resnet101", choices=NETWORKS)
    dataset_args(p)
    p.add_argument("--prefix", default=default_prefix)
    p.add_argument("--batch_images", type=int, default=None,
                   help="images per step")
    p.add_argument("--no_flip", action="store_true",
                   help="without the flipped copies")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights, the draws and the shuffle")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", action="append", metavar="SEC__FIELD=VAL",
                   help="override a config field (repeatable)")


def stage_args(p: argparse.ArgumentParser, default_prefix: str) -> None:
    """The flags of the two training stage tools."""
    common_args(p, default_prefix)
    p.add_argument("--init_from", default=None,
                   help="checkpoint prefix whose weights start the stage")
    p.add_argument("--init_from_epoch", type=int, default=0)
    p.add_argument("--frozen_shared", action="store_true",
                   help="freeze network__fixed_params_shared (stages 3, 4)")
    p.add_argument("--end_epoch", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr_step", default=None)
    p.add_argument("--frequent", type=int, default=None,
                   help="log every this many steps")


def run_stage(args, mode: str, proposals=None) -> Dict[str, float]:
    """Train one stage from a stage tool's flags; its epochs, lr and lr
    steps default to ``default__rpn_*`` or ``default__rcnn_*``."""
    cfg = config_from_args(args)
    d = cfg.default
    pick = lambda given, rpn, rcnn: given if given is not None else (
        rpn if mode == "rpn" else rcnn)
    _, metrics = train_net(
        cfg, prefix=args.prefix, mode=mode, proposals=proposals,
        init_from=((args.init_from, args.init_from_epoch)
                   if args.init_from else None),
        frozen_prefixes=(cfg.network.fixed_params_shared
                         if args.frozen_shared else None),
        synthetic=args.synthetic,
        end_epoch=pick(args.end_epoch, d.rpn_epoch, d.rcnn_epoch),
        lr=pick(args.lr, d.rpn_lr, d.rcnn_lr),
        lr_step=pick(args.lr_step, d.rpn_lr_step, d.rcnn_lr_step),
        frequent=args.frequent, seed=args.seed, device=args.device,
        log=lambda line: print(line, flush=True))
    print("final " + ", ".join(f"{k}={v:.4f}" for k, v in metrics.items()),
          flush=True)
    return metrics


def load_proposals(path: str) -> list:
    """A proposal pickle (``tools/test_rpn.py``'s, or the JAX package's)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    stage_args(p, default_prefix="model/rpn")
    return run_stage(p.parse_args(argv), mode="rpn")


if __name__ == "__main__":
    main()
