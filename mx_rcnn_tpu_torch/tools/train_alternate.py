"""Four-stage alternate training (the Faster R-CNN paper's schedule).

Counterpart of ``mx_rcnn_tpu/tools/train_alternate.py — alternate_train``:

  1.   train the RPN                                  → <prefix>-rpn1
  1.5  dump rpn1's proposals over the training roidb  → <prefix>-rpn1-proposals.pkl
  2.   train Fast R-CNN on them                       → <prefix>-rcnn1
  3.   retrain the RPN from rcnn1, shared convs frozen → <prefix>-rpn2
  3.5  dump rpn2's proposals                          → <prefix>-rpn2-proposals.pkl
  4.   retrain Fast R-CNN from rpn2, shared convs frozen → <prefix>-rcnn2
  ∪    rpn2's ``rpn`` and ``backbone`` with rcnn2's head → <prefix>-final-0001.ckpt

on the training roidb (the dataset's, read as ``tools/train.py`` reads
it, or ``--synthetic N`` seeded synthetic images) and its flipped
copies, on the card unless ``--device cpu``.  As in the reference,
``--pretrained FILE`` starts stages 1 and 2 from ImageNet weights
(``utils/pretrained.py``); without it stage 1 starts from a seeded init
and stage 2 either from the same seeded init (``--stage2_init fresh``,
the JAX package's default) or from rpn1 (``rpn1``); from a seeded init
VGG16 diverges at the reference's lr 0.001 and trains at 1e-4.
``--num_devices N`` trains each stage on N cards, one process each
(``tools/train.py``); the dumps run in this process.
Evaluate the final model with ``tools/test.py --prefix <prefix>-final
--epoch 1``.

    python -m mx_rcnn_tpu_torch.tools.train_alternate --network vgg \\
        --dataset PascalVOC --synthetic 8 --batch_images 2 \\
        --rpn_epoch 1 --rcnn_epoch 1 --rpn_lr 1e-4 --rcnn_lr 1e-4 \\
        --prefix model/alt                                            # card
    python -m mx_rcnn_tpu_torch.tools.train_alternate --device cpu \\
        --network tiny --dataset synthetic --synthetic 4 \\
        --rpn_epoch 1 --rcnn_epoch 1 --prefix /tmp/alt
"""

from __future__ import annotations

import argparse
from typing import Callable

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.data import load_gt_roidb
from mx_rcnn_tpu_torch.tools.test_rpn import dump_proposals
from mx_rcnn_tpu_torch.tools.train import config_from_args, train_net
from mx_rcnn_tpu_torch.tools.train_rpn import common_args
from mx_rcnn_tpu_torch.utils.checkpoint import (combine_model,
                                                load_state_dict, save_params)
from mx_rcnn_tpu_torch.utils.device import resolve_device


def alternate_train(cfg: Config, *, prefix: str, synthetic: int = 0,
                    rpn_epoch: int = None, rpn_lr: float = None,
                    rpn_lr_step: str = None, rcnn_epoch: int = None,
                    rcnn_lr: float = None, rcnn_lr_step: str = None,
                    frequent: int = None, seed: int = 0,
                    stage2_init: str = "fresh", pretrained: str = None,
                    pretrained_epoch: int = 0, device="cuda",
                    num_devices: int = None,
                    log: Callable[[str], None] = print) -> str:
    """Run the four stages, the two dumps and the combine on ``device``
    (CUDA unless the caller asks for the CPU); returns the final prefix
    (its checkpoint is ``<prefix>-final-0001.ckpt``).  Each stage's
    epochs, lr and lr steps default to ``default__rpn_*`` and
    ``default__rcnn_*``.  ``pretrained`` starts stages 1 and 2; stage 2
    starts from rpn1 only without it and with ``stage2_init='rpn1'``.
    ``num_devices`` goes to every stage's :func:`train_net`."""
    if stage2_init not in ("fresh", "rpn1"):
        raise ValueError(f"stage2_init must be 'fresh' or 'rpn1', got "
                         f"{stage2_init!r}")
    resolve_device(device)
    d = cfg.default
    rpn_epoch = d.rpn_epoch if rpn_epoch is None else rpn_epoch
    rcnn_epoch = d.rcnn_epoch if rcnn_epoch is None else rcnn_epoch
    rpn = dict(end_epoch=rpn_epoch,
               lr=d.rpn_lr if rpn_lr is None else rpn_lr,
               lr_step=d.rpn_lr_step if rpn_lr_step is None else rpn_lr_step)
    rcnn = dict(end_epoch=rcnn_epoch,
                lr=d.rcnn_lr if rcnn_lr is None else rcnn_lr,
                lr_step=(d.rcnn_lr_step if rcnn_lr_step is None
                         else rcnn_lr_step))
    shared = cfg.network.fixed_params_shared

    imdb, roidb = load_gt_roidb(cfg, training=True, synthetic=synthetic)
    common = dict(roidb=roidb, load_image=imdb.load_image, frequent=frequent,
                  seed=seed, device=device, num_devices=num_devices, log=log)

    def dump(stage: str):
        return dump_proposals(cfg, roidb, imdb.load_image,
                              f"{prefix}-{stage}", rpn_epoch,
                              f"{prefix}-{stage}-proposals.pkl", device, log)

    imagenet = dict(pretrained=pretrained, pretrained_epoch=pretrained_epoch)
    log("=== Stage 1: train the RPN ===")
    train_net(cfg, mode="rpn", prefix=f"{prefix}-rpn1", **imagenet, **rpn,
              **common)
    log("=== Stage 1.5: proposals from rpn1 ===")
    props1 = dump("rpn1")
    log("=== Stage 2: train Fast R-CNN on rpn1's proposals ===")
    train_net(cfg, mode="rcnn", prefix=f"{prefix}-rcnn1", proposals=props1,
              init_from=((f"{prefix}-rpn1", rpn_epoch)
                         if not pretrained and stage2_init == "rpn1"
                         else None),
              **imagenet, **rcnn, **common)
    log("=== Stage 3: retrain the RPN, shared convs frozen ===")
    train_net(cfg, mode="rpn", prefix=f"{prefix}-rpn2",
              init_from=(f"{prefix}-rcnn1", rcnn_epoch),
              frozen_prefixes=shared, **rpn, **common)
    log("=== Stage 3.5: proposals from rpn2 ===")
    props2 = dump("rpn2")
    log("=== Stage 4: retrain Fast R-CNN, shared convs frozen ===")
    train_net(cfg, mode="rcnn", prefix=f"{prefix}-rcnn2", proposals=props2,
              init_from=(f"{prefix}-rpn2", rpn_epoch),
              frozen_prefixes=shared, **rcnn, **common)
    log("=== Combine rpn2 and rcnn2 ===")
    final = combine_model(load_state_dict(f"{prefix}-rpn2", rpn_epoch),
                          load_state_dict(f"{prefix}-rcnn2", rcnn_epoch),
                          from_a=("rpn", "backbone"))
    path = save_params(f"{prefix}-final", 1, final)
    log(f'saved the combined model to "{path}"')
    return f"{prefix}-final"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common_args(p, default_prefix="model/alt")
    for stage in ("rpn", "rcnn"):
        p.add_argument(f"--{stage}_epoch", type=int, default=None)
        p.add_argument(f"--{stage}_lr", type=float, default=None)
        p.add_argument(f"--{stage}_lr_step", default=None)
    p.add_argument("--frequent", type=int, default=None,
                   help="log every this many steps")
    p.add_argument("--stage2_init", choices=["fresh", "rpn1"],
                   default="fresh",
                   help="without --pretrained, stage 2 starts from the "
                        "seeded init (fresh) or from rpn1")
    p.add_argument("--pretrained", default=None,
                   help="ImageNet weights that start stages 1 and 2 (.params, "
                        ".npz or VGG16 .pth, or a prefix of "
                        "PREFIX-%%04d.params)")
    p.add_argument("--pretrained_epoch", type=int, default=0)
    p.add_argument("--num_devices", type=int, default=None,
                   help="train each stage on this many cards, one process "
                        "each")
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    return alternate_train(
        config_from_args(args), prefix=args.prefix, synthetic=args.synthetic,
        rpn_epoch=args.rpn_epoch, rpn_lr=args.rpn_lr,
        rpn_lr_step=args.rpn_lr_step, rcnn_epoch=args.rcnn_epoch,
        rcnn_lr=args.rcnn_lr, rcnn_lr_step=args.rcnn_lr_step,
        frequent=args.frequent, seed=args.seed,
        stage2_init=args.stage2_init, pretrained=args.pretrained,
        pretrained_epoch=args.pretrained_epoch, device=args.device,
        num_devices=args.num_devices,
        log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
