"""Train Faster R-CNN on a VOCdevkit, a COCO tree or synthetic images.

Counterpart of ``mx_rcnn_tpu/tools/train.py`` for one device:
:func:`train_net` builds the training roidb (``--dataset PascalVOC|coco``
read from ``--dataset_path`` with its gt_roidb cache under
``--root_path``, ``--image_set`` '+'-joined sets merged; or with
``--synthetic N`` that many synthetic images, the JAX package's
rectangles rendered in memory, 375x500 like VOC unless the dataset is a
synthetic one), with its flipped copies unless ``--no_flip`` → the
decode cache and pool of the config's ``default`` section for the
on-disk sets → ``StreamLoader`` (``data__streaming``, the default, as in
the JAX package) or ``AnchorLoader`` → epochs ``--begin_epoch ..
--end_epoch`` of train steps, each batch staged to the device ahead of
its step → Speedometer lines, and with ``--prefix`` a checkpoint after
each epoch (``prefix-%04d.ckpt``, the JAX package's layout).
``--resume`` starts from the newest checkpoint under ``--prefix``,
``--begin_epoch N`` from epoch N's; the resumed run ends bit-equal to an
unbroken one.  ``--steps`` ends the run after that many steps.  Weights
start random, made from ``--seed``.  The alternate schedule's stage
tools (``train_rpn.py``, ``train_rcnn.py``, ``train_alternate.py``) call
:func:`train_net` with ``mode='rpn'`` or ``'rcnn'`` (``ROIIter``).

    python -m mx_rcnn_tpu_torch.tools.train --network resnet101 \\
        --dataset PascalVOC --root_path data --dataset_path data/VOCdevkit \\
        --batch_images 2 --prefix model/e2e --end_epoch 1             # card
    python -m mx_rcnn_tpu_torch.tools.train --device cpu --network tiny \\
        --dataset synthetic --synthetic 4 --batch_images 2 \\
        --prefix /tmp/p --end_epoch 1
"""

from __future__ import annotations

import argparse
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

from mx_rcnn_tpu_torch.config import (NETWORKS, Config, generate_config,
                                      parse_set_overrides)
from mx_rcnn_tpu_torch.core.fit import fit
from mx_rcnn_tpu_torch.core.train import (TrainState, make_train_step,
                                          setup_training)
from mx_rcnn_tpu_torch.data import load_gt_roidb, reads_files
from mx_rcnn_tpu_torch.data.loader import (AnchorLoader, ROIIter,
                                           StreamLoader, cache_from_config,
                                           decode_pool_from_config)
from mx_rcnn_tpu_torch.tools import dataset_args, dataset_overrides
from mx_rcnn_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                load_state_dict,
                                                restore_state)
from mx_rcnn_tpu_torch.utils.device import resolve_device


def train_net(cfg: Config, *, prefix: Optional[str] = None,
              mode: str = "e2e", proposals: Optional[Sequence] = None,
              init_from: Optional[Tuple[str, int]] = None,
              frozen_prefixes: Optional[Sequence[str]] = None,
              roidb=None, load_image: Optional[Callable] = None,
              synthetic: int = 0, begin_epoch: int = 0,
              end_epoch: Optional[int] = None, resume: bool = False,
              lr: Optional[float] = None, lr_step: Optional[str] = None,
              steps: Optional[int] = None, frequent: Optional[int] = None,
              seed: int = 0, device="cuda",
              log: Callable[[str], None] = print
              ) -> Tuple[TrainState, Dict[str, float]]:
    """Train on ``device`` (CUDA unless the caller asks for the CPU);
    returns the final state and the last log window's mean metrics.

    ``mode``: ``'e2e'``, ``'rpn'`` or ``'rcnn'``; ``'e2e'`` and ``'rpn'``
    train on :class:`StreamLoader`'s plan when ``cfg.data.streaming`` (the
    default) and on :class:`AnchorLoader`'s otherwise; ``'rcnn'`` trains
    on ``proposals`` (one raw-coordinate (k, 5) array per roidb record)
    through :class:`ROIIter`.  ``roidb`` and its ``load_image`` may be
    given (the alternate schedule does); by default the config's training
    roidb is read, or that of ``synthetic`` synthetic images is built.
    Records read from files decode through the config's cache or decode
    pool (``default.image_cache_mb``, ``image_cache_dir``,
    ``decode_procs``); the pool is closed when the run ends.
    ``init_from``: a (prefix, epoch) checkpoint whose weights and
    statistics start the run, with a fresh optimizer.
    ``frozen_prefixes`` defaults to ``cfg.network.fixed_params``.  ``end_epoch`` defaults to
    ``default__e2e_epoch``, or to as many epochs as ``steps`` needs."""
    resolve_device(device)
    if mode == "rcnn" and proposals is None:
        raise ValueError("mode='rcnn' requires precomputed proposals")
    if (resume or begin_epoch) and not prefix:
        raise ValueError("resume and begin_epoch need a prefix")
    if roidb is None:
        imdb, roidb = load_gt_roidb(cfg, training=True, synthetic=synthetic)
        load_image = imdb.load_image
    elif load_image is None:
        raise ValueError("a roidb needs its load_image")
    source, pool = {}, None
    if reads_files(load_image):
        bh, bw = cfg.bucket.shapes[0]
        sizes = dict(n_images=len(roidb), image_bytes=bh * bw * 3,
                     batch_bytes=cfg.train.batch_images * bh * bw * 3)
        # with a pool the RAM tier lives in its workers, which start with
        # the first decode (inside fit)
        pool = decode_pool_from_config(cfg, **sizes)
        source = dict(decode_pool=pool, cache=None if pool else
                      cache_from_config(cfg, **sizes))
    if mode == "rcnn":
        loader = ROIIter(roidb, cfg, load_image, proposals, seed=seed,
                         **source)
    else:
        kind = StreamLoader if cfg.data.streaming else AnchorLoader
        loader = kind(roidb, cfg, load_image, seed=seed, **source)
    steps_per_epoch = max(len(loader), 1)
    state = setup_training(cfg, device, seed, steps_per_epoch, base_lr=lr,
                           lr_step=lr_step, frozen_prefixes=frozen_prefixes)
    if init_from is not None:
        state.model.load_state_dict(load_state_dict(*init_from))
        log(f"[{mode}] initialised from {init_from[0]} epoch {init_from[1]}")
    if resume:
        found = latest_checkpoint(prefix)
        begin_epoch = found[0] if found else 0
    if end_epoch is None:
        end_epoch = (begin_epoch + math.ceil(steps / steps_per_epoch)
                     if steps else cfg.default.e2e_epoch)
    log(f"[{mode}] network={cfg.network.name} "
        f"dtype={cfg.network.compute_dtype} "
        f"device={next(state.model.parameters()).device} "
        f"batch_images={loader.batch_images} records={len(roidb)} "
        f"loader={type(loader).__name__} "
        f"epochs={begin_epoch}..{end_epoch} steps={steps}")
    if begin_epoch > 0:
        restore_state(state, prefix, begin_epoch)
        log(f"resumed from {prefix} epoch {begin_epoch} (step {state.step})")
    try:
        metrics = fit(state, cfg, make_train_step(cfg, mode), loader,
                      end_epoch, begin_epoch, prefix, steps, frequent,
                      log=log)
    finally:
        if pool is not None:
            pool.close()
    log(f"[{mode}] images decoded: {loader.images_decoded}")
    return state, metrics


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--network", default="resnet101", choices=NETWORKS)
    dataset_args(p)
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
    p.add_argument("--no_flip", action="store_true",
                   help="train without the flipped copies")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights, the draws and the shuffle")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", action="append", metavar="SEC__FIELD=VAL",
                   help="override a config field (repeatable)")
    return p.parse_args(argv)


def config_from_args(args) -> Config:
    """The config of the training CLIs' ``--network``, ``--dataset``,
    ``--image_set``, ``--root_path``, ``--dataset_path``,
    ``--batch_images``, ``--no_flip`` and ``--set`` flags."""
    overrides = dataset_overrides(args)
    if args.image_set:
        overrides["dataset__image_set"] = args.image_set
    overrides.update(parse_set_overrides(args.set))
    if args.batch_images:
        overrides["train__batch_images"] = args.batch_images
    if args.no_flip:
        overrides["train__flip"] = False
    return generate_config(args.network, args.dataset, **overrides)


def main(argv=None) -> Dict[str, float]:
    args = parse_args(argv)
    if (args.resume or args.begin_epoch) and not args.prefix:
        raise SystemExit("--resume and --begin_epoch need --prefix")
    cfg = config_from_args(args)
    _, metrics = train_net(
        cfg, prefix=args.prefix, synthetic=args.synthetic,
        begin_epoch=args.begin_epoch, end_epoch=args.end_epoch,
        resume=args.resume, lr=args.lr, steps=args.steps,
        frequent=args.frequent, seed=args.seed, device=args.device,
        log=lambda line: print(line, flush=True))
    print("final " + ", ".join(f"{k}={v:.4f}" for k, v in metrics.items()),
          flush=True)
    return metrics


if __name__ == "__main__":
    main()
