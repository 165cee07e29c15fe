"""Dump a trained RPN's proposals to a pickle (alternate stages 1.5 and
3.5).

Counterpart of ``mx_rcnn_tpu/tools/test_rpn.py``: the RPN of checkpoint
``--prefix``@``--epoch`` over the training roidb (with its flipped copies
unless ``--no_flip``), or over the test roidb with ``--eval_set`` (for
``tools/test_rcnn.py``), written as a list in roidb order of float32
(k, 5) [x1 y1 x2 y2 score] arrays in raw image coordinates, the format
the JAX package reads and writes.

    python -m mx_rcnn_tpu_torch.tools.test_rpn --network vgg \\
        --dataset PascalVOC --synthetic 8 --prefix model/rpn --epoch 1 \\
        --out model/rpn-proposals.pkl                                 # card
"""

from __future__ import annotations

import argparse
import pickle
from typing import Callable, Dict, List, Sequence

import numpy as np

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.tester import generate_proposals
from mx_rcnn_tpu_torch.data import load_gt_roidb
from mx_rcnn_tpu_torch.data.loader import TestLoader
from mx_rcnn_tpu_torch.tools.train import config_from_args
from mx_rcnn_tpu_torch.tools.train_rpn import common_args
from mx_rcnn_tpu_torch.utils.checkpoint import load_model


def dump_proposals(cfg: Config, roidb: Sequence[Dict],
                   load_image: Callable, prefix: str, epoch: int,
                   out_path: str, device="cuda",
                   log: Callable[[str], None] = print) -> List[np.ndarray]:
    """The proposals of checkpoint ``prefix``@``epoch``'s RPN over
    ``roidb`` on ``device`` (CUDA unless the caller asks for the CPU),
    pickled to ``out_path`` and returned."""
    model = load_model(cfg, prefix, epoch, device)
    props = generate_proposals(model, TestLoader(roidb, cfg, load_image),
                               cfg, device)
    with open(out_path, "wb") as f:
        pickle.dump(props, f, pickle.HIGHEST_PROTOCOL)
    log(f"dumped proposals for {len(props)} images (mean "
        f"{np.mean([len(p) for p in props]):.1f} per image) to {out_path}")
    return props


def main(argv=None) -> List[np.ndarray]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common_args(p, default_prefix="model/rpn")
    p.add_argument("--epoch", type=int, required=True)
    p.add_argument("--out", required=True, help="the proposal pickle")
    p.add_argument("--eval_set", action="store_true",
                   help="over the test roidb (no flips, no filter), for "
                        "tools/test_rcnn.py")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    imdb, roidb = load_gt_roidb(cfg, training=not args.eval_set,
                                synthetic=args.synthetic)
    return dump_proposals(cfg, roidb, imdb.load_image, args.prefix,
                          args.epoch, args.out, args.device,
                          log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
