"""Train the Fast R-CNN stage of the alternate schedule (stages 2 and 4)
on precomputed proposals.

Counterpart of ``mx_rcnn_tpu/tools/train_rcnn.py``: :func:`train_net`
with ``mode='rcnn'`` on the proposals that ``tools/test_rpn.py`` dumped
for the same training roidb (``--proposals``; the JAX package's pickles
load too), with the flags of ``tools/train_rpn.py``.

    python -m mx_rcnn_tpu_torch.tools.train_rcnn --network vgg \\
        --dataset PascalVOC --synthetic 8 --batch_images 2 \\
        --proposals model/rpn-proposals.pkl --prefix model/rcnn \\
        --end_epoch 1                                                 # card
"""

from __future__ import annotations

import argparse
from typing import Dict

from mx_rcnn_tpu_torch.tools.train_rpn import (load_proposals, run_stage,
                                               stage_args)
from mx_rcnn_tpu_torch.utils.device import resolve_device


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    stage_args(p, default_prefix="model/rcnn")
    p.add_argument("--proposals", required=True,
                   help="proposal pickle of tools/test_rpn.py (roidb "
                        "order, (k, 5) arrays)")
    args = p.parse_args(argv)
    resolve_device(args.device)       # before the pickle is read
    return run_stage(args, mode="rcnn",
                     proposals=load_proposals(args.proposals))


if __name__ == "__main__":
    main()
