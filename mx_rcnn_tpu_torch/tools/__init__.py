"""Command-line entry points, and the dataset flags they share."""

from __future__ import annotations

import argparse


def dataset_args(p: argparse.ArgumentParser) -> None:
    """The dataset flags every training and eval CLI shares."""
    p.add_argument("--dataset", default="PascalVOC",
                   choices=["PascalVOC", "coco", "synthetic",
                            "synthetic_hard", "synthetic_stream"])
    p.add_argument("--image_set", default=None,
                   help="the dataset's image set ('+'-joined sets merge "
                        "for training); default: the preset's")
    p.add_argument("--root_path", default=None,
                   help="where the gt_roidb cache goes (default: data)")
    p.add_argument("--dataset_path", default=None,
                   help="the VOCdevkit or COCO directory (default: the "
                        "preset's)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="this many seeded synthetic images in place of the "
                        "dataset's files")


def dataset_overrides(args) -> dict:
    """``--root_path``/``--dataset_path`` as config overrides."""
    overrides = {}
    if args.root_path:
        overrides["dataset__root_path"] = args.root_path
    if args.dataset_path:
        overrides["dataset__dataset_path"] = args.dataset_path
    return overrides
