"""Is ``tools/quant_smoke.py``'s run reproducible on the card?

Trains the smoke's recipe (the tiny network on 64 synthetic images, 6
epochs, seed 0) twice with the card's default algorithms in full fp32,
twice with them and TF32 on (PyTorch's default for cuDNN), and twice
under :func:`quant_smoke.reproducible` (full fp32), and prints a hash of
each checkpoint's weights; then runs the whole smoke (training, fp, int8
and 2-bit evals) twice with the default algorithms in full fp32 and
twice under :func:`quant_smoke.reproducible`, and prints its mAPs.
Card only.

    python -m mx_rcnn_tpu_torch.tools.repro_probe [--out probe.json]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import tempfile
import time

import torch

from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.tools import quant_smoke
from mx_rcnn_tpu_torch.tools.train import train_net
from mx_rcnn_tpu_torch.utils.checkpoint import load_model

NUM_IMAGES, EPOCHS = 64, 6


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in cuDNN's convolutions and in matmuls on or off for the
    body; the caller's settings after."""
    was = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = was


def mode(arm: str):
    return {"fp32": lambda: tf32(False), "tf32": lambda: tf32(True),
            "deterministic": quant_smoke.reproducible}[arm]()


def weights_hash(workdir: str, arm: str, dev) -> str:
    """Train the smoke's recipe in ``workdir`` under ``arm``; sha256 of
    the final checkpoint's state dict (names and bytes, in name
    order)."""
    cfg = quant_smoke._cfg(workdir)
    prefix = os.path.join(workdir, "model", "e2e")
    with mode(arm):
        train_net(cfg, prefix=prefix, end_epoch=EPOCHS, seed=0,
                  dataset_kw={"num_images": NUM_IMAGES}, device=dev,
                  log=lambda line: None)
    h = hashlib.sha256()
    for name, t in sorted(load_model(cfg, prefix, EPOCHS,
                                     dev).state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the records here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("repro_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    kernels.build_all()
    root = tempfile.mkdtemp(prefix="repro_probe_")
    recs = []
    try:
        for i, arm in enumerate(("fp32", "fp32", "tf32", "tf32",
                                 "deterministic", "deterministic")):
            t0 = time.perf_counter()
            h = weights_hash(os.path.join(root, f"train{i}"), arm, dev)
            recs.append(dict(kind="train", arm=arm, hash=h,
                             s=round(time.perf_counter() - t0, 2)))
            print(json.dumps(recs[-1]), flush=True)
        for i, arm in enumerate(("fp32", "fp32", "deterministic",
                                 "deterministic")):
            t0 = time.perf_counter()
            with mode(arm):  # run_smoke is _run_smoke under reproducible
                ev = quant_smoke._run_smoke(os.path.join(root, f"smoke{i}"),
                                            NUM_IMAGES, EPOCHS, dev)
            recs.append(dict(
                kind="smoke", arm=arm,
                s=round(time.perf_counter() - t0, 2),
                **{k: ev[k] for k in ("mAP_fp", "mAP_int8",
                                      "mAP_redteam_2bit", "quant_delta")}))
            print(json.dumps(recs[-1]), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
