"""Multi-process data-parallel training demonstration (and its launcher).

Counterpart of ``mx_rcnn_tpu/tools/multihost_demo.py``: N worker
processes, each standing for a host with one device, join one world
through ``parallel/multihost.py — initialize`` at ``tcp://coordinator``
(NCCL on a card, the default; gloo with ``--device cpu``), each loader
decodes its row shard of a seeded global batch of the tiny synthetic
set, and every worker trains the tiny Faster R-CNN end-to-end step
(kernels K1, K2 and K3 on a card) with its gradients and metrics
all-reduced, printing its loss at each step.  The launcher checks that
every worker reports the same loss at every step: the gradients were
really synchronised.  On cards, local worker i sees only card i
(``CUDA_VISIBLE_DEVICES``), as a host of one card would; fewer cards
than workers is an error.

Worker mode (one per process):
  python -m mx_rcnn_tpu_torch.tools.multihost_demo --process_id I \\
      --num_processes N [--coordinator HOST:PORT] [--steps K] \\
      [--device cpu]

Launcher mode (spawns N local workers, checks that their losses agree):
  python -m mx_rcnn_tpu_torch.tools.multihost_demo --launch N [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import re
import socket
import subprocess
import sys

LOSS_RE = re.compile(r"\[p(\d+)\] step (\d+) loss ([0-9.]+)")
WORLD_RE = re.compile(r"^\[p\d+\] rank .*$", re.M)
SIZE = (128, 160)


def demo_config():
    """The tiny network at 128x160, the JAX demo's proposal numbers, one
    image per worker."""
    from mx_rcnn_tpu_torch.config import generate_config

    return generate_config(
        "tiny", "synthetic", train__rpn_pre_nms_top_n=256,
        train__rpn_post_nms_top_n=64, train__batch_rois=32,
        train__max_gt_boxes=8, train__rpn_min_size=2, train__batch_images=1,
        bucket__scale=SIZE[0], bucket__max_size=SIZE[1],
        bucket__shapes=(SIZE, SIZE[::-1]))


def worker(args) -> None:
    import torch

    from mx_rcnn_tpu_torch.core.train import (make_train_step,
                                              setup_training, to_device)
    from mx_rcnn_tpu_torch.data.loader import AnchorLoader
    from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
    from mx_rcnn_tpu_torch.parallel import multihost
    from mx_rcnn_tpu_torch.parallel.dp import close_world, replicate
    from mx_rcnn_tpu_torch.utils.device import resolve_device

    torch.set_num_threads(1)
    device_type = resolve_device(args.device).type
    world = multihost.initialize(args.coordinator, args.num_processes,
                                 args.process_id, device_type=device_type)
    try:
        print(f"[p{world.rank}] {world.describe()}", flush=True)
        cfg = demo_config()
        # identical seed on every worker, then rank 0's state broadcast
        state = setup_training(cfg, world.device, seed=0,
                               steps_per_epoch=1000)
        replicate(state.model, state.optimizer, world)
        step = make_train_step(cfg, world=world)
        # the global batch is deterministic; each worker decodes its rows
        ds = SyntheticDataset("train", world.size, cfg.num_classes, SIZE)
        loader = AnchorLoader(ds.gt_roidb(), cfg, ds.load_image,
                              batch_images=world.size, shuffle=False,
                              seed=7, num_workers=0,
                              shard=(world.rank, world.size))
        batch = to_device(next(iter(loader)), world.device)
        for s in range(args.steps):
            loss = float(step(state, batch)["loss"])
            print(f"[p{world.rank}] step {s} loss {loss:.6f}", flush=True)
        print(f"[p{world.rank}] done", flush=True)
    finally:
        close_world(world)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(n: int, steps: int, device: str = "cuda") -> int:
    """Spawn ``n`` local worker processes on ``device`` (on cards, worker
    i on card i); check that every one reports the same loss at every
    step.  Returns the exit code (0: agreed)."""
    from mx_rcnn_tpu_torch.parallel.dp import local_devices

    devices = local_devices(device, n)
    cuda = devices[0].startswith("cuda")
    if cuda:
        # once here, not in every worker at its first step
        from mx_rcnn_tpu_torch import kernels

        kernels.build_all()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = visible.split(",") if visible else [str(i) for i in range(n)]
    port = _free_port()
    # every worker is on this host: gloo and NCCL's bootstrap bind the
    # loopback interface
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    procs, outs, ok = [], [], True
    try:
        for i in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "mx_rcnn_tpu_torch.tools.multihost_demo",
                 "--process_id", str(i), "--num_processes", str(n),
                 "--coordinator", f"localhost:{port}", "--steps", str(steps),
                 "--device", "cuda" if cuda else "cpu"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=dict(env, CUDA_VISIBLE_DEVICES=cards[i]) if cuda
                else env))
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
            ok = ok and p.returncode == 0
    finally:
        # joining the world is a barrier: one wedged worker blocks the
        # others, so none is left running
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    losses = {}
    for out in outs:
        for line in WORLD_RE.findall(out):
            print(line)
        for pid, s, loss in LOSS_RE.findall(out):
            losses.setdefault(int(s), {})[int(pid)] = float(loss)
    for s, by_pid in sorted(losses.items()):
        agree = len(by_pid) == n and len(set(by_pid.values())) == 1
        print(f"step {s}: losses {by_pid} "
              f"{'AGREE' if agree else 'MISMATCH'}")
        ok = ok and agree
    ok = ok and len(losses) == steps
    if not ok:
        for i, out in enumerate(outs):
            print(f"--- worker {i} output ---\n{out}")
    print("MULTIHOST DEMO:", "OK" if ok else "FAILED")
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--launch", type=int, default=None,
                   help="spawn N local workers and check that they agree")
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--num_processes", type=int, default=2)
    p.add_argument("--coordinator", default="localhost:19876")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: NCCL, one card a worker) or cpu "
                        "(gloo)")
    args = p.parse_args(argv)
    if args.launch:
        return launch(args.launch, args.steps, args.device)
    worker(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
