"""Rank functions of ``tests/test_torch_parallel.py``'s spawned worlds.

A spawned rank imports this module by name, so it imports the port and
never JAX: the JAX step's draws reach the ranks as numpy arrays, keyed
by (site, image), and every rank returns host data.
"""

import hashlib
import os
import sys
import time

import torch
import torch.distributed as dist

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.parallel.dp import (World, all_reduce_mean_,
                                           replicate)

CPU = torch.device("cpu")
# the tiny network on 128x160 canvases, the JAX dry run's proposal
# numbers, one image per rank
SMALL = dict(train__rpn_pre_nms_top_n=256, train__rpn_post_nms_top_n=64,
             train__batch_rois=32, train__max_gt_boxes=8,
             train__rpn_min_size=2, train__batch_images=1,
             bucket__scale=128, bucket__max_size=160,
             bucket__shapes=((128, 160), (160, 128)))
SIZE = (128, 160)


def small_config(**over):
    return generate_config("tiny", "synthetic", **{**SMALL, **over})


def replayed(recorded):
    """A ``draws`` function that returns recorded uniforms."""
    return lambda site, image, shape: torch.from_numpy(
        recorded[(site, image)])


def state_sha(state) -> str:
    """SHA-256 over the bytes of every weight, buffer and momentum trace,
    in name order."""
    h = hashlib.sha256()
    sd = state.model.state_dict()
    for k in sorted(sd):
        h.update(sd[k].detach().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    for k in sorted(state.optimizer.trace):
        h.update(state.optimizer.trace[k].contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _copy(sd):
    return {k: v.detach().clone() for k, v in sd.items()}


def parity_world(world: World, spec: dict) -> dict:
    """Everything a two-rank world checks, each from a fresh state:

    - ``jax{1,2}``: one step at grad_accum 1 and 2 on this rank's rows
      with the JAX DP step's draws (``spec['jax']``);
    - ``local_grads`` / ``mean_grads``: one backward, then
      ``all_reduce_mean_``;
    - ``sha`` and ``first_draws``: three steps with the default draws;
    - ``stopped_at``: ``train_net`` in this world, whose stop flag fires
      on rank 1 alone at its ``spec['stop_poll']``-th poll."""
    out = {"jax_loaded": "jax" in sys.modules}
    cfg = small_config()
    for ga, (rows, draws) in spec["jax"].items():
        model = build_model(cfg, "cpu", seed=2, train=True)
        state = ttrain.init_state(model, cfg, 2, base_lr=0.01)
        step = ttrain.make_train_step(cfg, grad_accum=ga, world=world)
        mbs = [ttrain.to_device(b, CPU) for b in rows[world.rank]]
        fns = [replayed(d) for d in draws[world.rank]]
        metrics = step(state, mbs[0] if ga == 1 else mbs,
                       draws=fns[0] if ga == 1 else fns)
        out[f"jax{ga}"] = dict(params=_copy(model.state_dict()),
                               metrics={k: float(v)
                                        for k, v in metrics.items()},
                               step=state.step)

    rows, draws = spec["jax"][1]
    model = build_model(cfg, "cpu", seed=2, train=True)
    state = ttrain.init_state(model, cfg, 2, base_lr=0.01)
    total, _ = ttrain.loss_and_metrics(
        model, ttrain.to_device(rows[world.rank][0], CPU), cfg,
        replayed(draws[world.rank][0]))
    total.backward()
    out["local_grads"] = {n: p.grad.clone() for n, p in
                          state.optimizer.params}
    all_reduce_mean_(state.optimizer.params, {}, world)
    out["mean_grads"] = {n: p.grad.clone() for n, p in
                         state.optimizer.params}

    first = []
    plain = ttrain.generator_draws

    def recording(generator):
        fn = plain(generator)

        def draw(site, image, shape):
            u = fn(site, image, shape)
            if not first:
                first.append(u.clone())
            return u
        return draw

    ttrain.generator_draws = recording
    try:
        state = ttrain.setup_training(cfg, "cpu", seed=0, steps_per_epoch=3)
        replicate(state.model, state.optimizer, world)
        step = ttrain.make_train_step(cfg, world=world)
        for s in range(3):
            step(state, ttrain.to_device(spec["steps"][s][world.rank], CPU))
    finally:
        ttrain.generator_draws = plain
    out["sha"] = state_sha(state)
    out["first_draws"] = first[0].numpy()

    from mx_rcnn_tpu_torch.tools.train import train_net

    polls = [0]

    def stop_on_rank1():
        polls[0] += 1
        return world.rank == 1 and polls[0] >= spec["stop_poll"]

    state, _ = train_net(cfg, world=world, prefix=spec["prefix"],
                         synthetic=4, end_epoch=3, lr=0.01, device="cpu",
                         stop_flag=stop_on_rank1, log=lambda line: None)
    out["stopped_at"] = state.step
    return out


def dcn_world(world: World, rows) -> dict:
    """One step in this world (``dcn_size`` recorded) and one from the
    same state in the flat world of the same ranks: their states'
    hashes."""
    import dataclasses

    cfg = small_config()
    state = ttrain.setup_training(cfg, "cpu", seed=0, steps_per_epoch=3)
    replicate(state.model, state.optimizer, world)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    batch = ttrain.to_device(rows[world.rank], CPU)
    out = {}
    for name, w in (("dcn", world),
                    ("flat", dataclasses.replace(world, dcn_size=1))):
        state.model.load_state_dict(start)
        for t in state.optimizer.trace.values():
            t.zero_()
        state.optimizer.count = 0
        metrics = ttrain.make_train_step(cfg, world=w)(state, batch)
        out[name] = (state_sha(state), float(metrics["loss"]))
    out["dcn_size"] = world.dcn_size
    return out


def failing_rank(world: World, how: str) -> None:
    """Rank 1 fails as ``how`` says; rank 0 waits in an all-reduce that
    rank 1 never joins."""
    if world.rank == 1:
        if how == "raise":
            raise ValueError("a planted failure on rank 1")
        if how == "exit":
            os._exit(3)
        time.sleep(3600)                     # "hang"
    dist.all_reduce(torch.zeros(1), group=world.group)


def rank_of(world: World) -> tuple:
    return world.rank, world.size, str(world.device), world.backend


def interface_env(world: World) -> dict:
    """The interface variables this rank ran with."""
    return {k: os.environ.get(k)
            for k in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME")}
