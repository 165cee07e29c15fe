"""Data-parallel training: one process per card, one gradient all-reduce
per optimizer step.

Counterpart of ``mx_rcnn_tpu/parallel/dp.py``.  The JAX step is one SPMD
program over a device mesh (``shard_map`` and ``lax.pmean``).  Here each
rank is a process of its own that owns one device and one rank of a
``torch.distributed`` group (NCCL on cards, gloo on the CPU): it decodes
only its rows of the global batch (``data/loader.py — set_shard``), runs
the unchanged train step on them, and :func:`all_reduce_mean_` averages
the gradients and the metrics over the world before the SGD update, as
the JAX step's ``pmean`` does (``mx_rcnn_tpu/core/train.py:449-451``).
Every rank then applies the same update, so the replicas stay
bit-identical, as the mesh's replicated state does.

- :class:`World`: rank, size, device and process group; ``World.single``
  is the world of one, without a group, that every caller gets by default;
- :func:`init_world` and :func:`close_world`;
- :func:`replicate` broadcasts rank 0's weights, buffers and momentum (the
  JAX ``replicate``), and :func:`check_replicas` holds every rank to one
  checksum;
- :func:`rank_seed`, the counterpart of ``fold_in(key, axis_index)``;
- :func:`launch` runs N local ranks in spawned processes (the counterpart
  of the tests' 8-virtual-device CPU mesh).

Stated differences from the JAX package:

- ``dcn_size``, the JAX ``device_mesh``'s (dcn, ici) factorisation, must
  divide the world and is recorded in the :class:`World`, but the
  all-reduce runs over the whole world and NCCL picks its own intra- and
  inter-node algorithm.  The result is the flat mesh's, as JAX's
  ``tests/test_parallel.py — test_hierarchical_dcn_mesh_matches_flat_mesh``
  pins for the two-level reduction.
- The JAX step cannot stop on one device alone.  Here each rank polls its
  own stop flag, so ``core/fit.py`` reduces the flags over the world after
  every step (:func:`any_rank`).
- ``make_dp_cached_step`` waits for ``data/device_cache.py``.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue as queue_mod
import shutil
import signal
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)
from urllib.parse import urlsplit

import torch
import torch.distributed as dist

Device = Union[str, torch.device]


@dataclass
class World:
    """This process's place in a data-parallel run: its ``rank`` of
    ``size``, the ``device`` it owns, the process ``group`` its tensors
    reduce over (None in a world of one) and ``control``, a group over
    host (CPU) tensors for decisions such as the stop flag (gloo; the
    world's own group when that is gloo already)."""

    rank: int
    size: int
    device: torch.device
    group: Any = None
    control: Any = None
    backend: Optional[str] = None
    dcn_size: int = 1

    @classmethod
    def single(cls, device: Device = "cpu") -> "World":
        """The world of one: every collective is a no-op."""
        return cls(0, 1, torch.device(device))

    @property
    def lead(self) -> bool:
        """Rank 0, the one that writes checkpoints and logs."""
        return self.rank == 0

    def barrier(self) -> None:
        if self.control is not None:
            dist.barrier(group=self.control)

    def describe(self) -> str:
        if self.group is None:
            return f"world of one on {self.device}"
        return (f"rank {self.rank} of {self.size} on {self.device}, "
                f"backend {self.backend}, dcn_size {self.dcn_size}")


def default_backend(device: Device) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_devices(device: Device, n: int,
                  devices: Optional[Sequence[Device]] = None) -> List[str]:
    """The devices of ``n`` local ranks (or eval slices): ``devices`` as
    given (a test rig may name one card twice), else the first ``n``
    cards, or the CPU ``n`` times when ``device`` is the CPU.  Fewer
    cards than ``n`` raise; nothing falls back to fewer or to the CPU."""
    from mx_rcnn_tpu_torch.utils.device import resolve_device

    if devices:
        return [str(d) for d in devices]
    if resolve_device(device).type == "cpu":
        return ["cpu"] * n
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"{n} CUDA devices wanted but "
                           f"torch.cuda.device_count() is {have}")
    return [f"cuda:{i}" for i in range(n)]


def init_world(rank: int, size: int, init_method: str,
               backend: Optional[str] = None, device: Device = "cuda",
               dcn_size: int = 1, timeout_s: float = 600.0) -> World:
    """Join the ``size``-rank group at ``init_method`` (``file://`` or
    ``tcp://host:port``) as ``rank``, owning ``device``.  ``backend``
    defaults to :func:`default_backend`; it is used as given and never
    swapped when it fails.  ``dcn_size`` must divide ``size`` (the JAX
    ``device_mesh`` refusal); it is recorded, not used to split the
    reduction (see the module docstring)."""
    from mx_rcnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
    if dcn_size < 1 or size % dcn_size:
        raise ValueError(f"{size} devices not divisible by "
                         f"dcn_size={dcn_size}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size,
                            timeout=timedelta(seconds=timeout_s))
    group = dist.group.WORLD
    control = group if backend == "gloo" else dist.new_group(
        backend="gloo", timeout=timedelta(seconds=timeout_s))
    return World(rank, size, dev, group, control, backend, dcn_size)


def close_world(world: World) -> None:
    if world.group is not None:
        dist.destroy_process_group()


def rank_seed(seed: int, rank: int) -> int:
    """The generator seed rank ``rank`` uses where the single-process step
    uses ``seed`` (a ``step_seed`` or ``microbatch_seed``, below 2**64):
    ``seed`` itself on rank 0, so a world of one draws what the
    single-process step draws; on every other rank ``seed`` XOR an odd
    multiple of the rank, which no other rank shares in all 64 bits nor
    in the low 32 (all that seeds the CPU generator).  The counterpart of
    the JAX step's ``fold_in(key, axis_index)``."""
    if rank == 0:
        return seed
    return seed ^ (rank * 0x9E3779B97F4A7C15) % 2 ** 64


def _packed(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).view(torch.uint8)
                      for t in tensors])


def _unpack_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel() * t.element_size()
            # a copy of the bytes, aligned for any dtype
            t.copy_(flat[offset:offset + n].clone().view(t.dtype)
                    .view_as(t))
            offset += n


def _state_tensors(model: torch.nn.Module, optimizer) -> List[torch.Tensor]:
    """Weights, buffers and momentum traces in name order, with the
    optimizer's update count as an int64 tensor on the model's device."""
    sd = model.state_dict()
    out = [sd[k] for k in sorted(sd)]
    if optimizer is not None:
        out += [optimizer.trace[k] for k in sorted(optimizer.trace)]
        out.append(torch.tensor([optimizer.count], dtype=torch.int64,
                                device=out[0].device))
    return out


def replicate(model: torch.nn.Module, optimizer, world: World) -> None:
    """Broadcast rank 0's weights, buffers (the frozen-BN statistics),
    momentum and update count to every rank, as one byte buffer; a no-op
    in a world of one.  The counterpart of the JAX ``replicate``."""
    if world.group is None:
        return
    tensors = _state_tensors(model, optimizer)
    flat = _packed(tensors)
    dist.broadcast(flat, src=0, group=world.group)
    _unpack_into(flat, tensors)
    if optimizer is not None:
        optimizer.count = int(tensors[-1].item())


def state_checksum(model: torch.nn.Module, optimizer) -> torch.Tensor:
    """One float64 sum per tensor of :func:`_state_tensors`, on the host."""
    return torch.stack([t.detach().double().sum()
                        for t in _state_tensors(model, optimizer)]).cpu()


def check_replicas(model: torch.nn.Module, optimizer, world: World) -> None:
    """Raise unless every rank holds the same weights, buffers, momentum
    and count, by :func:`state_checksum` (its maximum and minimum over
    the world must agree)."""
    if world.group is None:
        return
    local = state_checksum(model, optimizer)
    hi, lo = local.clone(), -local
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=world.control)
    dist.all_reduce(lo, op=dist.ReduceOp.MAX, group=world.control)
    bad = torch.nonzero(hi != -lo).flatten().tolist()
    if bad:
        raise RuntimeError(
            f"the replicas differ: {len(bad)} of {len(local)} state tensors "
            f"have different checksums across the {world.size} ranks "
            f"(first at position {bad[0]})")


def all_reduce_mean_(named_params: Sequence[Tuple[str, torch.nn.Parameter]],
                     metrics: Dict[str, torch.Tensor], world: World
                     ) -> Dict[str, torch.Tensor]:
    """Average the trained parameters' gradients and the ``metrics`` over
    the world with one ``all_reduce``, in place for the gradients; returns
    the averaged metrics.  Every rank packs the same layout: each
    parameter's fp32 gradient in name order (zeros where a rank's
    ``.grad`` is None), then the metrics in key order.  A no-op in a world
    of one.  The JAX step's ``lax.pmean`` of gradients and metrics."""
    if world.group is None:
        return metrics
    named = sorted(named_params, key=lambda item: item[0])
    keys = sorted(metrics)
    with torch.no_grad():
        parts = [(p.grad if p.grad is not None else torch.zeros_like(p))
                 .reshape(-1).float() for _, p in named]
        parts += [metrics[k].detach().float().reshape(1).to(world.device)
                  for k in keys]
        flat = torch.cat(parts)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=world.group)
    flat.div_(world.size)
    offset = 0
    for _, p in named:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p).to(p.dtype)
        offset += n
    return dict(zip(keys, flat[offset:].unbind()))


def any_rank(flag: bool, world: World) -> bool:
    """True on every rank when ``flag`` is True on any rank (a MAX
    all-reduce over the host group); ``flag`` itself in a world of one."""
    if world.control is None:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=world.control)
    return bool(t.item())


# ---- the local launcher -----------------------------------------------------

def _torch_settings() -> Dict[str, Any]:
    """The launcher's numerics settings, which every rank adopts: the
    thread count, TF32 and cuDNN's algorithm choice."""
    return dict(threads=torch.get_num_threads(),
                matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
                cudnn_tf32=torch.backends.cudnn.allow_tf32,
                cudnn_deterministic=torch.backends.cudnn.deterministic,
                cudnn_benchmark=torch.backends.cudnn.benchmark)


def _adopt(settings: Dict[str, Any]) -> None:
    torch.set_num_threads(settings["threads"])
    torch.backends.cuda.matmul.allow_tf32 = settings["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = settings["cudnn_tf32"]
    torch.backends.cudnn.deterministic = settings["cudnn_deterministic"]
    torch.backends.cudnn.benchmark = settings["cudnn_benchmark"]


def loopback_env(init_method: str) -> Dict[str, str]:
    """The interface variables a rank meeting at ``init_method`` sets
    where its environment leaves them unset: the loopback interface for
    gloo and NCCL's bootstrap when every rank must be on this host (a
    ``file://`` store, or ``tcp://`` on localhost or 127.x), nothing for
    a ``tcp://`` coordinator elsewhere, whose ranks on other hosts reach
    this one only through the interface the libraries choose or the user
    names."""
    if init_method.startswith("file://"):
        local = True
    else:
        host = urlsplit(init_method).hostname or ""
        local = host in ("localhost", "::1") or host.startswith("127.")
    return dict.fromkeys(("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"),
                         "lo") if local else {}


def _rank_main(fn, rank, size, device, backend, init_method, dcn_size,
               settings, args, results) -> None:
    """A spawned rank: join the world, run ``fn(world, *args)`` and put
    (rank, True, result) or (rank, False, traceback) on ``results``."""
    for name, value in loopback_env(init_method).items():
        os.environ.setdefault(name, value)
    world = None
    try:
        _adopt(settings)
        world = init_world(rank, size, init_method, backend, device,
                           dcn_size)
        out = fn(world, *args)
        # by value: the queue's own pickler would share tensors through
        # file descriptors that close with this process
        payload = pickle.dumps(out, protocol=pickle.HIGHEST_PROTOCOL)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, payload))
    close_world(world)


def launch(fn: Callable, size: int, devices: Optional[Sequence[Device]] = None,
           backend: Optional[str] = None, init_method: Optional[str] = None,
           args: tuple = (), timeout_s: Optional[float] = 900.0,
           stop_flag: Optional[Callable[[], bool]] = None,
           dcn_size: int = 1, first_rank: int = 0,
           world_size: Optional[int] = None) -> List[Any]:
    """Run ``fn(world, *args)`` on ``size`` local ranks, each a process
    started with the ``spawn`` method (``fork`` after CUDA initialisation
    breaks), and return their results in rank order.  The ranks are
    ``first_rank ..`` of a world of ``world_size`` (``size`` by default);
    the other ranks of a larger world are another host's launch, meeting
    at the same ``tcp://`` ``init_method`` (``parallel/multihost.py``).

    ``devices[r]`` is local rank r's device (all ``'cpu'`` by default);
    ``backend`` defaults to :func:`default_backend` of rank 0's device;
    the group meets at ``init_method``, by default a ``file://`` store in
    a fresh temporary directory, so concurrent launches never collide
    (the ranks of a wholly local launch bind the loopback interface:
    :func:`loopback_env`).
    ``fn`` and ``args`` are pickled (``fn`` by its import path) and each
    result is pickled back: return host data.  The ranks adopt the
    launcher's thread count, TF32 and cuDNN settings.  When
    ``stop_flag()`` turns True, every live rank is sent SIGTERM once.

    A rank that raises makes ``launch`` raise with that rank's traceback,
    after the other ranks are killed; so does a rank that dies without a
    result, and every rank is killed when ``timeout_s`` (None: no limit)
    passes first."""
    devices = [str(d) for d in (devices or ["cpu"] * size)]
    if len(devices) != size:
        raise ValueError(f"{len(devices)} devices for {size} ranks")
    backend = backend or default_backend(devices[0])
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mx_rcnn_world_")
    init_method = init_method or f"file://{os.path.join(tmp, 'store')}"
    results = ctx.Queue()
    settings = _torch_settings()
    procs = [ctx.Process(target=_rank_main, name=f"rank{first_rank + r}",
                         args=(fn, first_rank + r, world_size or size,
                               devices[r], backend, init_method, dcn_size,
                               settings, args, results))
             for r in range(size)]
    out: Dict[int, Any] = {}
    deadline = time.monotonic() + (timeout_s or float("inf"))
    forwarded = False
    try:
        for p in procs:
            p.start()
        while len(out) < size:
            if stop_flag is not None and not forwarded and stop_flag():
                forwarded = True
                for p in procs:
                    if p.is_alive():
                        os.kill(p.pid, signal.SIGTERM)
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue_mod.Empty:
                dead = [p for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead and results.empty():
                    # a result put just before the exit may still be in
                    # the pipe: look once more before calling it lost
                    time.sleep(0.5)
                    if results.empty():
                        raise RuntimeError(
                            f"{dead[0].name} exited with code "
                            f"{dead[0].exitcode} without a result")
                if time.monotonic() > deadline:
                    missing = sorted(first_rank + r for r in range(size)
                                     if r not in out)
                    raise TimeoutError(f"ranks {missing} gave no result "
                                       f"within {timeout_s:.0f} s")
                continue
            if not ok:
                # a rank that died is why its peers' collectives failed
                time.sleep(0.5)
                lost = "".join(
                    f"{p.name} exited with code {p.exitcode} without a "
                    f"result; " for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0, 1))
                raise RuntimeError(f"{lost}rank {rank} of "
                                   f"{world_size or size} failed:\n{value}")
            out[rank - first_rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=max(min(deadline - time.monotonic(), 600.0),
                               30.0))
        hung = [p.name for p in procs if p.exitcode != 0]
        if hung:
            raise RuntimeError(f"{hung} did not exit cleanly after their "
                               f"results")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(size)]
