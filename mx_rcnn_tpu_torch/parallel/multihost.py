"""Data parallelism across hosts: each host's cards are ranks of one world.

Counterpart of ``mx_rcnn_tpu/parallel/multihost.py``.  The JAX package
runs one process per host (``jax.distributed.initialize``) that drives
all of the host's devices; here every card is a process and a rank of
its own, and this module owns the map from (host ``process_id``, local
rank) to global rank: :func:`host_ranks` gives a host its share of the
world, which ``tools/train.py --coordinator .. --num_processes P
--process_id I`` spawns through ``dp.launch``, and :func:`initialize`
joins one such rank to the world at ``tcp://coordinator`` from a process
started by other means (``tools/multihost_demo.py``).

The JAX ``global_batch`` and ``replicate_global`` have no counterpart:
they assemble host-local shards into global arrays and lift host copies
into one replicated tree, while here each rank holds its own rows (its
loader's shard, or :func:`local_image_slice`) and its own replica (made
equal by ``dp.replicate``).  Nor does ``global_mesh``'s ``dcn_size``
default: ``dcn_size`` is recorded, not a level of the reduction
(``dp.py``), and a world joined here records 1.
"""

from __future__ import annotations

from typing import Optional

import torch

from mx_rcnn_tpu_torch.parallel.dp import World, init_world


def global_rank(process_id: int, local_rank: int, local_devices: int) -> int:
    """Host-major rank order, as ``jax.devices()`` orders a pod's
    devices: host ``process_id``'s cards are ranks ``process_id *
    local_devices ..``."""
    if not 0 <= local_rank < local_devices:
        raise ValueError(f"local rank {local_rank} out of range for "
                         f"{local_devices} local devices")
    return process_id * local_devices + local_rank


def _check_host(process_id: int, num_processes: int) -> None:
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id={process_id} out of range for "
                         f"{num_processes} processes")


def host_ranks(num_devices: int, num_processes: int,
               process_id: int) -> range:
    """The global ranks of host ``process_id`` in a world of
    ``num_devices`` ranks spread evenly over ``num_processes`` hosts."""
    _check_host(process_id, num_processes)
    if num_devices < 1 or num_devices % num_processes:
        raise ValueError(f"num_devices={num_devices} is not a multiple of "
                         f"num_processes={num_processes}")
    local = num_devices // num_processes
    return range(global_rank(process_id, 0, local),
                 global_rank(process_id, local - 1, local) + 1)


def initialize(coordinator: str, num_processes: int, process_id: int,
               local_devices: int = 1, local_rank: int = 0,
               backend: Optional[str] = None,
               device_type: str = "cuda") -> World:
    """Join the world of ``num_processes`` hosts with ``local_devices``
    ranks each, as local rank ``local_rank`` of host ``process_id``,
    meeting at ``tcp://coordinator`` (HOST:PORT; global rank 0 serves
    it).  The rank owns card ``local_rank`` (the CPU when ``device_type``
    is ``'cpu'``); ``backend`` defaults to NCCL on a card, gloo on the
    CPU."""
    _check_host(process_id, num_processes)
    device = (torch.device("cuda", local_rank) if device_type == "cuda"
              else torch.device(device_type))
    return init_world(global_rank(process_id, local_rank, local_devices),
                      num_processes * local_devices, f"tcp://{coordinator}",
                      backend, device)


def local_image_slice(batch, world: World):
    """This rank's rows ``[rank * per, (rank + 1) * per)`` of a global
    batch every rank assembled whole: each field of a ``Batch`` or
    ``RCNNBatch`` (numpy or tensors), or of each microbatch in a list.
    The fallback for a loader without shards, which decodes the whole
    batch on every rank; the training loaders own their rows
    (``data/loader.py — set_shard``) and decode 1/N of it."""
    if isinstance(batch, list):
        return [local_image_slice(b, world) for b in batch]
    n = len(batch[0])
    if n % world.size:
        raise ValueError(f"a batch of {n} images does not split over "
                         f"{world.size} ranks")
    per = n // world.size
    lo = world.rank * per
    return type(batch)(*(x[lo:lo + per] for x in batch))
