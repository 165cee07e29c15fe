"""Data parallelism over ``torch.distributed``: one process per card.

Counterpart of ``mx_rcnn_tpu/parallel/``, whose gradient sync replaces the
reference's MXNet ``kvstore='device'``.  The JAX package runs one SPMD
program over a mesh; here each card is a process with one rank of a
process group, and the train step all-reduces its gradients once per
optimizer step (``dp.py``).  ``multihost.py`` maps hosts and their local
cards onto ranks; ``dryrun.py`` is the port's ``dryrun_multichip``.
"""

from mx_rcnn_tpu_torch.parallel.dp import (  # noqa: F401
    World,
    all_reduce_mean_,
    check_replicas,
    close_world,
    init_world,
    launch,
    make_dp_cached_step,
    rank_seed,
    replicate,
)
