"""The fleet simulator: the control plane judged at 100 hosts.

Counterpart of ``mx_rcnn_tpu/sim/``.  A discrete-event virtual-time
kernel (``kernel.py``) drives simulated hosts and replicas that carry
the agent plane's gauge surface (``cluster.py``); scenario generators
(``traffic.py``) shape demand and failures; the harness (``control.py``)
runs the port's own ``SchedulerPolicy``, ``HealthEngine``, ``jsq_key``,
``RestartPolicy`` and ``RolloutController`` (the real classes, fed
through the real ``Collector`` → ``TimeSeriesStore`` path, on a virtual
clock); ``score.py`` turns the outcome into lost requests, SLO-minutes
breached and capacity-seconds wasted.  It is host-only code: it imports
no model and touches no card.

``python -m mx_rcnn_tpu_torch.tools.sim`` is the policy gauntlet.
"""

from mx_rcnn_tpu_torch.sim.kernel import SimKernel, VirtualClock  # noqa: F401
