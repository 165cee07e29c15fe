"""Online detection serving of the port.

Counterpart of ``mx_rcnn_tpu/serve/``.  The single-engine tier:

* ``queue.py``  — bounded admission queues, deadlines, load shedding;
* ``engine.py`` — per-bucket micro-batching over ``Predictor`` and the
  eval's postprocess (K1 and K2 on the card);
* ``server.py`` — the stdlib JSON/HTTP front end (/detect /healthz
  /metrics);
* ``metrics.py`` — the back-compat shim over ``obs/metrics.py``.

Above it: ``export.py`` (the export store), ``bulk.py``, ``fleet.py``,
``remote.py`` and ``agent.py`` (the cross-host tier), ``scheduler.py``
and ``rollout.py``.  Entry points: ``python -m
mx_rcnn_tpu_torch.tools.serve`` (checkpoint → warm HTTP service) and
``python -m mx_rcnn_tpu_torch.tools.loadgen`` (closed and open loops,
one JSON record).
"""

from mx_rcnn_tpu_torch.obs.metrics import Histogram, ServeMetrics  # noqa: F401
from mx_rcnn_tpu_torch.serve.engine import ServingEngine  # noqa: F401
from mx_rcnn_tpu_torch.serve.queue import (BoundedQueue,  # noqa: F401
                                           DeadlineExceeded, RequestFailed,
                                           ServeRequest, ShedError)
from mx_rcnn_tpu_torch.serve.server import make_server  # noqa: F401
