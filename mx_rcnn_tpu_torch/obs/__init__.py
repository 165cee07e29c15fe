"""The observability plane of the port: where a step or a request
spent its time, across training, data loading, checkpoints and serving.

Counterpart of ``mx_rcnn_tpu/obs/``, with the same names and layout:

* ``metrics.py``    — the process-wide :class:`Registry` (counters,
  gauges, log-bucket histograms), ``ServeMetrics`` and the stdlib
  ``/metrics`` exporter;
* ``trace.py``      — host spans (``with span("train.dispatch")``), the
  request trace context, chrome-trace export merged with the device
  events of a profiler window;
* ``profiler.py``   — ``torch.profiler`` windows (``obs.profile_at_step``
  or SIGUSR2), rolled up into device ms by stage and by op class, one
  class per hand kernel;
* ``runrec.py``     — run records: ``runs/<id>/events.jsonl`` and a
  ``summary.json``, and ``CliObs``, the CLIs' shared wiring;
* ``timeseries.py`` — the ring store sampling the registry (windowed
  rates, gauges, exact windowed percentiles);
* ``health.py``     — SLO rules over those windows → OK/WARN/CRITICAL on
  gauges, in the run record and on ``/healthz``;
* ``flightrec.py``  — the black box, dumped on a crash, SIGTERM, a lock
  watchdog trip or a CRITICAL verdict;
* ``collect.py``    — N registries (in process or over HTTP) merged into
  one labeled view.

Everything is off by default (``cfg.obs.enabled``); then the hot paths
pay one flag read (``tests/test_torch_obs.py`` pins it).
"""

from mx_rcnn_tpu_torch.obs.metrics import (Histogram,  # noqa: F401
                                           Registry, ServeMetrics,
                                           registry, start_metrics_server)
from mx_rcnn_tpu_torch.obs.runrec import RunRecord  # noqa: F401
from mx_rcnn_tpu_torch.obs.timeseries import (Sampler,  # noqa: F401
                                              TimeSeriesStore)
