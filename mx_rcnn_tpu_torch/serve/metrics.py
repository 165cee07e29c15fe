"""Back-compat shim: the serving metrics live in
``mx_rcnn_tpu_torch/obs/metrics.py`` (one process-wide registry for
train, loader, snapshot and serve), as the JAX package's do in
``mx_rcnn_tpu/obs/metrics.py``.

Counterpart of ``mx_rcnn_tpu/serve/metrics.py``: the same classes under
the same module path, each the very object ``obs/metrics.py`` defines.
``LoweringCounter`` is not here: the port counts kernel builds with
``kernels.load_events`` instead of XLA lowerings.  New code should
import from ``mx_rcnn_tpu_torch.obs.metrics``.
"""

from __future__ import annotations

from mx_rcnn_tpu_torch.obs.metrics import (Histogram, Registry,  # noqa: F401
                                           ServeMetrics)
