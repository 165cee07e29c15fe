"""Observability of the port: the metrics registry (``obs/metrics.py``).

Counterpart of ``mx_rcnn_tpu/obs/``; only its metrics are ported so far.
"""
