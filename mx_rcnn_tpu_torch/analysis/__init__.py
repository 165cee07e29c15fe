"""Runtime analysis of the port: the lock sanitizer (``sanitizer.py``).

Counterpart of ``mx_rcnn_tpu/analysis/``, whose static linters
(graphlint, threadlint, configlint, persistlint, netlint) and wire
fuzzer read the JAX package's sources and are not ported.
"""
