"""PyTorch + CUDA port of the ``mx_rcnn_tpu`` Faster R-CNN detector.

A second package beside the JAX one, mirroring its layout (``ops/``,
``models/``, ``core/``, ``data/``, ``tools/``) so each module's
counterpart is easy to find.  It imports ``torch`` and never JAX or the
JAX package.  Public functions keep the JAX package's layouts (NHWC
images and pooled features, ``(N, H*W*A, ·)`` RPN outputs) so the two
can be compared like with like.

The Pallas kernels of the JAX package are hand-written CUDA kernels here
(``csrc/``, built at first use by :mod:`mx_rcnn_tpu_torch.kernels`).
Every kernel wrapper takes its plain PyTorch version for a CPU tensor and
launches the kernel, or raises, for a CUDA tensor.
"""
