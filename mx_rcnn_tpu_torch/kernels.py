"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds).  Libraries land in
``mx_rcnn_tpu_torch/_build/`` under a name that hashes the source and the
flags, so an edited source is rebuilt and a stale library never loads.
Nothing is built at import time: :func:`build_all` (or the first launch
of a kernel) builds, and :func:`build_all` starts one ``nvcc`` per source
in parallel.

Every kernel keeps an integer launch count that its wrapper bumps once
per successful launch, and the same count per card
(:func:`launch_counts_by_device`: the card current at the launch, which
each wrapper sets to its tensors' card); :func:`reset_launch_counts`
zeroes them.
:func:`load_events` counts the libraries built and loaded in this
process, so a steady state can be checked to build and load nothing
(the JAX package's "zero new lowerings"); :meth:`CudaKernel.install`
places a library built elsewhere (an export store's) and loads it, so a
process can launch without ``nvcc``.  Many
threads may launch (the serving engine runs a dispatcher per bucket):
a kernel is built and loaded once, under its lock, whichever thread
reaches it first, each build writes a staging file of its own, and
counts are bumped under that same lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# libraries built (nvcc runs) and loaded (dlopen) in this process
_EVENTS = {"builds": 0, "loads": 0}
_EVENTS_LOCK = threading.Lock()


def _count(event: str) -> None:
    with _EVENTS_LOCK:
        _EVENTS[event] += 1


def load_events() -> Dict[str, int]:
    """How many kernel libraries this process has built and loaded."""
    with _EVENTS_LOCK:
        return dict(_EVENTS)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


class CudaKernel:
    """One ``csrc/`` source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: List, replaces: str,
                 extra_flags: Tuple[str, ...] = ()):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self.launches = 0
        self.launches_by_device: Dict[int, int] = {}
        self.build_log = ""
        self._fn = None
        # guards the one-time build and the counts; the fast path of
        # fn() takes no lock, so launches never wait on each other long
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(self.flags).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.name}-{digest[:16]}.so"

    def start_build(self) -> Optional[Tuple[subprocess.Popen, Path, Path]]:
        """Start ``nvcc`` unless the library is already built."""
        lib = self.library_path()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a staging name of this build's own: two threads or processes
        # building the same library never write one file
        fd, tmp = tempfile.mkstemp(prefix=lib.stem + ".", suffix=".tmp",
                                   dir=BUILD_DIR)
        os.close(fd)
        tmp = Path(tmp)
        cmd = [_nvcc(), *self.flags, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, lib

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp, lib = started
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for {self.source.name} "
                f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, lib)
        _count("builds")

    def fn(self):
        """The loaded C entry point, building the library on first use:
        once, whichever thread gets here first; the others wait for it."""
        fn = self._fn
        if fn is None:
            with self._lock:
                if self._fn is None:
                    self.finish_build(self.start_build())
                    self._fn = self._load()
                fn = self._fn
        return fn

    def install(self, blob: bytes) -> bool:
        """Place ``blob``, a library built elsewhere from these sources
        and flags (an export store's copy, ``serve/export.py``), where
        :meth:`fn` loads it, and load it: under the lock a build takes,
        so no thread launches from a half-written file.  Returns True if
        the file was placed, False if this process had it already."""
        lib = self.library_path()
        with self._lock:
            placed = not lib.exists()
            if placed:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # a staging file of its own, as a build writes: a failed
                # write leaves a stray .tmp, never a torn library
                fd, tmp = tempfile.mkstemp(prefix=lib.stem + ".",
                                           suffix=".tmp", dir=BUILD_DIR)
                with os.fdopen(fd, "wb") as f:
                    f.write(blob)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, lib)
            if self._fn is None:
                self._fn = self._load()
        return placed

    def _load(self):
        lib = ctypes.CDLL(str(self.library_path()))
        _count("loads")
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def launch(self, *args) -> None:
        """Call the C entry point (which launches on the given stream and
        returns ``cudaGetLastError()``); raise on a non-zero code, count
        the launch otherwise."""
        rc = self.fn()(*args)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {rc}")
        card = _current_card()
        with self._lock:
            self.launches += 1
            self.launches_by_device[card] = \
                self.launches_by_device.get(card, 0) + 1


def _current_card() -> int:
    """The current CUDA device's index; -1 where CUDA was never
    initialised (a stub entry point in a CPU test).  A wrapper launches on
    a card's tensors, so CUDA is up and torch loaded by then."""
    import torch

    return (torch.cuda.current_device() if torch.cuda.is_initialized()
            else -1)


NMS_SWEEP = CudaKernel(
    "nms_sweep", "nms_sweep.cu", "nms_sweep_launch",
    # boxes, alive, batch, k, thr, mask scratch, keep, stream
    [_P, _P, _I, _I, _F, _P, _P, _P],
    replaces="mx_rcnn_tpu/ops/nms_pallas.py:34",  # _sweep_kernel
    # the IoU test must round exactly like the reference: no contracted FMA
    extra_flags=("--fmad=false",))

ROI_ALIGN_FWD = CudaKernel(
    "roi_align_fwd", "roi_align_fwd.cu", "roi_align_fwd_launch",
    # feat, rois, out, is_bf16, n, r, h, w, c, ph, pw, sr, scale, stream
    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    replaces="mx_rcnn_tpu/ops/roi_align_pallas.py:94")  # _fwd_kernel

ROI_ALIGN_BWD = CudaKernel(
    "roi_align_bwd", "roi_align_bwd.cu", "roi_align_bwd_launch",
    # g, rois, dfeat, scratch, scratch bytes, is_bf16, n, r, h, w, c, ph,
    # pw, sr, scale, stream
    [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _I, _I, _I, _I,
     _F, _P],
    replaces="mx_rcnn_tpu/ops/roi_align_pallas.py:126")  # _bwd_kernel

# K4-K6 have no Pallas counterpart: the JAX package computes the
# quantizer and the quantized contraction with XLA; ``replaces`` names
# that code.  K4 also takes in the frozen BN and ReLU before the
# quantizer, which XLA fuses into the same loop.
QUANTIZE_ACT = CudaKernel(
    "quantize_act", "quantize.cu", "quantize_act_launch",
    # x, is_bf16, n, c, inv, shift, round_bf16, relu, out0, unit0, out1,
    # unit1, qmax, fp8, stream
    [_P, _I, ctypes.c_longlong, _I, _P, _P, _I, _I, _P, _P, _P, _P, _F, _I,
     _P],
    replaces="mx_rcnn_tpu/ops/quant.py:133")  # _quantize

# K5 and K6 replace the JAX package's XLA contraction with int32 / fp32
# accumulation (_accum); they are one source, qconv.cu, built twice
# (-DQCONV_FP8 picks the type, so each library holds only its own tiles,
# as ops/quant.py — qconv_plan picks them).  On the H100 they are bound by
# the tensor cores' rate (fc6, the deep 3x3s) or by bytes (the per-ROI
# 1x1s); the design keeps wgmma fed from a TMA / cp.async ring filled by a
# producer warpgroup.  K5 runs on the 8-bit tensor cores with exact int32
# sums.  K6 promotes every 32 deep into fp32 (__fadd_rn): the tensor
# cores' own sums keep fewer bits, for e4m3 even within one k32 step, so
# K6 widens e4m3 exactly to f16 and runs f16 wgmma.
# x, w, x_unit, w_unit, bias, out, out_bf16, n, h, w, c, oh, ow, cout, kh,
# kw, sh, sw, pt, pl, kp, route, bn, stages, w16 scratch, stream
_QCONV_ARGS = [_P, _P, _P, _P, _P, _P, _I] + [_I] * 17 + [_P, _P]

QCONV_S8 = CudaKernel(
    "qconv_s8", "qconv.cu", "qconv_s8_launch", _QCONV_ARGS,
    replaces="mx_rcnn_tpu/ops/quant.py:179",  # _accum, int8 native
    extra_flags=("-DQCONV_FP8=0",))

QCONV_E4M3 = CudaKernel(
    "qconv_e4m3", "qconv.cu", "qconv_e4m3_launch", _QCONV_ARGS,
    replaces="mx_rcnn_tpu/ops/quant.py:179",  # _accum, fp8
    extra_flags=("-DQCONV_FP8=1",))

KERNELS: Tuple[CudaKernel, ...] = (NMS_SWEEP, ROI_ALIGN_FWD, ROI_ALIGN_BWD,
                                   QUANTIZE_ACT, QCONV_S8, QCONV_E4M3)
BY_NAME: Dict[str, CudaKernel] = {k.name: k for k in KERNELS}


def build_all() -> Dict[str, str]:
    """Build every kernel, one ``nvcc`` per source started together, and
    load them; returns each kernel's compiler output."""
    started = [k.start_build() for k in KERNELS]
    errors = []
    for k, s in zip(KERNELS, started):
        # wait for every nvcc before raising, so none is left running
        try:
            k.finish_build(s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in KERNELS:
        k.fn()
    return {k.name: k.build_log for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        with k._lock:
            k.launches = 0
            k.launches_by_device = {}


def launch_counts() -> Dict[str, int]:
    out = {}
    for k in KERNELS:
        with k._lock:
            out[k.name] = k.launches
    return out


def launch_counts_by_device() -> Dict[str, Dict[int, int]]:
    """Each kernel's launches per card index."""
    out = {}
    for k in KERNELS:
        with k._lock:
            out[k.name] = dict(k.launches_by_device)
    return out
