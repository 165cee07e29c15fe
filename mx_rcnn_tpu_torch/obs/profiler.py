"""On-demand ``torch.profiler`` windows, rolled up into device ms.

Counterpart of ``mx_rcnn_tpu/obs/profiler.py``, with ``torch.profiler``
(Kineto, CUPTI on the card) where the JAX package opens ``jax.profiler``
windows and reads their xplane (``mx_rcnn_tpu/utils/xplane.py``).  Two
triggers, one mechanism:

* **config** — ``obs.profile_at_step=N`` makes the fit loop capture an
  ``obs.profile_steps``-step window after global step N
  (:class:`StepProfiler`, wired in ``core/fit.py``);
* **signal** — :func:`install_sigusr2` arms a live process: the first
  ``SIGUSR2`` opens a window, the second closes it (``kill -USR2 <pid>``
  twice).  The handler only sets a flag; the thread that runs the work
  opens and closes the window at its next safe point
  (:func:`poll_sigusr2`).

Each window writes ``<host>_<pid>.pt.trace.json`` (Kineto's chrome
trace) and ``rollup.json`` beside it, :func:`rollup`'s tables in device
ms: ``by_scope`` groups the device time by the stage that launched it,
``by_op_class`` by what ran.  Stages are ``torch.profiler.
record_function`` ranges opened by :func:`scope` (``backbone``,
``proposal``, ``roi_align``, ``head``, ``postprocess`` in the forward;
``loss``, ``backward``, ``optimizer`` in the train step) only while a
window is open, so outside one ``scope`` costs one flag read.  A kernel
belongs to the innermost range that holds its launch: on the launching
thread, else (the autograd engine's thread, whose launches the
``backward`` range waits for) on any thread.  Op classes: one per hand
kernel by its CUDA name (:data:`KERNEL_NAMES`, which ``chip_smoke.py``'s
trace tables read too), then ``gemm_conv``, ``elementwise``, ``copies``
and ``other``.  A window on the CPU has no device events: its tables hold
the host ops, top-level ones by class, each range's wall time by scope.

One window at a time: :func:`start_window` refuses, with a log line,
while another is open or while another ``torch.profiler`` runs (the fit
loop's ``--profile_dir`` trace).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import signal
import socket
import threading
from typing import Callable, Dict, List, Optional

from mx_rcnn_tpu_torch.obs.trace import _NULL as _NULL_SPAN

logger = logging.getLogger("mx_rcnn_tpu_torch")

# each hand kernel's CUDA functions as a profiler trace names them (K3 by
# its prefix: its tables pass and its walk; K5/K6 by qconv_kernel, which
# also names its widening pass)
KERNEL_NAMES = {"k1_mask": "nms_mask_kernel", "k1_reduce": "nms_reduce_kernel",
                "k2": "roi_align_fwd_kernel", "k3": "roi_align_bwd",
                "k3_tables": "roi_align_bwd_tables_kernel",
                "k4": "quantize_act_kernel", "k5_k6": "qconv_kernel"}

# the rollup's op classes of the hand kernels, first match wins
KERNEL_CLASSES = (
    ("K1 nms_mask_kernel", "nms_mask_kernel"),
    ("K1 nms_reduce_kernel", "nms_reduce_kernel"),
    ("K2 roi_align_fwd_kernel", "roi_align_fwd_kernel"),
    ("K3 roi_align_bwd_tables_kernel", "roi_align_bwd_tables_kernel"),
    ("K3 roi_align_bwd_kernel", "roi_align_bwd_kernel"),
    ("K4 quantize_act_kernel", "quantize_act_kernel"),
    ("K5/K6 qconv_kernel", "qconv_kernel"))

# the stages scope() names, in a step's order
SCOPES = ("loss", "backbone", "proposal", "roi_align", "head",
          "postprocess", "backward", "optimizer")

_GEMM_CONV = ("gemm", "conv", "cutlass", "cudnn", "xmma", "wgrad", "dgrad",
              "aten::mm", "aten::bmm", "aten::addmm", "aten::linear",
              "aten::matmul")
_HOST_ELEMENTWISE = frozenset((
    "aten::add", "aten::sub", "aten::mul", "aten::div", "aten::relu",
    "aten::clamp", "aten::where", "aten::maximum", "aten::minimum",
    "aten::exp", "aten::log", "aten::neg", "aten::abs", "aten::sqrt"))


def is_copy(name: str) -> bool:
    """A copy (the trace's ``Memcpy`` rows; a memset counts as other)."""
    return "Memcpy" in name


def is_elementwise(name: str) -> bool:
    """PyTorch's elementwise kernels (casts, BN's multiply and add,
    ReLU, adds)."""
    return "elementwise_kernel" in name


def op_class(name: str) -> str:
    """The rollup's op class of a device (or host) op name."""
    for cls, key in KERNEL_CLASSES:
        if key in name:
            return cls
    if is_copy(name) or "aten::copy_" in name or "aten::_to_copy" in name:
        return "copies"
    if is_elementwise(name) or name.rstrip("_") in _HOST_ELEMENTWISE:
        return "elementwise"
    low = name.lower()
    if any(k in low for k in _GEMM_CONV):
        return "gemm_conv"
    return "other"


# ---------------------------------------------------------------------------
# scopes
# ---------------------------------------------------------------------------

_scopes_on = False


def scope(name: str):
    """``with scope("backbone"):`` — a ``record_function`` range while a
    window is open, a shared no-op otherwise (one flag read)."""
    if not _scopes_on:
        return _NULL_SPAN
    import torch

    return torch.profiler.record_function(name)


# ---------------------------------------------------------------------------
# rollup
# ---------------------------------------------------------------------------

def newest_trace(trace_dir: str) -> Optional[str]:
    """The newest ``*.pt.trace.json`` under ``trace_dir``, any depth."""
    found = glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"),
                      recursive=True)
    return max(found, key=os.path.getmtime) if found else None


# a long window over a fast loop writes hundreds of MB; the inline parse
# skips such a trace and says so
MAX_ROLLUP_BYTES = 256 << 20

_DEVICE_CATS = frozenset(("kernel", "gpu_memcpy", "gpu_memset"))
_LAUNCH_CATS = frozenset(("cuda_runtime", "cuda_driver"))


def _innermost(ranges: List[dict], ts: float, tid=None) -> Optional[str]:
    best = None
    for r in ranges:
        if (tid is None or r["tid"] == tid) and \
                r["ts"] <= ts <= r["ts"] + r["dur"] and \
                (best is None or r["dur"] < best["dur"]):
            best = r
    return None if best is None else best["name"]


def _top_level(ops: List[dict]) -> List[dict]:
    """The ops not nested in another op of their thread."""
    out = []
    by_tid: Dict = {}
    for e in ops:
        by_tid.setdefault(e.get("tid"), []).append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        end = -1.0
        for e in evs:
            if e["ts"] >= end:
                out.append(e)
                end = e["ts"] + e.get("dur", 0.0)
    return out


def rollup_events(doc: Dict) -> Dict:
    """:func:`rollup`'s tables from a parsed chrome trace."""
    evs = [e for e in doc.get("traceEvents", [])
           if e.get("ph") == "X" and "ts" in e]
    ranges = [e for e in evs if e.get("cat") == "user_annotation"
              and e.get("name") in SCOPES]
    device = [e for e in evs if e.get("cat") in _DEVICE_CATS]
    by_scope: Dict[str, float] = {}
    by_class: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    if device:
        launches = {}
        for e in evs:
            if e.get("cat") in _LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = e
        dev_name = "cuda:%s" % (device[0].get("args") or {}).get("device", 0)
        for e in device:
            ms = float(e.get("dur", 0.0)) / 1e3
            cls = op_class(e.get("name", ""))
            by_class[cls] = by_class.get(cls, 0.0) + ms
            calls[cls] = calls.get(cls, 0) + 1
            launch = launches.get((e.get("args") or {}).get("correlation"))
            where = None
            if launch is not None:
                where = (_innermost(ranges, launch["ts"], launch.get("tid"))
                         or _innermost(ranges, launch["ts"]))
            where = where or "(unscoped)"
            by_scope[where] = by_scope.get(where, 0.0) + ms
    else:
        dev_name = "cpu"
        for e in _top_level([e for e in evs if e.get("cat") == "cpu_op"]):
            ms = float(e.get("dur", 0.0)) / 1e3
            cls = op_class(e.get("name", ""))
            by_class[cls] = by_class.get(cls, 0.0) + ms
            calls[cls] = calls.get(cls, 0) + 1
        for r in ranges:
            by_scope[r["name"]] = (by_scope.get(r["name"], 0.0)
                                   + float(r.get("dur", 0.0)) / 1e3)
    order = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))  # noqa: E731
    return {"device": dev_name, "device_ms": sum(by_class.values()),
            "by_scope": order(by_scope), "by_op_class": order(by_class),
            "op_class_calls": calls}


def rollup(trace: str) -> Dict:
    """Device-time tables of a window's chrome trace (a file, or the
    newest under a directory): ``{"trace": path, "device", "device_ms",
    "by_scope": {scope: ms}, "by_op_class": {class: ms},
    "op_class_calls": {class: n}}``.  Empty when there is no trace; a
    trace over :data:`MAX_ROLLUP_BYTES` is not parsed (``"skipped"``
    says why)."""
    path = trace if os.path.isfile(trace) else newest_trace(trace)
    if path is None:
        return {}
    size = os.path.getsize(path)
    if size > MAX_ROLLUP_BYTES:
        note = (f"trace is {size >> 20} MB (> {MAX_ROLLUP_BYTES >> 20} MB "
                f"inline cap): keep windows short, or roll it up offline "
                f"with obs.profiler.rollup_events")
        logger.warning("obs profiler: %s", note)
        return {"trace": path, "skipped": note, "by_scope": {},
                "by_op_class": {}}
    with open(path) as f:
        doc = json.load(f)
    return {"trace": path, **rollup_events(doc)}


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_active: Optional[Dict] = None


def _launch_counts() -> Dict[str, int]:
    from mx_rcnn_tpu_torch import kernels

    return kernels.launch_counts()


def start_window(out_dir: str) -> bool:
    """Open a window writing into ``out_dir``.  Refuses (False and a log
    line) while a window is open or the profiler is busy: a profiling
    hiccup must never kill the process it observes."""
    global _active, _scopes_on
    with _lock:
        if _active is not None:
            logger.warning("obs profiler: window already open (%s)",
                           _active["dir"])
            return False
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            if torch._C._autograd._profiler_enabled():
                raise RuntimeError("another torch.profiler is running")
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(out_dir, exist_ok=True)
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:
            logger.warning("obs profiler: could not start window: %s", e)
            return False
        _active = {"dir": out_dir, "prof": prof,
                   "launches": _launch_counts()}
        _scopes_on = True
    logger.info("obs profiler: window started -> %s", out_dir)
    return True


def window_open() -> bool:
    return _active is not None


def stop_window(sync: Callable[[], None] = None) -> Dict:
    """Close the open window, write its trace and ``rollup.json`` and
    return the rollup, with ``launch_counts``: each hand kernel's
    launches inside the window (``kernels.launch_counts``).  ``sync``
    (a device synchronise) runs first, so that work in flight lands in
    the window."""
    global _active, _scopes_on
    with _lock:
        if _active is None:
            return {}
        win, _active = _active, None
        _scopes_on = False
        try:
            if sync is not None:
                sync()
            win["prof"].stop()
            path = os.path.join(win["dir"], f"{socket.gethostname()}_"
                                f"{os.getpid()}.pt.trace.json")
            win["prof"].export_chrome_trace(path)
        except Exception as e:
            logger.warning("obs profiler: could not stop window: %s", e)
            return {}
    after = _launch_counts()
    roll = rollup(path)
    roll["launch_counts"] = {k: after[k] - win["launches"].get(k, 0)
                             for k in after}
    try:
        with open(os.path.join(win["dir"], "rollup.json"), "w") as f:
            json.dump(roll, f, indent=1)
    except OSError as e:
        logger.warning("obs profiler: rollup write failed: %s", e)
    _log_rollup(roll)
    logger.info("obs profiler: window closed -> %s (rollup.json)",
                win["dir"])
    return roll


def _log_rollup(roll: Dict, top: int = 10) -> None:
    total = roll.get("device_ms") or 0.0
    if not total:
        return
    logger.info("obs profiler: %s time by op class (total %.3f ms):",
                roll.get("device"), total)
    for g, ms in list(roll.get("by_op_class", {}).items())[:top]:
        logger.info("  %-36s %9.3f ms  %5.1f%%", g, ms, 100 * ms / total)
    for g, ms in list(roll.get("by_scope", {}).items())[:top]:
        logger.info("  scope %-30s %9.3f ms  %5.1f%%", g, ms,
                    100 * ms / total)


class StepProfiler:
    """The fit loop's config-triggered window: opens after global step
    ``at_step``, covers the next ``steps`` steps, rolls up, and is inert
    otherwise.  ``on_step`` is called once per step with the global
    step count and a ``sync`` thunk."""

    def __init__(self, out_dir: str, at_step: int, steps: int = 3):
        self.out_dir = out_dir
        self.at_step = at_step
        self.steps = max(int(steps), 1)
        self._started = False
        self._done = False
        self._stop_at = None
        self.result: Dict = {}

    def on_step(self, step: int, sync: Callable[[], None] = None) -> None:
        if self._done or self.at_step <= 0:
            return
        if not self._started and step >= self.at_step:
            self._started = start_window(self.out_dir)
            self._done = not self._started
            self._stop_at = step + self.steps
        elif self._started and step >= self._stop_at:
            self.result = stop_window(sync)
            self._done = True

    def close(self, sync: Callable[[], None] = None) -> None:
        """The loop ended with the window open (a run shorter than
        ``at_step + steps``): close it now."""
        if self._started and not self._done:
            self.result = stop_window(sync)
            self._done = True


_sigusr2 = {"pending": False, "dir": None, "open": False, "n": 0}


def install_sigusr2(out_dir: str) -> Callable:
    """Arm SIGUSR2 as a window toggle: the first signal asks for a window
    under ``out_dir/sigusr2-<n>``, the next for its close and rollup.
    Returns the installed handler.

    The handler only sets a flag: starting or stopping a profiler inside
    it can deadlock on the locks the interrupted frame holds.  Nor can a
    worker thread take the toggle, as the JAX package's does: a
    ``torch.profiler`` window records the host side of the thread that
    opened it, and must be closed there.  So the thread that runs the
    work opens and closes it at its next safe point,
    :func:`poll_sigusr2`: the fit loop after each step, the serving
    front end in its poll loop (a window opened there records every
    thread's device work and launches, and its own host ops)."""
    _sigusr2["dir"] = out_dir

    def handler(signum, frame):
        _sigusr2["pending"] = True

    signal.signal(signal.SIGUSR2, handler)
    logger.info("obs profiler: SIGUSR2 armed (kill -USR2 %d to toggle a "
                "profile window under %s)", os.getpid(), out_dir)
    return handler


def poll_sigusr2(sync: Callable[[], None] = None) -> None:
    """Open or close the window a SIGUSR2 asked for (one flag read when
    none did).  Fails soft."""
    if not _sigusr2["pending"]:
        return
    _sigusr2["pending"] = False
    try:
        if not _sigusr2["open"]:
            d = os.path.join(_sigusr2["dir"], f"sigusr2-{_sigusr2['n']}")
            _sigusr2["open"] = start_window(d)
        else:
            stop_window(sync)
            _sigusr2["open"] = False
            _sigusr2["n"] += 1
    except Exception:  # pragma: no cover - belt and braces
        logger.exception("obs profiler: SIGUSR2 toggle failed")
