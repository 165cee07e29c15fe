"""The port's kernel handles under many threads, on the CPU without nvcc.

The serving engine launches from one dispatcher thread per bucket and the
HTTP server from one handler thread per connection: a cold kernel must be
built and loaded once whichever threads reach it together, and launch
counts must not lose an increment.
"""

import sys
import threading
import time

import pytest

from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.kernels import CudaKernel

THREADS = 8


def _kernel():
    return CudaKernel("stub", "nms_sweep.cu", "stub_launch", [],
                      replaces="nowhere")


@pytest.fixture
def fast_switching():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _run_together(target, n=THREADS):
    start = threading.Barrier(n)

    def body(i):
        start.wait(timeout=10)
        target(i)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)


def test_a_cold_kernel_builds_once_under_concurrent_first_callers(
        monkeypatch, fast_switching):
    k = _kernel()
    builds, loads = [], []

    def start_build():
        builds.append(threading.get_ident())
        time.sleep(0.05)           # a slow nvcc start
        return "started"

    def finish_build(started):
        assert started == "started"
        time.sleep(0.05)           # a slow compile

    def load():
        loads.append(object())
        return loads[-1]

    monkeypatch.setattr(k, "start_build", start_build)
    monkeypatch.setattr(k, "finish_build", finish_build)
    monkeypatch.setattr(k, "_load", load)
    got = [None] * THREADS

    def call(i):
        got[i] = k.fn()

    _run_together(call)
    assert len(builds) == 1 and len(loads) == 1
    assert all(f is loads[0] for f in got)
    assert k.fn() is loads[0] and len(builds) == 1


def test_launch_counts_are_exact_under_threads(fast_switching):
    k = _kernel()
    k._fn = lambda *args: 0        # a stub entry point that always launches

    def launch(_):
        for _ in range(1000):
            k.launch()

    _run_together(launch)
    assert k.launches == THREADS * 1000


def test_a_failed_launch_is_not_counted():
    k = _kernel()
    k._fn = lambda *args: 700      # a CUDA error code
    with pytest.raises(RuntimeError, match="cudaError 700"):
        k.launch()
    assert k.launches == 0


def test_each_build_stages_into_a_file_of_its_own(monkeypatch, tmp_path):
    """Two builds of one library (two threads, or two processes) never
    share a staging file; a failed build removes its own."""
    k = _kernel()
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "false")
    first, second = k.start_build(), k.start_build()
    assert first[1] != second[1]
    assert first[1].parent == second[1].parent == tmp_path
    for started in (first, second):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            k.finish_build(started)
        assert not started[1].exists()
    assert not started[2].exists()


def test_reset_and_read_every_count():
    for k in kernels.KERNELS:
        k.launches = 3
    assert set(kernels.launch_counts().values()) == {3}
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {k.name: 0 for k in kernels.KERNELS}
