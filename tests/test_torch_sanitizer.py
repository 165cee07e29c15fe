"""The port's runtime lock sanitizer (``analysis/sanitizer.py``), held
against the JAX package's on the same scenarios: a real two-thread order
inversion, strict mode's raise and unwind, the hold budget and the stall
watchdog with its trip listeners, the wrapping of the port's own locks
(and only those), arming from ``MXRCNN_THREAD_SANITIZER`` before the
CLIs import the package, and the single ``LOCKSAN_REPORT`` at exit.

Both sanitizers patch ``threading.Lock``; every test arms one at a time
and restores the raw factories.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from mx_rcnn_tpu.analysis import sanitizer as j_san
from mx_rcnn_tpu_torch.analysis import sanitizer as t_san

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=["port", "jax"])
def armed(request):
    """One package's sanitizer armed (not strict), reset, then disarmed;
    the raw factories are back afterwards."""
    san = t_san if request.param == "port" else j_san
    san.install(strict=False)
    san.reset()
    yield san
    san.reset()
    san._S.strict = False
    san._S.budget_ms = 0.0
    san._S.stall_s = 30.0
    san.uninstall()
    assert threading.Lock is t_san._RAW_LOCK is j_san._RAW_LOCK


def _inversion(san):
    a = san.SanLock(threading.Lock(), "LockA")
    b = san.SanLock(threading.Lock(), "LockB")
    first_done = threading.Event()

    def t1():
        with a:
            with b:
                pass
        first_done.set()

    def t2():
        first_done.wait(5)
        with b:
            with a:
                pass

    th1, th2 = threading.Thread(target=t1), threading.Thread(target=t2)
    th1.start(), th2.start()
    th1.join(5), th2.join(5)
    return san.report()


def test_catches_a_real_two_thread_inversion(armed):
    rep = _inversion(armed)
    assert len(rep["inversions"]) == 1, rep
    inv = rep["inversions"][0]
    assert inv["held"] == "LockB" and inv["acquired"] == "LockA"
    assert not armed.check_clean() and armed.check_problems()


def test_inversion_report_equals_jax():
    def run(san):
        san.install()
        san.reset()
        try:
            rep = _inversion(san)
        finally:
            san.reset()
            san.uninstall()
        strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                           if k not in ("site", "reverse_seen_at", "thread")}
        return ({k: v for k, v in rep.items() if k != "inversions"},
                [strip(i) for i in rep["inversions"]])

    t, j = run(t_san), run(j_san)
    t[0].pop("locks_wrapped"), j[0].pop("locks_wrapped")
    assert t == j


def test_strict_mode_raises_and_unwinds(armed):
    armed._S.strict = True
    a = armed.SanLock(threading.Lock(), "SA")
    b = armed.SanLock(threading.Lock(), "SB")
    with a:
        with b:
            pass
    with b:
        with pytest.raises(armed.SanitizerError):
            a.acquire()
        assert not a.locked()
    assert [name for _, name in armed._S.held()] == []


def test_strict_mode_on_a_reentrant_lock(armed):
    armed._S.strict = True
    a = armed.SanRLock(threading.RLock(), "RA")
    b = armed.SanLock(threading.Lock(), "RB")
    with a:
        with a:            # re-entry is no new edge
            with b:
                pass
    with b:
        with pytest.raises(armed.SanitizerError):
            a.acquire()
    assert a._depth == 0 and a._owner is None


def test_budget_violation_and_watchdog_trip(armed):
    trips = []
    armed.add_trip_listener(trips.append)
    try:
        armed._S.budget_ms = 30.0
        lk = armed.SanLock(threading.Lock(), "BudgetLock")
        with lk:
            time.sleep(0.06)
        assert armed.report()["budget_violations"][0]["lock"] == "BudgetLock"
        assert armed.check_clean()          # budgets are advisory
        armed._S.stall_s = 0.2
        holding, release = threading.Event(), threading.Event()

        def holder():
            with lk:
                holding.set()
                release.wait(5)

        th = threading.Thread(target=holder)
        tb = threading.Thread(target=lambda: lk.acquire() and lk.release())
        th.start()
        holding.wait(5)
        tb.start()
        deadline = time.monotonic() + 5
        while not trips and time.monotonic() < deadline:
            time.sleep(0.05)
        release.set()
        th.join(5), tb.join(5)
    finally:
        armed.remove_trip_listener(trips.append)
    assert trips and trips[0]["lock"] == "BudgetLock"
    assert not armed.check_clean()


def test_wraps_the_port_locks_and_only_those():
    """Armed, the port's queue, request and registry locks are born
    wrapped and keep their semantics; torch's and the standard
    library's stay raw."""
    import queue

    from mx_rcnn_tpu_torch.obs.metrics import Registry
    from mx_rcnn_tpu_torch.serve.queue import BoundedQueue, ServeRequest

    t_san.install(strict=True)
    t_san.reset()
    try:
        q = BoundedQueue(depth=4)
        assert type(q._cond._lock).__name__ == "SanRLock"
        req = ServeRequest(np.zeros((4, 4, 3), np.float32),
                           np.zeros(3, np.float32), (4, 4), None, 0.0)
        assert type(req._lock).__name__ == "SanLock"
        assert type(Registry().lock).__name__ == "SanRLock"
        assert q.offer(req)
        assert q.take_batch(max_n=1, max_delay_s=0.01) == [req]
        assert type(queue.Queue().mutex).__name__ != "SanLock"
        assert type(threading.Lock()).__name__ != "SanLock"   # test code
        assert t_san.check_clean(), t_san.report()
    finally:
        t_san.reset()
        t_san._S.strict = False
        t_san.uninstall()


def test_off_by_default_and_armed_from_the_environment(monkeypatch):
    assert not t_san.armed()
    assert threading.Lock is t_san._RAW_LOCK
    monkeypatch.setenv("MXRCNN_THREAD_SANITIZER", "0")
    assert t_san.maybe_install_from_env() is False
    monkeypatch.setenv("MXRCNN_THREAD_SANITIZER", "strict")
    monkeypatch.setenv("MXRCNN_LOCK_BUDGET_MS", "250")
    try:
        assert t_san.maybe_install_from_env() is True
        assert t_san.armed() and t_san._S.strict
        assert t_san._S.budget_ms == 250.0
    finally:
        t_san.reset()
        t_san._S.strict = False
        t_san._S.budget_ms = 0.0
        t_san.uninstall()
    assert threading.Lock is t_san._RAW_LOCK
    assert t_san.check_problems() == []      # unarmed: nothing to say


@pytest.mark.parametrize("cli", ["train", "serve", "loadgen"])
def test_clis_arm_before_the_package_allocates_locks(cli):
    """Each CLI arms first thing: the locks ``kernels.py`` allocates at
    import are born wrapped, and one ``LOCKSAN_REPORT`` line, clean,
    comes out at exit however many CLIs the process imported."""
    code = (f"import mx_rcnn_tpu_torch.tools.{cli}\n"
            "import mx_rcnn_tpu_torch.tools.serve\n"
            "from mx_rcnn_tpu_torch import kernels\n"
            "print(type(kernels.NMS_SWEEP._lock).__name__)\n")
    env = dict(os.environ, MXRCNN_THREAD_SANITIZER="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "SanLock"
    reports = [x for x in lines if x.startswith("LOCKSAN_REPORT ")]
    assert len(reports) == 1 and "LOCKSAN_DIRTY" not in out.stdout
    rep = json.loads(reports[0].split(" ", 1)[1])
    assert rep["armed"] and not rep["strict"] and rep["locks_wrapped"] >= 6


def test_unarmed_cli_import_wraps_nothing():
    code = ("import threading\n"
            "import mx_rcnn_tpu_torch.tools.train\n"
            "from mx_rcnn_tpu_torch import kernels\n"
            "from mx_rcnn_tpu_torch.analysis import sanitizer\n"
            "print(type(kernels.NMS_SWEEP._lock).__name__, "
            "sanitizer.armed(), threading.Lock is sanitizer._RAW_LOCK)\n")
    env = {k: v for k, v in os.environ.items()
           if k != "MXRCNN_THREAD_SANITIZER"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["lock", "False", "True"]
    assert "LOCKSAN_REPORT" not in out.stdout


def test_a_thread_threading_did_not_start_takes_a_package_lock():
    """The autograd engine's device threads run Python (K3's launch in
    the backward) without a ``threading.Thread``: package code taking a
    package lock there must not build a dummy Thread inside the
    accounting, whose ``Event`` would take the accounting's own lock
    again.  A request ends on a ``_thread`` thread, in a process of its
    own (a deadlock would hang it; the JAX package's copy does)."""
    code = (
        "import _thread, os\n"
        "from mx_rcnn_tpu_torch.analysis import sanitizer as s\n"
        "from mx_rcnn_tpu_torch.serve.queue import ServeRequest\n"
        "s.install(strict=True)\n"
        "req = ServeRequest(None, None, (4, 4), None, 0.0)\n"
        "assert type(req._lock).__name__ == 'SanLock'\n"
        "_thread.start_new_thread(req._finish, ('served',))\n"
        "ok = req._event.wait(10)\n"
        "print('ended' if ok and req.state == 'served' else 'stuck', "
        "s.check_clean(), flush=True)\n"
        "os._exit(0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.stdout.split() == ["ended", "True"], out.stderr[-2000:]
