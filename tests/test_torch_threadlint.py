"""threadlint of the port (``mx_rcnn_tpu_torch/analysis/threadlint.py``)
held against the JAX package's linter on the CPU.

Both linters lint the JAX fixture, every snippet that
``tests/test_threadlint.py`` lints (read from that file's AST, so a new
snippet there is held here too) and both trees, and must give the same
findings; the port adds only the torch names of its docstring, which an
inline torch twin of the fixture trips.
"""

import ast
import dataclasses
import functools
import json
import os
import textwrap

import pytest

from mx_rcnn_tpu.analysis import threadlint as jtl
from mx_rcnn_tpu_torch.analysis import threadlint as ttl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "mx_rcnn_tpu")
PORT_PKG = os.path.join(REPO, "mx_rcnn_tpu_torch")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "serve",
                       "threadlint_bad.py")
JAX_TESTS = os.path.join(REPO, "tests", "test_threadlint.py")


def _rows(findings):
    return [dataclasses.astuple(f) for f in findings]


@functools.lru_cache(maxsize=None)
def _tree_findings(mod, tree):
    return tuple(mod.lint_paths([tree]))


def _snippets(helper: str):
    """(test name, index, source, file name) of every ``helper(tmp_path,
    "<source>", name=...)`` call in the JAX linter's tests."""
    with open(JAX_TESTS) as f:
        tree = ast.parse(f.read())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Name) and n.func.id == helper]
        for i, call in enumerate(sorted(calls, key=lambda c: c.lineno)):
            name = next((k.value.value for k in call.keywords
                         if k.arg == "name"), "snippet.py")
            out.append((fn.name, i, call.args[1].value, name))
    return out


def _assigned_string(test: str, var: str) -> str:
    with open(JAX_TESTS) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == test)
    return next(n.value.value for n in ast.walk(fn)
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == var)


SNIPPETS = _snippets("_lint_snippet")


def test_every_jax_snippet_is_collected():
    # the snippet tests of tests/test_threadlint.py, each at least once
    assert {s[0] for s in SNIPPETS} >= {
        "test_lock_cycle_detected_and_consistent_order_clean",
        "test_lock_cycle_through_call_closure",
        "test_blocking_under_lock_flagged_outside_clean",
        "test_thread_shared_write_flagged_guarded_clean",
        "test_signal_handler_rules",
        "test_signal_handler_worker_thread_pattern_is_clean",
        "test_annotated_write_does_not_dodge_tl201",
        "test_condition_wait_predicate_loop",
        "test_waiver_requires_reason"}
    assert len(SNIPPETS) >= 11


@pytest.mark.parametrize("test,index,source,name", SNIPPETS,
                         ids=[f"{s[0]}-{s[1]}" for s in SNIPPETS])
def test_snippet_findings_equal_jax(tmp_path, test, index, source, name):
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    want = _rows(jtl.lint_paths([str(p)]))
    got = _rows(ttl.lint_paths([str(p)]))
    assert got == want
    assert jtl.lock_graph([str(p)]) == ttl.lock_graph([str(p)])


def test_same_basename_layout_equals_jax(tmp_path):
    cyclic = _assigned_string(
        "test_same_basename_modules_do_not_shadow_closure", "cyclic")
    (tmp_path / "x").mkdir()
    (tmp_path / "y").mkdir()
    (tmp_path / "x" / "mod.py").write_text(textwrap.dedent(cyclic))
    (tmp_path / "y" / "mod.py").write_text(
        "def grab_two():\n    return 2\n")
    want = _rows(jtl.lint_paths([str(tmp_path)]))
    assert any(r[3] == "TL101" for r in want)
    assert _rows(ttl.lint_paths([str(tmp_path)])) == want


def test_fixture_findings_equal_jax():
    want = jtl.lint_paths([FIXTURE])
    got = ttl.lint_paths([FIXTURE])
    assert _rows(got) == _rows(want)
    # every rule trips, and the reasonless waiver silences its TL301
    assert {f.code for f in got} == set(ttl.RULES)
    assert any(f.code == "TL301" and f.waived is not None for f in got)


def test_rules_equal_jax():
    assert ttl.RULES == jtl.RULES


@pytest.mark.parametrize("tree", [JAX_PKG, PORT_PKG],
                         ids=["jax_tree", "port_tree"])
def test_tree_findings_equal_jax(tree):
    assert _rows(_tree_findings(ttl, tree)) == \
        _rows(_tree_findings(jtl, tree))


def test_port_tree_has_zero_unwaived_findings():
    findings = _tree_findings(ttl, PORT_PKG)
    active = [f for f in findings if f.waived is None]
    assert active == [], "\n".join(f.render() for f in active)
    assert findings, "the port's waivers are gone: re-read this test"
    for f in findings:
        assert f.waived.strip(), f.render()


def test_port_lock_graph_has_no_cycle_and_the_queue_edge():
    g = ttl.lock_graph([PORT_PKG])
    assert g["cycles"] == [], g["cycles"]
    edges = {(e["held"], e["acquired"]) for e in g["edges"]}
    # requests terminate while the dispatcher holds the bucket condition
    # (serve/queue.py — take_batch's expiry)
    assert ("BoundedQueue._cond", "ServeRequest._lock") in edges, edges
    kinds = {n["id"]: n["kind"] for n in g["nodes"]}
    assert kinds.get("BoundedQueue._cond") == "Condition"


TORCH_TWIN = """\
import signal
import threading

import torch

L = threading.Lock()


class Stepper:
    def __init__(self):
        self._lock = threading.Lock()
        self.done = torch.cuda.Event()

    def sync_under_lock(self):
        with self._lock:
            torch.cuda.synchronize()

    def event_under_lock(self):
        with self._lock:
            self.done.synchronize()

    def sync_outside(self):
        torch.cuda.synchronize()
        with self._lock:
            return 1


def on_usr2(signum, frame):
    torch.cuda.synchronize()


def on_term(signum, frame):
    n = torch.zeros(1)
    return n


signal.signal(signal.SIGUSR2, on_usr2)
signal.signal(signal.SIGTERM, on_term)
"""


def test_torch_twin_trips_tl301_and_tl401(tmp_path):
    p = tmp_path / "torch_twin.py"
    p.write_text(TORCH_TWIN)
    got = [(f.code, f.line) for f in ttl.lint_paths([str(p)])]
    assert got == [("TL301", 16), ("TL301", 20), ("TL401", 29),
                   ("TL401", 33)], got
    msgs = [f.message for f in ttl.lint_paths([str(p)])]
    assert "'torch.cuda.synchronize'" in msgs[0]
    assert "'.synchronize()'" in msgs[1]
    assert "calls into torch ('torch.cuda.synchronize')" in msgs[2]
    assert "calls into torch ('torch.zeros')" in msgs[3]
    # the torch names are the port's: the JAX linter sees none of them
    assert jtl.lint_paths([str(p)]) == []


def test_torch_twin_waivers(tmp_path):
    src = TORCH_TWIN.replace(
        "            torch.cuda.synchronize()\n",
        "            torch.cuda.synchronize()  # threadlint: disable=TL301 "
        "a drain at close\n", 1)
    p = tmp_path / "torch_twin.py"
    p.write_text(src)
    rows = [(f.code, f.line, f.waived) for f in ttl.lint_paths([str(p)])]
    assert rows[0] == ("TL301", 16, "a drain at close")


def test_cli_matches_jax(tmp_path, capsys):
    for mod in (jtl, ttl):
        assert mod.main([PORT_PKG]) == 0
        assert mod.main([FIXTURE]) == 1
        assert mod.main([str(tmp_path / "nope")]) == 2
    capsys.readouterr()
    outs = []
    for mod in (jtl, ttl):
        assert mod.main(["--list-rules"]) == 0
        rules = capsys.readouterr().out
        assert mod.main([FIXTURE, "--graph"]) == 0
        graph = json.loads(capsys.readouterr().out)
        assert mod.main([FIXTURE, "--json", "--show-waived"]) == 1
        rows = capsys.readouterr().out
        outs.append((rules, graph, rows))
    assert outs[1] == outs[0]
    assert graph["cycles"], "the fixture's cycle is missing"


def test_cli_default_path_is_the_port(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    assert ttl.main([]) == 0
    assert "0 finding(s)" in capsys.readouterr().err
