"""The port's persistlint (``mx_rcnn_tpu_torch/analysis/persistlint.py``)
and its ``analysis/common.py``, held against the JAX package's on the CPU.

Every source that ``tests/test_persistlint.py`` lints (its snippets and
``tests/fixtures/ft/persistlint_bad.py``) gives the same (rule, line,
waived) findings under both linters, and so do both packages' trees; the
rule catalogue and the durable fragments are the JAX ones; the port's
tree has zero unwaived findings, each waiver with its reason; the
linter's atomic channel is the port's ``utils/checkpoint.py —
_atomic_write``; the CLI's exit codes are the JAX CLI's.
"""

import ast
import os
import textwrap

import pytest

from mx_rcnn_tpu.analysis import common as j_common
from mx_rcnn_tpu.analysis import persistlint as j_pl
from mx_rcnn_tpu_torch.analysis import common as t_common
from mx_rcnn_tpu_torch.analysis import persistlint as t_pl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mx_rcnn_tpu_torch")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "ft",
                       "persistlint_bad.py")

# the sources tests/test_persistlint.py lints, one per test there
SNIPPETS = {
    "naming_helper": """\
        def ckpt_path(prefix, epoch):
            return f"{prefix}-{epoch:04d}.ckpt"

        def save(prefix, epoch, data):
            with open(ckpt_path(prefix, epoch), "wb") as f:
                f.write(data)
        """,
    "ephemeral": """\
        import json

        def write_report(out, record):
            with open(out, "w") as f:
                json.dump(record, f, indent=1)

        def write_eval_dump(path, blob):
            with open("results/dets.pkl", "wb") as f:
                f.write(blob)
        """,
    "staging_write": """\
        import os

        def commit(path, data):
            tmp = path + ".manifest.json.tmp"
            try:
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path + ".manifest.json")
            except OSError:
                os.unlink(tmp)
                raise
        """,
    "full_idiom": """\
        import os

        def _atomic_write(path, data):
            tmp = path + ".tmp"
            try:
                with open(tmp, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        """,
    "atomic_channel_good": """\
        def _atomic_write(path, data):
            pass

        def write_manifest(path, data):
            _atomic_write(path + ".manifest.json", data)

        def commit(path, data):
            _atomic_write(path, data)
            write_manifest(path, b"{}")
        """,
    "atomic_channel_bad": """\
        def _atomic_write(path, data):
            pass

        def write_manifest(path, data):
            _atomic_write(path + ".manifest.json", data)

        def commit(path, data):
            write_manifest(path, b"{}")
            _atomic_write(path, data)
        """,
    "one_fsync_two_files": """\
        import os

        def commit_two(data):
            tmp1 = "out/a.ckpt.tmp"
            tmp2 = "out/b.ckpt.tmp"
            try:
                with open(tmp1, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                with open(tmp2, "wb") as g:
                    g.write(data)
                os.replace(tmp1, "out/a.ckpt")
                os.replace(tmp2, "out/b.ckpt")
                dfd = os.open("out", os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                os.unlink(tmp1)
                os.unlink(tmp2)
                raise
        """,
    "pl201_bad": """\
        import hashlib
        import json

        def fingerprint(ident):
            return hashlib.sha256(json.dumps(ident).encode()).hexdigest()
        """,
    "pl201_good": """\
        import hashlib
        import json

        def fingerprint(ident):
            return hashlib.sha256(
                json.dumps(ident, sort_keys=True).encode()).hexdigest()
        """,
    "waiver": """\
        def append_events(path):
            # persistlint: disable=PL101 line-granular stream, readers tolerate a torn tail
            f = open("runs/x/events.jsonl", "a")
            f.write("{}")
        """,
    "bare_waiver_and_unknown_rule": """\
        import os

        def publish(tmp, path):
            # persistlint: disable=PL103
            os.replace(tmp, path + ".manifest.json")
            # persistlint: disable=PL999 no such rule
            os.rename(tmp, path + ".ckpt")
        """,
}


def _key(findings):
    return [(f.line, f.col, f.code, f.waived is not None) for f in findings]


@pytest.mark.parametrize("name", sorted(SNIPPETS) + ["persistlint_bad"])
def test_each_fixture_gives_the_jax_findings(tmp_path, name):
    if name == "persistlint_bad":
        path = FIXTURE
    else:
        path = str(tmp_path / f"{name}.py")
        with open(path, "w") as f:
            f.write(textwrap.dedent(SNIPPETS[name]))
    want = j_pl.lint_paths([path])
    got = t_pl.lint_paths([path])
    assert _key(got) == _key(want)
    assert [f.render() for f in got] == [f.render() for f in want]


@pytest.mark.parametrize("tree", ["mx_rcnn_tpu", "mx_rcnn_tpu_torch"])
def test_both_trees_lint_alike_under_both_linters(tree):
    path = os.path.join(REPO, tree)
    want = j_pl.lint_paths([path])
    got = t_pl.lint_paths([path])
    assert [(f.path, f.line, f.code, f.waived) for f in got] == \
        [(f.path, f.line, f.code, f.waived) for f in want]


def test_port_tree_has_zero_unwaived_findings():
    findings = t_pl.lint_paths([PKG])
    active = [f for f in findings if f.waived is None]
    assert active == [], "\n".join(f.render() for f in active)
    waived = sorted((os.path.relpath(f.path, PKG), f.code, f.func)
                    for f in findings)
    # the rebuildable caches (decoded images, kernel libraries) and the
    # run record's line-granular event stream, each with its reason
    assert waived == [
        ("data/cache.py", "PL102", "DecodedImageCache.load"),
        ("data/cache.py", "PL103", "DecodedImageCache.load"),
        ("kernels.py", "PL102", "CudaKernel.finish_build"),
        ("kernels.py", "PL103", "CudaKernel.finish_build"),
        ("kernels.py", "PL103", "CudaKernel.install"),
        ("obs/runrec.py", "PL101", "RunRecord.__init__")]
    assert all(len(f.waived.strip()) > 40 for f in findings)


def test_rule_texts_and_fragments_equal_jax():
    assert t_pl.RULES == j_pl.RULES
    assert t_pl.DURABLE_FRAGMENTS == j_pl.DURABLE_FRAGMENTS
    assert t_pl.COMMIT_FRAGMENTS == j_pl.COMMIT_FRAGMENTS


def test_atomic_channel_is_the_ports_atomic_write():
    """``_atomic_writer_keys`` finds ``utils/checkpoint.py —
    _atomic_write`` and, through the call graph ``analyze_paths``
    builds, the port's writers that call it."""
    import ast as _ast

    mods = [m for m in (t_pl._load(f) for f in t_common.iter_py_files(
        [PKG])) if m is not None]
    for m in mods:
        t_pl._Collector(m).visit(m.tree)
    corpus = t_pl.PCorpus(mods)
    for m in mods:
        for fr in m.funcs.values():
            res = t_pl._Resolver(m, fr, corpus)
            for sub in _ast.walk(fr.node):
                if isinstance(sub, _ast.Call):
                    key = res._callee(sub.func)
                    if key is not None:
                        fr.callees.add(key)
    keys = t_pl._atomic_writer_keys(corpus)
    leaves = {k.split(":", 1)[1] for k in keys
              if k.startswith(PKG + os.sep)}
    assert f"{os.path.join(PKG, 'utils', 'checkpoint.py')}:_atomic_write" \
        in keys
    assert {"_atomic_write", "write_manifest", "commit_checkpoint",
            "ExportStore.finish", "ExportStore.add_variables",
            "ExportStore.add_kernels", "BulkSink.commit"} <= leaves


def test_cli_exit_codes(capsys):
    assert t_pl.main([PKG]) == 0
    assert t_pl.main([FIXTURE]) == 1
    assert t_pl.main(["--list-rules"]) == 0
    assert t_pl.main([os.path.join(REPO, "no_such_dir")]) == 2
    assert t_pl.main([os.path.join(REPO, "docs")]) == 2   # no .py files
    out = capsys.readouterr()
    for code in t_pl.RULES:
        assert code in out.out


def test_json_output_parses(capsys):
    import json

    assert t_pl.main([FIXTURE, "--json", "--show-waived"]) == 1
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert {ln["code"] for ln in lines} == set(t_pl.RULES)
    assert any(ln["waived"] is not None for ln in lines)


# ---- analysis/common.py -----------------------------------------------------

_EXPRS = ["a", "a.b.c", "jnp.where", "os.path.join", "f(x).y", "x[0].y",
          "np.random.RandomState"]


@pytest.mark.parametrize("expr", _EXPRS)
def test_dotted_and_canonical_equal_jax(expr):
    tree = ast.parse("import jax.numpy as jnp\nimport os\n"
                     "from numpy import random as rnd\nimport numpy as np\n")
    aliases = t_common.collect_import_aliases(tree)
    assert aliases == j_common.collect_import_aliases(tree)
    node = ast.parse(expr, mode="eval").body
    assert t_common.dotted(node) == j_common.dotted(node)
    assert t_common.canonical(aliases, node) == \
        j_common.canonical(aliases, node)


def test_waivers_and_findings_equal_jax():
    source = textwrap.dedent("""\
        x = 1  # persistlint: disable=PL101,pl103 a reason
        # persistlint: disable=PL104
        y = "# persistlint: disable=PL105 inside a string"
        # persistlint: disable=PL999 no such rule
        """)
    tw = t_common.parse_waivers(source, "persistlint")
    assert tw == j_common.parse_waivers(source, "persistlint")
    assert sorted(tw) == [1, 2, 4]

    def findings(mod):
        return [mod.Finding("p.py", 1, 0, "PL101", "m", "f"),
                mod.Finding("p.py", 3, 4, "PL104", "n")]

    got = t_common.apply_waivers("p.py", tw, findings(t_common), t_pl.RULES,
                                 prefix="PL", tool="persistlint")
    want = j_common.apply_waivers("p.py", tw, findings(j_common), j_pl.RULES,
                                  prefix="PL", tool="persistlint")
    assert [f.render() for f in got] == [f.render() for f in want]
    assert {f.code for f in got} == {"PL101", "PL104", "PL001", "PL002"}


def test_file_iteration_and_path_check_equal_jax(tmp_path, capsys):
    (tmp_path / "pkg" / "__pycache__").mkdir(parents=True)
    (tmp_path / "pkg" / "a.py").write_text("")
    (tmp_path / "pkg" / "b.txt").write_text("")
    (tmp_path / "pkg" / "__pycache__" / "c.py").write_text("")
    (tmp_path / "empty").mkdir()
    paths = [str(tmp_path / "pkg"), str(tmp_path / "pkg" / "a.py")]
    assert t_common.iter_py_files(paths) == j_common.iter_py_files(paths) \
        == [str(tmp_path / "pkg" / "a.py")]
    for p in (paths, [str(tmp_path / "empty")], [str(tmp_path / "nope")]):
        assert t_common.check_paths_exist("t", p) == \
            j_common.check_paths_exist("t", p)
    capsys.readouterr()
