"""configlint of the port (``mx_rcnn_tpu_torch/analysis/configlint.py``)
held against the JAX package's linter on the CPU.

The port's linter reads the port's ``config.py``; every configlint
snippet of ``tests/test_threadlint.py`` (read from that file's AST) gives
the JAX linter's findings in the snippet, and the same dead keys among
the keys both configs declare.  A read of a key only the JAX config
declares is a CL101 in the port.
"""

import ast
import dataclasses
import json
import os
import textwrap

import pytest

from mx_rcnn_tpu.analysis import configlint as jcl
from mx_rcnn_tpu_torch import config as tconfig
from mx_rcnn_tpu_torch.analysis import configlint as tcl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = os.path.join(REPO, "mx_rcnn_tpu_torch")
JAX_TESTS = os.path.join(REPO, "tests", "test_threadlint.py")

# the fields the JAX config declares and the port's does not
JAX_ONLY_FIELDS = (
    "default.begin_epoch", "default.kvstore", "default.prefix",
    "ft.compile_cache_dir",
    "network.depth", "network.image_stride", "network.pretrained",
    "network.pretrained_epoch", "network.rcnn_feat_stride",
    "test.has_rpn", "test.proposal_nms_thresh",
    "train.aspect_grouping", "train.bbox_regression_thresh",
    "train.end2end", "train.nms_batched", "train.roi_align_backend",
    "train.roi_align_chunk")
# and the derived key (a property of the JAX NetworkConfig)
JAX_ONLY_PROPERTIES = ("network.num_anchors",)


def _snippets():
    with open(JAX_TESTS) as f:
        tree = ast.parse(f.read())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for n in ast.walk(fn):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                    and n.func.id == "_configlint_snippet":
                out.append((fn.name, n.args[1].value))
    return out


SNIPPETS = _snippets()


def _keys(schema):
    return {f"{s}.{k}" for s, keys in schema.items() for k in keys}


def _lint(mod, path):
    findings = mod.lint_paths([str(path)])
    here = [dataclasses.astuple(f) for f in findings
            if f.path == str(path)]
    dead = {f.message.split("'")[1] for f in findings if f.code == "CL201"}
    return here, dead


def test_jax_only_keys_are_the_schema_difference():
    jkeys = _keys(jcl._section_schema()[0])
    tkeys = _keys(tcl._section_schema()[0])
    assert tkeys <= jkeys
    assert jkeys - tkeys == set(JAX_ONLY_FIELDS + JAX_ONLY_PROPERTIES)


def test_every_jax_snippet_is_collected():
    assert {s[0] for s in SNIPPETS} == {
        "test_configlint_catches_typo_read",
        "test_configlint_follows_alias_and_getattr",
        "test_configlint_getattr_key_matching_a_section_name",
        "test_configlint_reports_dead_keys_at_definition",
        "test_configlint_property_keys_are_valid"}


@pytest.mark.parametrize("test,source", SNIPPETS,
                         ids=[s[0] for s in SNIPPETS])
def test_snippet_findings_equal_jax(tmp_path, test, source):
    p = tmp_path / "snippet.py"
    p.write_text(textwrap.dedent(source))
    jhere, jdead = _lint(jcl, p)
    there, tdead = _lint(tcl, p)
    common = _keys(tcl._section_schema()[0])
    if test == "test_configlint_property_keys_are_valid":
        # the port's NetworkConfig has no num_anchors property
        assert jhere == []
        assert [(r[3], r[1]) for r in there] == [("CL101", 2)]
        assert "'network.num_anchors'" in there[0][4]
    else:
        assert there == jhere
    assert tdead == jdead & common
    assert not tdead & set(JAX_ONLY_FIELDS)


@pytest.mark.parametrize("key", JAX_ONLY_FIELDS + JAX_ONLY_PROPERTIES)
def test_read_of_a_jax_only_key_is_cl101_in_the_port(tmp_path, key):
    section, name = key.split(".")
    p = tmp_path / "snippet.py"
    p.write_text(f"def f(cfg):\n    return cfg.{section}.{name}\n")
    jhere, _ = _lint(jcl, p)
    there, _ = _lint(tcl, p)
    assert jhere == []
    assert [(r[3], r[1], r[2]) for r in there] == [("CL101", 2, 11)]
    assert f"'{key}' is not a field" in there[0][4]


def test_roi_align_backend_read_is_cl101(tmp_path):
    p = tmp_path / "reader.py"
    p.write_text("def backend(cfg):\n"
                 "    t = cfg.train\n"
                 "    return t.roi_align_backend, "
                 "getattr(cfg.train, 'roi_align_chunk')\n")
    codes = [(f.code, f.line) for f in tcl.lint_paths([str(p)])
             if f.path == str(p)]
    assert codes == [("CL101", 3), ("CL101", 3)]


def test_port_tree_has_zero_unwaived_findings():
    findings = tcl.lint_paths([PORT_PKG])
    active = [f for f in findings if f.waived is None]
    assert active == [], "\n".join(f.render() for f in active)
    for f in findings:
        assert f.waived.strip(), f.render()


@pytest.mark.parametrize("module,key", [
    ("ft/snapshot.py", "ft.keep_every"),
    ("ops/quant.py", "quant.percentile"),
])
def test_port_module_reads_what_its_jax_module_reads(module, key):
    """The JAX module at the same path reads ``key``; the port's did too
    at run time, but through an alias (a tuple unpacking, an
    unannotated section parameter) that hid it from configlint, so the
    key showed as dead.  The read is now spelled as the JAX module
    spells it."""
    jdead = _lint(jcl, os.path.join(REPO, "mx_rcnn_tpu", module))[1]
    tdead = _lint(tcl, os.path.join(PORT_PKG, module))[1]
    assert key not in jdead
    assert key not in tdead


def test_dump_keys_lists_the_port_config(capsys):
    assert tcl.main(["--dump-keys"]) == 0
    dumped = json.loads(capsys.readouterr().out)
    want = {}
    for f in dataclasses.fields(tconfig.Config):
        cls = type(getattr(tconfig.Config(), f.name))
        want[f.name] = sorted(
            {sf.name for sf in dataclasses.fields(cls)}
            | {n for n, v in vars(cls).items() if isinstance(v, property)})
    assert dumped == want
    assert "roi_align_backend" not in dumped["train"]


def test_cli_matches_jax(tmp_path, capsys):
    outs = []
    for mod in (jcl, tcl):
        assert mod.main(["--list-rules"]) == 0
        outs.append(capsys.readouterr().out)
        assert mod.main([str(tmp_path / "nope")]) == 2
        capsys.readouterr()
    assert outs[0] == outs[1]
    bad = tmp_path / "bad.py"
    bad.write_text("def f(cfg):\n    return cfg.serve.batch_sz\n")
    assert jcl.main([str(bad)]) == tcl.main([str(bad)]) == 1
    assert tcl.main([PORT_PKG]) == 0
    capsys.readouterr()
