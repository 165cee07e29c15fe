"""netlint of the port (``mx_rcnn_tpu_torch/analysis/netlint.py``) held
against the JAX package's linter on the CPU, and the port's msgpack
reader held to the typed rejection netlint's NL201 waivers rely on.

Both linters lint the JAX fixture, every snippet that
``tests/test_netlint.py`` lints (read from that file's AST, so a new
snippet there is held here too) and both trees, and must give the same
findings (rule, line, column, function, message, waiver).
"""

import ast
import dataclasses
import functools
import json
import os
import textwrap

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.analysis import netlint as jnl
from mx_rcnn_tpu_torch.analysis import netlint as tnl
from mx_rcnn_tpu_torch.utils import flax_msgpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "mx_rcnn_tpu")
PORT_PKG = os.path.join(REPO, "mx_rcnn_tpu_torch")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "serve", "netlint_bad.py")
JAX_TESTS = os.path.join(REPO, "tests", "test_netlint.py")


def _rows(findings):
    return [dataclasses.astuple(f) for f in findings]


@functools.lru_cache(maxsize=None)
def _tree_findings(mod, tree):
    return tuple(mod.lint_paths([tree]))


def _snippets():
    """(test name, index, source, file name) of every ``_lint_snippet(
    tmp_path, "<source>", name=...)`` call in the JAX linter's tests."""
    with open(JAX_TESTS) as f:
        tree = ast.parse(f.read())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Name)
                 and n.func.id == "_lint_snippet"]
        for i, call in enumerate(sorted(calls, key=lambda c: c.lineno)):
            name = next((k.value.value for k in call.keywords
                         if k.arg == "name"), "snippet.py")
            out.append((fn.name, i, call.args[1].value, name))
    return out


SNIPPETS = _snippets()


def test_every_jax_snippet_is_collected():
    # every rule's snippet tests of tests/test_netlint.py, and the waivers
    assert {s[0] for s in SNIPPETS} >= {
        "test_nl101_settimeout_after_alloc_clears",
        "test_nl101_through_untimed_factory",
        "test_nl101_untimed_self_attr",
        "test_nl102_plain_close_is_not_exception_safe",
        "test_nl102_with_finally_and_handoff_are_clean",
        "test_nl201_unguarded_unpack_flagged",
        "test_nl201_check_after_unpack_still_flagged",
        "test_nl202_derivation_chain_flagged_and_cleared",
        "test_nl202_bytes_repetition_sink",
        "test_nl203_sized_read_and_capped_loop_are_clean",
        "test_nl203_argless_read_on_derived_response",
        "test_nl204_bounded_handler_read_is_clean",
        "test_nl204_argless_rfile_read_flagged",
        "test_nl301_backoff_and_cap_required",
        "test_nl301_only_fires_on_network_tries",
        "test_waiver_on_line_and_line_above",
        "test_waiver_two_lines_above_does_not_match"}
    assert len(SNIPPETS) >= 23


@pytest.mark.parametrize("test,index,source,name", SNIPPETS,
                         ids=[f"{s[0]}-{s[1]}" for s in SNIPPETS])
def test_snippet_findings_equal_jax(tmp_path, test, index, source, name):
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    assert _rows(tnl.lint_paths([str(p)])) == _rows(jnl.lint_paths([str(p)]))


def test_fixture_findings_equal_jax():
    want = jnl.lint_paths([FIXTURE])
    got = tnl.lint_paths([FIXTURE])
    assert _rows(got) == _rows(want)
    # every rule trips, and the reasonless waiver silences its NL101
    assert {f.code for f in got} == set(tnl.RULES)
    assert any(f.code == "NL101" and f.waived is not None for f in got)


def test_rules_equal_jax():
    assert tnl.RULES == jnl.RULES


@pytest.mark.parametrize("tree", [JAX_PKG, PORT_PKG],
                         ids=["jax_tree", "port_tree"])
def test_tree_findings_equal_jax(tree):
    assert _rows(_tree_findings(tnl, tree)) == \
        _rows(_tree_findings(jnl, tree))


def test_jax_tree_has_its_seven_waivers():
    findings = _tree_findings(tnl, JAX_PKG)
    assert [f for f in findings if f.waived is None] == []
    rows = sorted((os.path.relpath(f.path, REPO), f.code) for f in findings)
    assert rows == sorted(
        [("mx_rcnn_tpu/serve/agent.py", "NL301"),
         ("mx_rcnn_tpu/tools/wirefuzz.py", "NL202")]
        + [("mx_rcnn_tpu/tools/wirefuzz.py", "NL201")] * 5)


def test_port_tree_has_zero_unwaived_findings():
    findings = _tree_findings(tnl, PORT_PKG)
    active = [f for f in findings if f.waived is None]
    assert active == [], "\n".join(f.render() for f in active)
    for f in findings:
        assert f.waived.strip(), f.render()
    rel = {(os.path.relpath(f.path, PORT_PKG), f.code) for f in findings}
    # the JAX tree's waivers, carried to the same code in the port, and
    # the msgpack reader's two reads through _Reader.take
    assert rel == {("serve/agent.py", "NL301"),
                   ("tools/wirefuzz.py", "NL202"),
                   ("tools/wirefuzz.py", "NL201"),
                   ("utils/flax_msgpack.py", "NL201")}
    agent = next(f for f in findings if f.path.endswith("agent.py"))
    assert agent.func == "pull_store"
    assert agent.waived == "finite resume-retry, 2nd failure raises"


def test_cli_matches_jax(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("import socket\n\n\ndef ask(addr):\n"
                     "    with socket.create_connection(addr, timeout=2.0)"
                     " as s:\n        return s.recv(16)\n")
    for mod in (jnl, tnl):
        assert mod.main([str(clean)]) == 0
        assert mod.main([FIXTURE]) == 1
        assert mod.main([str(tmp_path / "nope")]) == 2
    capsys.readouterr()
    outs = []
    for mod in (jnl, tnl):
        assert mod.main(["--list-rules"]) == 0
        rules = capsys.readouterr().out
        assert mod.main([FIXTURE, "--json", "--show-waived"]) == 1
        rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
        outs.append((rules, rows))
    assert outs[1] == outs[0]
    assert any(r["waived"] is not None for r in outs[1][1])


def test_cli_default_path_is_the_port(monkeypatch, capsys):
    """``main()`` lints ``mx_rcnn_tpu_torch`` (the tree's findings are
    the cached ones of the tests above) and exits 0 on it."""
    seen = []

    def lint(paths):
        seen.append(list(paths))
        return list(_tree_findings(tnl, PORT_PKG))

    monkeypatch.chdir(REPO)
    monkeypatch.setattr(tnl, "lint_paths", lint)
    assert tnl.main([]) == 0
    assert seen == [["mx_rcnn_tpu_torch"]]
    assert "0 finding(s), 9 waived" in capsys.readouterr().err


# ---- the msgpack reader: every bad length a typed rejection ------------------

def _checkpoint_like():
    rng = np.random.RandomState(0)
    return {"params": {"conv": {"kernel": rng.rand(3, 3, 2, 4)
                                .astype(np.float32),
                                "bias": np.zeros(4, np.float32)},
                       "bf16": torch.ones(5, dtype=torch.bfloat16),
                       "empty_bf16": torch.ones((0, 3),
                                                dtype=torch.bfloat16)},
            "name": "x" * 40, "blob": b"\x01" * 300,
            "opt": [1, -3, 300, 70000, 2 ** 40, -200, 2.5, None, True],
            "step": np.int32(7), "big": np.zeros(70000, np.uint8),
            "k" * 40: "y" * 300}


def _length_fields(buf: bytes):
    """(offset, width) of every length or count field a header of
    ``buf`` carries: the fixstr / fixarray / fixmap nibbles and the
    str / bin / array / map / ext length words, walked as the reader
    walks them."""
    widths = {0xd9: 1, 0xda: 2, 0xdb: 4, 0xc4: 1, 0xc5: 2, 0xc6: 4,
              0xdc: 2, 0xdd: 4, 0xde: 2, 0xdf: 4, 0xc7: 1, 0xc8: 2,
              0xc9: 4}
    out = []

    def walk(pos):
        b = buf[pos]
        if b < 0x80 or b >= 0xe0 or b in (0xc0, 0xc2, 0xc3):
            return pos + 1
        if 0xa0 <= b <= 0xbf:
            out.append((pos, 0))
            return pos + 1 + (b & 0x1f)
        if 0x90 <= b <= 0x9f or 0x80 <= b <= 0x8f:
            out.append((pos, 0))
            n = (b & 0x0f) * (2 if b < 0x90 else 1)
            pos += 1
            for _ in range(n):
                pos = walk(pos)
            return pos
        fixed = {0xcc: 1, 0xcd: 2, 0xce: 4, 0xcf: 8, 0xd0: 1, 0xd1: 2,
                 0xd2: 4, 0xd3: 8, 0xca: 4, 0xcb: 8}
        if b in fixed:
            return pos + 1 + fixed[b]
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in widths:
            w = widths[b]
            out.append((pos + 1, w))
            n = int.from_bytes(buf[pos + 1:pos + 1 + w], "big")
            pos += 1 + w
        elif b in fixext:
            n = fixext[b]
            pos += 1
        else:
            raise AssertionError(f"type 0x{b:02x}")
        if b in (0xdc, 0xdd, 0xde, 0xdf):
            for _ in range(n * (2 if b in (0xde, 0xdf) else 1)):
                pos = walk(pos)
            return pos
        if b in (0xc7, 0xc8, 0xc9) or b in fixext:
            walk(pos + 1)    # the ext body: [shape, dtype name, bytes]
            return pos + 1 + n
        return pos + n

    assert walk(0) == len(buf)
    return out


def _lie(buf: bytes, off: int, width: int, delta: int) -> bytes:
    d = bytearray(buf)
    if width == 0:          # a fix-type's length nibble
        mask = 0x1f if 0xa0 <= d[off] <= 0xbf else 0x0f
        d[off] = (d[off] & ~mask) | ((d[off] + delta) & mask)
    else:
        n = int.from_bytes(d[off:off + width], "big")
        d[off:off + width] = ((n + delta) % (1 << 8 * width)).to_bytes(
            width, "big")
    return bytes(d)


def test_msgpack_bad_lengths_are_typed_rejections():
    buf = flax_msgpack.packb(_checkpoint_like())
    back = flax_msgpack.unpackb(buf)
    assert back["params"]["empty_bf16"].shape == (0, 3)
    assert back["opt"] == [1, -3, 300, 70000, 2 ** 40, -200, 2.5, None, True]
    # every truncation
    for cut in range(len(buf)):
        with pytest.raises(ValueError):
            flax_msgpack.unpackb(buf[:cut])
    # every length or count field made to lie, shorter and longer; a lie
    # that still parses to a whole object must hand back what it says
    fields = _length_fields(buf)
    assert len(fields) > 40
    for off, width in fields:
        for delta in (-1, 1, 1 << 20, -(1 << 20)):
            lied = _lie(buf, off, width, delta)
            if lied == buf:
                continue
            try:
                flax_msgpack.unpackb(lied)
            except ValueError:
                continue


def test_msgpack_every_byte_flip_is_typed():
    """Each byte of a header-dense tree set to each value: the reader
    returns a tree or raises ValueError, never struct.error, TypeError or
    a torch RuntimeError."""
    buf = flax_msgpack.packb(
        {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
         "b": torch.ones(3, dtype=torch.bfloat16), "s": [1, 300, "xy"]})
    assert len(buf) < 120
    for off in range(len(buf)):
        for v in range(256):
            d = bytearray(buf)
            d[off] = v
            try:
                flax_msgpack.unpackb(bytes(d))
            except ValueError:
                pass
