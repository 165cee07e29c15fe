"""Shared machinery for the port's analysis passes: the ``Finding``
record, the reasoned-waiver protocol, import alias resolution and file
iteration.

Counterpart of ``mx_rcnn_tpu/analysis/common.py``, the same code, so a
linter of the port speaks the JAX package's waiver dialect and renders
findings as its twin does:

* a waiver is ``# <tool>: disable=<CODE>[,<CODE>...] <reason>`` on the
  offending line or the line directly above; the reason is MANDATORY — a
  bare waiver is itself a finding (``<PREFIX>001``), and a waiver naming
  an unknown rule is ``<PREFIX>002``;
* ``Finding.render()`` gives the one-line ``path:line:col CODE message``
  format every CLI prints and every test asserts against.

Each tool keeps its own rule catalogue, scope model and checks — only the
protocol plumbing lives here.
"""

from __future__ import annotations

import ast
import io
import os
import re
import sys
import tokenize
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple


@dataclass
class Finding:
    path: str
    line: int
    col: int
    code: str
    message: str
    func: str = ""
    waived: Optional[str] = None  # the waiver reason when waived

    def render(self) -> str:
        where = f" [in {self.func}]" if self.func else ""
        tail = f"  (waived: {self.waived})" if self.waived is not None else ""
        return (f"{self.path}:{self.line}:{self.col + 1} {self.code} "
                f"{self.message}{where}{tail}")


def waiver_re(tool: str) -> re.Pattern:
    """The per-tool waiver comment pattern:
    ``# <tool>: disable=CODE[,CODE...] <reason>``."""
    return re.compile(tool + r":\s*disable=([A-Za-z0-9,]+)\s*(.*)$")


def parse_waivers(source: str, tool: str
                  ) -> Dict[int, Tuple[Set[str], str]]:
    """Collect ``{line: ({codes}, reason)}`` waivers for ``tool`` from the
    comment stream (tokenize, so strings containing the pattern don't
    count)."""
    pat = waiver_re(tool)
    waivers: Dict[int, Tuple[Set[str], str]] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = pat.search(tok.string)
            if m:
                codes = {c.strip().upper() for c in m.group(1).split(",")
                         if c.strip()}
                waivers[tok.start[0]] = (codes, m.group(2).strip())
    except tokenize.TokenError:
        pass
    return waivers


def apply_waivers(path: str, waivers: Dict[int, Tuple[Set[str], str]],
                  findings: List[Finding], rules: Dict[str, str],
                  prefix: str, tool: str) -> List[Finding]:
    """Mark findings waived when a matching waiver sits on their line (or
    the line above), then lint the waivers themselves: no reason →
    ``<prefix>001``; unknown rule code → ``<prefix>002``."""
    for f in findings:
        for line in (f.line, f.line - 1):
            w = waivers.get(line)
            if w is None:
                continue
            codes, reason = w
            if f.code in codes:
                f.waived = reason
                break
    out = list(findings)
    for line, (codes, reason) in sorted(waivers.items()):
        if not reason:
            out.append(Finding(path, line, 0, f"{prefix}001",
                               f"waiver must state a reason: "
                               f"'# {tool}: disable={prefix}xxx <why>'"))
        for c in codes:
            if c not in rules:
                out.append(Finding(path, line, 0, f"{prefix}002",
                                   f"waiver names unknown rule {c!r}"))
    return out


# --------------------------------------------------------------------------
# name resolution
# --------------------------------------------------------------------------

def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def collect_import_aliases(tree: ast.Module) -> Dict[str, str]:
    """``{local name: canonical dotted name}`` from the module's imports
    (``import jax.numpy as jnp`` → ``jnp: jax.numpy``)."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def canonical(aliases: Dict[str, str], node: ast.AST) -> Optional[str]:
    """Resolve a Name/Attribute chain through import aliases:
    ``jnp.where`` → ``jax.numpy.where``."""
    d = dotted(node)
    if d is None:
        return None
    head, _, rest = d.partition(".")
    full = aliases.get(head, head)
    return f"{full}.{rest}" if rest else full


# --------------------------------------------------------------------------
# file iteration + CLI plumbing
# --------------------------------------------------------------------------

def iter_py_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            files.append(p)
        elif os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git")]
                files.extend(os.path.join(root, n)
                             for n in sorted(names) if n.endswith(".py"))
    return sorted(set(files))


def check_paths_exist(tool: str, paths: Sequence[str]) -> Optional[int]:
    """A typo'd path (or a package rename) must FAIL the gate, not lint
    zero files and pass vacuously.  Returns an exit code, or None when
    the paths are usable."""
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"{tool}: path(s) do not exist: {missing}", file=sys.stderr)
        return 2
    if not iter_py_files(paths):
        print(f"{tool}: no .py files under {list(paths)}", file=sys.stderr)
        return 2
    return None
