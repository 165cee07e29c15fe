"""configlint — config-key static analysis of the port's config surface.

Counterpart of ``mx_rcnn_tpu/analysis/configlint.py``: the same rules,
rule texts, alias tracking and waiver protocol, held against the PORT's
``mx_rcnn_tpu_torch/config.py`` (its ``Config`` and its source lines)
instead of the JAX package's.  The port's config declares fewer keys
than the JAX one, so a read the JAX tree may make is a CL101 here.

The config system (``config.py``) is a frozen-dataclass tree addressed
as ``cfg.<section>.<key>`` everywhere, with CLI overrides spelled
``--set section__key=value``.  Nothing ties an attribute read to the
dataclass: a typo'd read (``cfg.serve.batch_sz``) raises only when the
line executes — possibly rounds later, in a rarely-driven smoke — and a
knob nobody reads anymore silently rides along forever, looking
configurable while doing nothing.  configlint closes both directions:

* **CL101** — a ``cfg.<section>.<key>`` read names a key that does not
  exist in that section's dataclass (typo / removed knob).  Follows the
  common aliasing patterns: ``s = cfg.serve; s.batch_size``,
  ``self.cfg.<section>.<key>``, ``getattr(cfg, "obs", None)``.
* **CL201** — dead key: a field declared in a ``config.py`` dataclass
  that no code in the scanned tree reads.  Reported at the field's
  definition line, so the waiver (with its reason) sits next to the
  knob it documents.

Keys consumed only generically (``dataclasses.fields`` iteration in the
fingerprint, ``--set`` plumbing) do NOT count as reads — a knob that is
only serialized is still dead.  Properties of a section class count as
valid keys (``cfg.network.num_anchors`` is derived, not declared).

Waivers: the JAX linters' protocol (``analysis/common.py``;
``# configlint: disable=CL201 <reason>``); reasonless → CL001, unknown
rule → CL002.

CLI::

    python -m mx_rcnn_tpu_torch.analysis.configlint [paths...] [--json]
        [--show-waived] [--list-rules] [--dump-keys]
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Set, Tuple

from mx_rcnn_tpu_torch.analysis.common import (Finding, apply_waivers,
                                               check_paths_exist,
                                               iter_py_files, parse_waivers)

RULES: Dict[str, str] = {
    "CL001": "waiver without a reason (every waiver must say why)",
    "CL002": "waiver names an unknown rule code",
    "CL101": "config key read does not exist in the config.py dataclass",
    "CL201": "dead config key: declared in config.py but never read",
}


def _section_schema() -> Tuple[Dict[str, Set[str]], Dict[str, type]]:
    """``{section: {valid keys}}`` from the port's live Config
    dataclasses — fields plus properties (derived keys like
    ``num_anchors``)."""
    from mx_rcnn_tpu_torch.config import Config

    sections: Dict[str, Set[str]] = {}
    classes: Dict[str, type] = {}
    for f in dataclasses.fields(Config):
        cls = f.default_factory if f.default_factory is not \
            dataclasses.MISSING else type(getattr(Config(), f.name))
        keys = {sf.name for sf in dataclasses.fields(cls)}
        keys |= {n for n, v in vars(cls).items()
                 if isinstance(v, property)}
        sections[f.name] = keys
        classes[f.name] = cls
    return sections, classes


def _is_cfg_base(node: ast.AST) -> bool:
    """Heuristic root test: ``cfg`` / ``kcfg`` / anything ``*cfg``, or an
    attribute spelled ``.cfg`` (``self.cfg``)."""
    if isinstance(node, ast.Name):
        return node.id == "config" or node.id.endswith("cfg")
    if isinstance(node, ast.Attribute):
        return node.attr == "cfg" or node.attr.endswith("cfg")
    return False


class _Visitor(ast.NodeVisitor):
    """Per-module scan: section-alias tracking + key-read collection."""

    def __init__(self, path: str, sections: Dict[str, Set[str]],
                 section_classes: Dict[str, str]):
        self.path = path
        self.sections = sections
        self.section_classes = section_classes   # class name -> section
        self.scope_aliases: List[Dict[str, str]] = [{}]  # name -> section
        self.reads: Set[Tuple[str, str]] = set()
        self.findings: List[Finding] = []

    # -- scopes -------------------------------------------------------------

    def visit_FunctionDef(self, node):
        scope = dict(self.scope_aliases[0])
        # a parameter annotated with a section CLASS is that section
        # (``def spec_from_config(qcfg: QuantConfig)``)
        for a in node.args.posonlyargs + node.args.args + \
                node.args.kwonlyargs:
            ann = a.annotation
            name = None
            if isinstance(ann, ast.Name):
                name = ann.id
            elif isinstance(ann, ast.Constant) and isinstance(ann.value,
                                                              str):
                name = ann.value.strip("'\"")
            if name in self.section_classes:
                scope[a.arg] = self.section_classes[name]
        self.scope_aliases.append(scope)
        self.generic_visit(node)
        self.scope_aliases.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _alias_of(self, value: ast.AST) -> Optional[str]:
        """The section named by an expression, if any: ``cfg.serve``,
        ``getattr(cfg, "serve", ...)``."""
        if isinstance(value, ast.Attribute) and \
                value.attr in self.sections and _is_cfg_base(value.value):
            return value.attr
        if isinstance(value, ast.Call) and \
                isinstance(value.func, ast.Name) and \
                value.func.id == "getattr" and len(value.args) >= 2 and \
                _is_cfg_base(value.args[0]) and \
                isinstance(value.args[1], ast.Constant) and \
                value.args[1].value in self.sections:
            return value.args[1].value
        return None

    def _section_of(self, node: ast.AST) -> Optional[str]:
        """The section an expression denotes: ``cfg.<section>``, a local
        alias, or ``getattr(cfg, "section", ...)``."""
        sec = self._alias_of(node)
        if sec is not None:
            return sec
        if isinstance(node, ast.Name):
            return self.scope_aliases[-1].get(node.id)
        return None

    def visit_Call(self, node: ast.Call) -> None:
        # getattr(<section>, "key", default) is a read of section.key
        # (the defensive-access idiom, e.g. ft/elastic.py topology_path)
        if isinstance(node.func, ast.Name) and node.func.id == "getattr" \
                and len(node.args) >= 2 and \
                isinstance(node.args[1], ast.Constant) and \
                isinstance(node.args[1].value, str):
            sec = self._section_of(node.args[0])
            key = node.args[1].value
            if sec is not None:
                self.reads.add((sec, key))
                # a 2-arg getattr raises like a plain read; 3-arg is
                # defensive and never a typo finding
                if key not in self.sections[sec] and len(node.args) < 3:
                    self.findings.append(Finding(
                        self.path, node.lineno, node.col_offset, "CL101",
                        f"'{sec}.{key}' is not a field of the "
                        f"{sec!r} config section"))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        sec = self._alias_of(node.value)
        for t in node.targets:
            if isinstance(t, ast.Name):
                if sec is not None:
                    self.scope_aliases[-1][t.id] = sec
                else:
                    self.scope_aliases[-1].pop(t.id, None)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        sec: Optional[str] = None
        # cfg.<section>.<key>
        if isinstance(node.value, ast.Attribute) and \
                node.value.attr in self.sections and \
                _is_cfg_base(node.value.value):
            sec = node.value.attr
        # <alias>.<key> where alias = cfg.<section>
        elif isinstance(node.value, ast.Name) and \
                node.value.id in self.scope_aliases[-1]:
            sec = self.scope_aliases[-1][node.value.id]
        if sec is not None:
            key = node.attr
            self.reads.add((sec, key))
            if key not in self.sections[sec]:
                self.findings.append(Finding(
                    self.path, node.lineno, node.col_offset, "CL101",
                    f"'{sec}.{key}' is not a field of the "
                    f"{sec!r} config section (typo or removed knob — "
                    "this read raises AttributeError at runtime)"))
        self.generic_visit(node)


def _field_lines(config_path: str, classes: Dict[str, type]
                 ) -> Dict[Tuple[str, str], int]:
    """``{(section, key): line}`` of each field's AnnAssign in
    config.py."""
    with open(config_path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=config_path)
    by_clsname = {cls.__name__: sec for sec, cls in classes.items()}
    out: Dict[Tuple[str, str], int] = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name in by_clsname:
            sec = by_clsname[node.name]
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and \
                        isinstance(stmt.target, ast.Name):
                    out[(sec, stmt.target.id)] = stmt.lineno
    return out


def lint_paths(paths: Sequence[str],
               config_path: Optional[str] = None) -> List[Finding]:
    """CL101 over every ``.py`` under ``paths`` (except config.py
    itself — its generic getattr plumbing is not key usage), then CL201
    for declared-but-never-read keys, reported in config.py."""
    sections, classes = _section_schema()
    from mx_rcnn_tpu_torch import config as _cfgmod

    config_path = config_path or _cfgmod.__file__
    findings: List[Finding] = []
    reads: Set[Tuple[str, str]] = set()
    waivers_by_path: Dict[str, Dict] = {}
    for path in iter_py_files(paths):
        if os.path.abspath(path) == os.path.abspath(config_path):
            continue
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError) as e:
            print(f"configlint: cannot parse {path}: {e}", file=sys.stderr)
            continue
        waivers_by_path[path] = parse_waivers(source, "configlint")
        v = _Visitor(path, sections,
                     {cls.__name__: sec for sec, cls in classes.items()})
        v.visit(tree)
        findings.extend(v.findings)
        reads |= v.reads

    lines = _field_lines(config_path, classes)
    with open(config_path, "r", encoding="utf-8") as f:
        waivers_by_path[config_path] = parse_waivers(f.read(), "configlint")
    for (sec, key), line in sorted(lines.items()):
        if (sec, key) not in reads:
            findings.append(Finding(
                config_path, line, 0, "CL201",
                f"dead config key '{sec}.{key}': declared here but no "
                "code reads it — remove it or waive with the reason it "
                "must stay"))

    by_path: Dict[str, List[Finding]] = {}
    for f in findings:
        by_path.setdefault(f.path, []).append(f)
    out: List[Finding] = []
    for path, w in waivers_by_path.items():
        out.extend(apply_waivers(path, w, by_path.pop(path, []), RULES,
                                 prefix="CL", tool="configlint"))
    for rest in by_path.values():   # paths without any waivers
        out.extend(rest)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="configlint",
        description="config-key static analysis of the port")
    p.add_argument("paths", nargs="*", default=["mx_rcnn_tpu_torch"])
    p.add_argument("--json", action="store_true")
    p.add_argument("--show-waived", action="store_true")
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("--dump-keys", action="store_true",
                   help="print the section/key schema and exit")
    args = p.parse_args(argv)
    if args.list_rules:
        for code, desc in sorted(RULES.items()):
            print(f"{code}  {desc}")
        return 0
    if args.dump_keys:
        sections, _ = _section_schema()
        print(json.dumps({s: sorted(k) for s, k in sections.items()},
                         indent=1))
        return 0
    rc = check_paths_exist("configlint", args.paths)
    if rc is not None:
        return rc
    findings = lint_paths(args.paths)
    active = [f for f in findings if f.waived is None]
    waived = [f for f in findings if f.waived is not None]
    shown = findings if args.show_waived else active
    for f in shown:
        if args.json:
            print(json.dumps({"path": f.path, "line": f.line,
                              "col": f.col + 1, "code": f.code,
                              "message": f.message, "waived": f.waived}))
        else:
            print(f.render())
    print(f"configlint: {len(active)} finding(s), {len(waived)} waived",
          file=sys.stderr)
    return 1 if active else 0


if __name__ == "__main__":
    raise SystemExit(main())
