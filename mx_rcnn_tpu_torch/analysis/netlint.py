"""netlint — AST linter for the port's network surface (sockets, HTTP,
the binary wire).

Counterpart of ``mx_rcnn_tpu/analysis/netlint.py``: the same rules, rule
texts, socket-allocation model and waiver protocol, so the two linters
give the same findings on the same source.  Bytes reach the port from
other machines through the MXR1/MXD1 wire (``serve/remote.py``), the
per-host agents' HTTP planes (``serve/agent.py``), remote metric scrapes
(``obs/collect.py — HttpSource``) and the scheduler's actuation calls
(``serve/scheduler.py — AgentAdmin``).  Every socket read there must be
bounded, timed out, and reject-never-crash by construction; netlint
checks that statically.  The runtime twin is ``analysis/wirefuzz.py``
(``tools/wirefuzz.py`` aims it at the real decoders and servers, with
planted-vulnerable arms proving it can see a fault).

The socket-allocation model (what netlint tracks):

* an ALLOCATION is ``socket.socket`` / ``socket.create_connection`` /
  ``http.client.HTTP(S)Connection`` / ``urllib.request.urlopen``, plus
  the derived objects: ``conn.getresponse()``, ``sock.accept()``,
  ``sock.makefile()`` (each inherits its source's timedness);
* an allocation is TIMED when the call carries a non-None ``timeout=``
  or the bound name later gets ``.settimeout(...)``; ``self.<attr>``
  allocations are tracked per class (an ``__init__`` that allocates
  untimed is visible to every method), and a function whose return
  expression is (or resolves to) an untimed allocation is an untimed
  *factory*, whose callers' bound names inherit that;
* BLOCKING OPS are ``connect / recv / recv_into / recvfrom / accept /
  makefile / send / sendall / request / getresponse / read / readline /
  readinto`` — each is flagged only on a name the model tracks, so
  file ``.read()`` and queue ``.send()`` never false-positive.

Rule catalogue:

* NL101 — blocking socket op on an allocation with no timeout: a
  half-open peer (SIGKILL'd host, black-holed route) wedges the
  calling thread forever.
* NL102 — socket/connection bound to a local name and used, but not
  closed on exception paths (no ``with``, no ``finally``/handler
  close) and never handed off (returned / stored on ``self`` or a
  container / passed to a callee): an exception between allocation
  and close leaks the fd.
* NL201 — ``struct.unpack``/``unpack_from`` (or a ``.unpack`` method)
  of a buffer with no preceding length check: a truncated frame dies
  as an untyped ``struct.error`` instead of the decoder's typed
  ValueError.
* NL202 — a length/count parsed off the wire (a target of an unpack
  assignment, or derived from one) sizes a recv/allocation
  (``recv(n)`` / ``read(n)`` / ``bytearray(n)`` / ``np.zeros`` /
  ``np.frombuffer(count=...)`` / ``b"x" * n``) with no bound against
  anything: a peer writing 2^31 into a length field makes this
  process allocate it.
* NL203 — unbounded response buffering: an argless ``.read()`` on a
  network response, or a byte-accumulating recv/read loop with no
  max-size comparison inside the loop (route through
  ``netio.read_limited``).
* NL204 — an HTTP handler body read (``...rfile.read``) that is
  argless or sized by a Content-Length-derived name that was never
  bounded (route through ``netio.read_request_body`` — 411/413/400).
* NL301 — a retry loop (a loop whose exception handler ``continue``\\ s)
  lacking backoff (``time.sleep``/``.wait`` in the loop) or an attempt
  cap (finite iterable / bounded while-test): retries without both
  turn one struggling peer into a self-inflicted flood.

Waivers: the protocol of the port's other linters
(``analysis/common.py``) — ``# netlint: disable=NL101 <reason>`` on the
line or the line above; a reasonless waiver is NL001, an unknown rule
NL002.

CLI::

    python -m mx_rcnn_tpu_torch.analysis.netlint [paths...] [--json]
        [--show-waived] [--list-rules]

The default path is the port; exit status 0 iff no unwaived findings.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from mx_rcnn_tpu_torch.analysis.common import (Finding, apply_waivers,
                                               canonical, check_paths_exist,
                                               collect_import_aliases,
                                               iter_py_files, parse_waivers)

RULES: Dict[str, str] = {
    "NL001": "waiver without a reason (every waiver must say why)",
    "NL002": "waiver names an unknown rule code",
    "NL101": "blocking socket op on an allocation with no timeout",
    "NL102": "socket/connection not closed on exception paths",
    "NL201": "struct.unpack of a buffer without a preceding length "
             "check",
    "NL202": "wire-derived length sizes a recv/allocation without a "
             "bound",
    "NL203": "unbounded response read (argless .read() or uncapped "
             "accumulation loop)",
    "NL204": "HTTP handler body read without a Content-Length bound",
    "NL301": "retry loop without both backoff and an attempt cap",
}

# canonical allocator name -> (kind, index of timeout coverage)
_ALLOCATORS: Dict[str, str] = {
    "socket.socket": "socket",
    "socket.create_connection": "socket",
    "http.client.HTTPConnection": "conn",
    "http.client.HTTPSConnection": "conn",
    "urllib.request.urlopen": "resp",
}
# allocators whose CALL can carry timeout= (socket.socket cannot — it
# needs a later .settimeout)
_TIMEOUT_KWARG = {"socket.create_connection",
                  "http.client.HTTPConnection",
                  "http.client.HTTPSConnection",
                  "urllib.request.urlopen"}

# attr ops that derive a new tracked object from an existing one,
# inheriting its timedness
_DERIVERS = {"getresponse": "resp", "accept": "socket",
             "makefile": "resp"}

# blocking ops, flagged ONLY on tracked untimed names (NL101)
_BLOCKING_OPS = {"connect", "recv", "recv_into", "recvfrom", "accept",
                 "makefile", "send", "sendall", "request",
                 "getresponse", "read", "readline", "readinto"}

# wire-length allocation sinks (NL202): canonical call names whose
# positional size argument must be bounded first
_ALLOC_SINKS = {"bytearray", "bytes", "numpy.zeros", "numpy.empty",
                "numpy.ones", "numpy.full", "numpy.frombuffer"}
# attr-call sinks: .recv(n) / .read(n) with a wire-derived n
_ATTR_SINKS = {"recv", "read"}


# --------------------------------------------------------------------------
# module model
# --------------------------------------------------------------------------

@dataclass
class FuncRec:
    qualname: str
    node: ast.AST
    cls: Optional[str] = None
    # resolved direct callee keys ("<uid>:<qualname>")
    callees: Set[str] = field(default_factory=set)
    # (kind, timed) when the function's return expression is a tracked
    # network allocation — the factory closure (None = not a factory)
    net_return: Optional[Tuple[str, bool]] = None
    # callee leaf names appearing in return expressions, for the
    # factory fixpoint ("return make_conn()")
    return_callee_keys: Set[str] = field(default_factory=set)


@dataclass
class ModRec:
    path: str
    name: str
    uid: str
    tree: ast.Module
    aliases: Dict[str, str] = field(default_factory=dict)
    waivers: Dict[int, Tuple[Set[str], str]] = field(default_factory=dict)
    funcs: Dict[str, FuncRec] = field(default_factory=dict)
    # class -> {attr: (kind, timed)} from self.<attr> = <allocator>
    net_attrs: Dict[str, Dict[str, Tuple[str, bool]]] = field(
        default_factory=dict)
    # class -> set of base-name dotted strings
    bases: Dict[str, Set[str]] = field(default_factory=dict)


class NCorpus:
    """Cross-module function index (persistlint's PCorpus shape):
    top-level functions by qualname, methods resolvable by unique leaf
    — the closure channel for untimed-factory inference."""

    def __init__(self, mods: List[ModRec]):
        self.mods = mods
        self.funcs: Dict[str, FuncRec] = {}
        self.by_leaf: Dict[str, List[str]] = {}
        for m in mods:
            for q, fr in m.funcs.items():
                key = f"{m.uid}:{q}"
                self.funcs[key] = fr
                self.by_leaf.setdefault(q.rsplit(".", 1)[-1],
                                        []).append(key)

    def unique_leaf(self, leaf: str) -> Optional[str]:
        cands = self.by_leaf.get(leaf, [])
        return cands[0] if len(cands) == 1 else None


def _load(path: str) -> Optional[ModRec]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError) as e:
        print(f"netlint: cannot parse {path}: {e}", file=sys.stderr)
        return None
    m = ModRec(path=path, name=os.path.basename(path)[:-3], uid=path,
               tree=tree)
    m.aliases = collect_import_aliases(tree)
    m.waivers = parse_waivers(source, "netlint")
    return m


def _alloc_of(call: ast.Call, aliases: Dict[str, str]
              ) -> Optional[Tuple[str, bool]]:
    """(kind, timed-at-call) when ``call`` is a tracked allocator."""
    canon = canonical(aliases, call.func) or ""
    kind = _ALLOCATORS.get(canon)
    if kind is None:
        return None
    timed = False
    if canon in _TIMEOUT_KWARG:
        for kw in call.keywords:
            if kw.arg == "timeout":
                timed = not (isinstance(kw.value, ast.Constant)
                             and kw.value.value is None)
    return kind, timed


class _Collector(ast.NodeVisitor):
    """Pass 1: functions, class bases, per-class self-attr network
    allocations (+ their later settimeouts), factory returns."""

    def __init__(self, mod: ModRec):
        self.mod = mod
        self.cls_stack: List[str] = []
        self.func_stack: List[FuncRec] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.cls_stack.append(node.name)
        self.mod.net_attrs.setdefault(node.name, {})
        bases = set()
        for b in node.bases:
            d = canonical(self.mod.aliases, b)
            if d:
                bases.add(d)
        self.mod.bases[node.name] = bases
        self.generic_visit(node)
        self.cls_stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if self.func_stack:
            qual = f"{self.func_stack[-1].qualname}.{node.name}"
        elif self.cls_stack:
            qual = f"{self.cls_stack[-1]}.{node.name}"
        else:
            qual = node.name
        fr = FuncRec(qualname=qual, node=node,
                     cls=self.cls_stack[-1] if self.cls_stack else None)
        self.mod.funcs[qual] = fr
        self.func_stack.append(fr)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Return(self, node: ast.Return) -> None:
        if self.func_stack and isinstance(node.value, ast.Call):
            fr = self.func_stack[-1]
            alloc = _alloc_of(node.value, self.mod.aliases)
            if alloc is not None:
                fr.net_return = alloc
            elif isinstance(node.value.func, ast.Name):
                fr.return_callee_keys.add(node.value.func.id)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        # self.<attr> = <allocator>: class-level untimed-socket record
        if self.cls_stack and isinstance(node.value, ast.Call):
            alloc = _alloc_of(node.value, self.mod.aliases)
            if alloc is not None:
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        self.mod.net_attrs[self.cls_stack[-1]][t.attr] \
                            = alloc
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        # self.<attr>.settimeout(x) anywhere in the class marks the
        # attr timed (order-insensitive, conservative)
        if self.cls_stack and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "settimeout" \
                and isinstance(node.func.value, ast.Attribute) \
                and isinstance(node.func.value.value, ast.Name) \
                and node.func.value.value.id == "self":
            attrs = self.mod.net_attrs[self.cls_stack[-1]]
            attr = node.func.value.attr
            if attr in attrs:
                attrs[attr] = (attrs[attr][0], True)
        self.generic_visit(node)


def _factory_fixpoint(corpus: NCorpus) -> None:
    """Propagate net_return through ``return helper()`` chains."""
    changed = True
    while changed:
        changed = False
        for m in corpus.mods:
            for fr in m.funcs.values():
                if fr.net_return is not None:
                    continue
                for leaf in fr.return_callee_keys:
                    key = (f"{m.uid}:{leaf}" if leaf in m.funcs
                           else corpus.unique_leaf(leaf))
                    sub = corpus.funcs.get(key) if key else None
                    if sub is not None and sub.net_return is not None:
                        fr.net_return = sub.net_return
                        changed = True
                        break


# --------------------------------------------------------------------------
# pass 2: per-function checks
# --------------------------------------------------------------------------

def _name_of(node: ast.AST) -> Optional[str]:
    return node.id if isinstance(node, ast.Name) else None


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _walk_own(root: ast.AST):
    """ast.walk that does NOT descend into nested function/class
    definitions — those are linted as their own FuncRecs, so walking
    them here would double-report every finding."""
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            stack.append(child)


def _loop_own(loop: ast.AST):
    """Walk a loop's body without descending into NESTED loops (or
    defs): an inner retry/accumulation loop is judged on its own, not
    re-attributed to every enclosing loop."""
    stack = list(ast.iter_child_nodes(loop))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.While, ast.For, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


class _FuncCheck:
    """All per-function rule checks."""

    def __init__(self, mod: ModRec, fr: FuncRec, corpus: NCorpus):
        self.mod = mod
        self.fr = fr
        self.corpus = corpus
        self.findings: List[Finding] = []
        # tracked net objects: name -> {kind, timed, line, col,
        #                               with_bound}
        self.net: Dict[str, Dict] = {}
        self._collect_net_objects()

    def _canon(self, func: ast.AST) -> str:
        return canonical(self.mod.aliases, func) or ""

    # -- allocation tracking ------------------------------------------------

    def _factory_alloc(self, call: ast.Call
                       ) -> Optional[Tuple[str, bool]]:
        """A call to a local/unique function whose return is a tracked
        allocation — the helper closure."""
        fn = call.func
        key = None
        if isinstance(fn, ast.Name):
            if fn.id in self.mod.funcs:
                key = f"{self.mod.uid}:{fn.id}"
            else:
                key = self.corpus.unique_leaf(fn.id)
        elif isinstance(fn, ast.Attribute):
            if isinstance(fn.value, ast.Name) and fn.value.id == "self" \
                    and self.fr.cls:
                q = f"{self.fr.cls}.{fn.attr}"
                if q in self.mod.funcs:
                    key = f"{self.mod.uid}:{q}"
            if key is None:
                key = self.corpus.unique_leaf(fn.attr)
        rec = self.corpus.funcs.get(key) if key else None
        return rec.net_return if rec is not None else None

    def _track(self, name: str, kind: str, timed: bool,
               node: ast.AST, with_bound: bool) -> None:
        self.net[name] = {"kind": kind, "timed": timed,
                          "line": node.lineno, "col": node.col_offset,
                          "with": with_bound}

    def _collect_net_objects(self) -> None:
        # source order: derivations (r = conn.getresponse()) must see
        # their source already tracked, so the allocation sweep cannot
        # run in raw stack-walk order
        walk = sorted(_walk_own(self.fr.node),
                      key=lambda n: (getattr(n, "lineno", 0),
                                     getattr(n, "col_offset", 0)))
        for sub in walk:
            if isinstance(sub, ast.Assign) and \
                    isinstance(sub.value, ast.Call):
                alloc = (_alloc_of(sub.value, self.mod.aliases)
                         or self._factory_alloc(sub.value)
                         or self._derived_alloc(sub.value))
                if alloc is None:
                    continue
                kind, timed = alloc
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        self._track(t.id, kind, timed, sub.value, False)
                    elif isinstance(t, ast.Tuple) and t.elts and \
                            isinstance(t.elts[0], ast.Name):
                        # s2, addr = sock.accept()
                        self._track(t.elts[0].id, kind, timed,
                                    sub.value, False)
            elif isinstance(sub, ast.With):
                for item in sub.items:
                    if not isinstance(item.context_expr, ast.Call):
                        continue
                    alloc = (_alloc_of(item.context_expr,
                                       self.mod.aliases)
                             or self._factory_alloc(item.context_expr)
                             or self._derived_alloc(item.context_expr))
                    if alloc is None:
                        continue
                    kind, timed = alloc
                    if isinstance(item.optional_vars, ast.Name):
                        self._track(item.optional_vars.id, kind, timed,
                                    item.context_expr, True)
        # later .settimeout(x) on a tracked name marks it timed
        for sub in walk:
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr == "settimeout":
                tgt = _name_of(sub.func.value)
                if tgt in self.net and not (
                        sub.args
                        and isinstance(sub.args[0], ast.Constant)
                        and sub.args[0].value is None):
                    self.net[tgt]["timed"] = True

    def _derived_alloc(self, call: ast.Call
                       ) -> Optional[Tuple[str, bool]]:
        """conn.getresponse() / sock.accept() / sock.makefile() on a
        tracked name: a new tracked object inheriting timedness."""
        fn = call.func
        if not (isinstance(fn, ast.Attribute)
                and fn.attr in _DERIVERS):
            return None
        src = _name_of(fn.value)
        rec = self.net.get(src) if src else None
        if rec is None:
            rec = self._self_attr_rec(fn.value)
        if rec is None:
            return None
        return _DERIVERS[fn.attr], bool(rec["timed"]) \
            if isinstance(rec, dict) else rec[1]

    def _self_attr_rec(self, node: ast.AST):
        """(kind, timed) for ``self.<attr>`` network attrs."""
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self" and self.fr.cls:
            return self.mod.net_attrs.get(self.fr.cls, {}).get(node.attr)
        return None

    # -- driver -------------------------------------------------------------

    def run(self) -> List[Finding]:
        self._check_nl101()
        self._check_nl102()
        self._check_nl201()
        self._check_nl202_nl204()
        self._check_nl203()
        self._check_nl301()
        return self.findings

    def _emit(self, node: ast.AST, code: str, msg: str) -> None:
        self.findings.append(Finding(
            self.mod.path, node.lineno, node.col_offset, code, msg,
            self.fr.qualname))

    # -- NL101 --------------------------------------------------------------

    def _check_nl101(self) -> None:
        for sub in _walk_own(self.fr.node):
            if not (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _BLOCKING_OPS):
                continue
            recv = sub.func.value
            name = _name_of(recv)
            rec = self.net.get(name) if name else None
            if rec is not None:
                if not rec["timed"]:
                    self._emit(sub, "NL101",
                               f"blocking .{sub.func.attr}() on "
                               f"{name!r}, allocated with no timeout "
                               f"(line {rec['line']}) — a half-open "
                               "peer wedges this thread forever")
                continue
            attr_rec = self._self_attr_rec(recv)
            if attr_rec is not None and not attr_rec[1]:
                self._emit(sub, "NL101",
                           f"blocking .{sub.func.attr}() on untimed "
                           f"self.{recv.attr} (allocated in this class "
                           "with no timeout/settimeout)")

    # -- NL102 --------------------------------------------------------------

    def _check_nl102(self) -> None:
        # names closed in finally / except handlers
        safe_closed: Set[str] = set()
        for sub in _walk_own(self.fr.node):
            if not isinstance(sub, ast.Try):
                continue
            cleanup = list(sub.finalbody)
            for h in sub.handlers:
                cleanup.extend(h.body)
            for stmt in cleanup:
                for c in ast.walk(stmt):
                    if isinstance(c, ast.Call) and \
                            isinstance(c.func, ast.Attribute) and \
                            c.func.attr == "close":
                        nm = _name_of(c.func.value)
                        if nm:
                            safe_closed.add(nm)
        handed_off: Set[str] = set()
        used: Set[str] = set()
        for sub in _walk_own(self.fr.node):
            if isinstance(sub, ast.Return) and sub.value is not None:
                handed_off |= _names_in(sub.value)
            elif isinstance(sub, ast.Assign):
                # self.x = s / container[i] = s: ownership transfer
                if any(isinstance(t, (ast.Attribute, ast.Subscript))
                       for t in sub.targets):
                    handed_off |= _names_in(sub.value)
            elif isinstance(sub, ast.Call):
                for a in list(sub.args) + [kw.value
                                           for kw in sub.keywords]:
                    handed_off |= _names_in(a)
                if isinstance(sub.func, ast.Attribute):
                    nm = _name_of(sub.func.value)
                    if nm:
                        used.add(nm)
        for name, rec in self.net.items():
            if rec["with"] or name in safe_closed \
                    or name in handed_off or name not in used:
                continue
            self._emit_at(rec, "NL102",
                          f"{name!r} ({rec['kind']}) is used but never "
                          "closed on exception paths — bind it in a "
                          "'with', or close it in a finally/handler, "
                          "or hand ownership off")

    def _emit_at(self, rec: Dict, code: str, msg: str) -> None:
        self.findings.append(Finding(
            self.mod.path, rec["line"], rec["col"], code, msg,
            self.fr.qualname))

    # -- NL201 --------------------------------------------------------------

    def _len_checked_names(self) -> Dict[str, int]:
        """{buffer name: first line where a Compare involves its
        length} — ``len(buf)`` inside any comparison, directly or via
        a ``v = len(buf)`` alias, or a bare ``if not buf`` guard."""
        len_alias: Dict[str, str] = {}  # alias var -> buffer name
        for sub in _walk_own(self.fr.node):
            if isinstance(sub, ast.Assign) and \
                    isinstance(sub.value, ast.Call) and \
                    isinstance(sub.value.func, ast.Name) and \
                    sub.value.func.id == "len" and sub.value.args:
                buf = _name_of(sub.value.args[0])
                tgt = (_name_of(sub.targets[0])
                       if len(sub.targets) == 1 else None)
                if buf and tgt:
                    len_alias[tgt] = buf
        checked: Dict[str, int] = {}

        def note(name: Optional[str], line: int) -> None:
            if name and (name not in checked or line < checked[name]):
                checked[name] = line

        for sub in _walk_own(self.fr.node):
            if isinstance(sub, ast.Compare):
                for inner in ast.walk(sub):
                    if isinstance(inner, ast.Call) and \
                            isinstance(inner.func, ast.Name) and \
                            inner.func.id == "len" and inner.args:
                        note(_name_of(inner.args[0]), sub.lineno)
                    elif isinstance(inner, ast.Name) and \
                            inner.id in len_alias:
                        note(len_alias[inner.id], sub.lineno)
            elif isinstance(sub, ast.UnaryOp) and \
                    isinstance(sub.op, ast.Not):
                note(_name_of(sub.operand), sub.lineno)
        return checked

    def _unpack_calls(self) -> List[Tuple[ast.Call, Optional[str]]]:
        """(call, buffer name) for struct.unpack/unpack_from and
        Struct-instance .unpack/.unpack_from calls."""
        out = []
        for sub in _walk_own(self.fr.node):
            if not (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in ("unpack", "unpack_from")):
                continue
            canon = self._canon(sub.func)
            idx = 1 if canon.startswith("struct.") else 0
            buf = sub.args[idx] if len(sub.args) > idx else None
            if isinstance(buf, ast.Subscript):
                buf = buf.value
            out.append((sub, _name_of(buf) if buf is not None
                        else None))
        return out

    def _check_nl201(self) -> None:
        unpacks = self._unpack_calls()
        if not unpacks:
            return
        checked = self._len_checked_names()
        for call, buf in unpacks:
            if buf is None:
                continue
            if buf in checked and checked[buf] <= call.lineno:
                continue
            self._emit(call, "NL201",
                       f"struct unpack of {buf!r} with no preceding "
                       "length check — a truncated frame dies as an "
                       "untyped struct.error instead of the decoder's "
                       "typed ValueError")

    # -- NL202 / NL204 ------------------------------------------------------

    def _derivation(self, seeds: Set[str]) -> Set[str]:
        """Closure of ``seeds`` through assignments (both directions
        collapse into one component: a check on ``nbytes = k * 20``
        clears ``k`` and vice versa)."""
        derived = set(seeds)
        changed = True
        while changed:
            changed = False
            for sub in _walk_own(self.fr.node):
                if not isinstance(sub, ast.Assign):
                    continue
                tgts = {t.id for t in sub.targets
                        if isinstance(t, ast.Name)}
                srcs = _names_in(sub.value)
                if (srcs & derived and not tgts <= derived) or \
                        (tgts & derived and not srcs <= derived):
                    if srcs & derived:
                        new = tgts - derived
                    else:
                        new = srcs - derived
                    if new:
                        derived |= new
                        changed = True
        return derived

    def _compare_lines(self, names: Set[str]) -> List[int]:
        out = []
        for sub in _walk_own(self.fr.node):
            if isinstance(sub, ast.Compare) and \
                    _names_in(sub) & names:
                out.append(sub.lineno)
        return out

    def _wire_names(self) -> Set[str]:
        """Targets of assignments whose value contains an unpack call
        or int.from_bytes — lengths/counts parsed off the wire."""
        out: Set[str] = set()
        for sub in _walk_own(self.fr.node):
            if not isinstance(sub, ast.Assign):
                continue
            has_unpack = any(
                isinstance(c, ast.Call)
                and isinstance(c.func, ast.Attribute)
                and c.func.attr in ("unpack", "unpack_from",
                                    "from_bytes")
                for c in ast.walk(sub.value))
            if not has_unpack:
                continue
            for t in sub.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    out |= {e.id for e in t.elts
                            if isinstance(e, ast.Name)}
        return out

    def _check_nl202_nl204(self) -> None:
        wire = self._wire_names()
        if wire:
            component = self._derivation(wire)
            cmp_lines = self._compare_lines(component)
            for call, size_names, what in self._size_sinks():
                hot = size_names & component
                if not hot:
                    continue
                if any(ln <= call.lineno for ln in cmp_lines):
                    continue
                self._emit(call, "NL202",
                           f"wire-derived length {sorted(hot)} sizes "
                           f"{what} with no bound checked first — a "
                           "peer writing 2^31 into a length field "
                           "makes this process allocate it")
        self._check_nl204()

    def _size_sinks(self
                    ) -> List[Tuple[ast.Call, Set[str], str]]:
        """(call, names inside its size expression, description) for
        every allocation-ish sink in the function."""
        out = []
        for sub in _walk_own(self.fr.node):
            if isinstance(sub, ast.Call):
                canon = self._canon(sub.func)
                if canon in _ALLOC_SINKS:
                    names: Set[str] = set()
                    if sub.args:
                        names |= _names_in(sub.args[0])
                    for kw in sub.keywords:
                        if kw.arg in ("count", "shape"):
                            names |= _names_in(kw.value)
                    out.append((sub, names, f"{canon}()"))
                elif isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr in _ATTR_SINKS and sub.args:
                    out.append((sub, _names_in(sub.args[0]),
                                f".{sub.func.attr}()"))
            elif isinstance(sub, ast.BinOp) and \
                    isinstance(sub.op, ast.Mult):
                # b"\0" * n — bytes/str repetition sized off the wire
                for side, other in ((sub.left, sub.right),
                                    (sub.right, sub.left)):
                    if isinstance(side, ast.Constant) and \
                            isinstance(side.value, (bytes, str)):
                        fake = ast.Call(func=ast.Name(id="_mul",
                                                      ctx=ast.Load()),
                                        args=[], keywords=[])
                        fake.lineno = sub.lineno
                        fake.col_offset = sub.col_offset
                        out.append((fake, _names_in(other),
                                    "a bytes repetition"))
        return out

    # -- NL204 --------------------------------------------------------------

    def _check_nl204(self) -> None:
        # names derived from self.headers (Content-Length parses)
        header_seeds: Set[str] = set()
        for sub in _walk_own(self.fr.node):
            if not isinstance(sub, ast.Assign):
                continue
            from_headers = any(
                isinstance(a, ast.Attribute) and a.attr == "headers"
                for a in ast.walk(sub.value))
            if from_headers:
                header_seeds |= {t.id for t in sub.targets
                                 if isinstance(t, ast.Name)}
        component = (self._derivation(header_seeds)
                     if header_seeds else set())
        cmp_lines = self._compare_lines(component) if component else []
        for sub in _walk_own(self.fr.node):
            if not (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "read"
                    and isinstance(sub.func.value, ast.Attribute)
                    and sub.func.value.attr == "rfile"):
                continue
            if not sub.args:
                self._emit(sub, "NL204",
                           "argless rfile.read() in an HTTP handler — "
                           "route the body through "
                           "netio.read_request_body (411/413/400)")
                continue
            names = _names_in(sub.args[0])
            hot = names & component
            if hot and not any(ln <= sub.lineno for ln in cmp_lines):
                self._emit(sub, "NL204",
                           f"rfile.read sized by Content-Length-"
                           f"derived {sorted(hot)} with no bound "
                           "checked first — a multi-GB claimed length "
                           "is read whole (use "
                           "netio.read_request_body)")

    # -- NL203 --------------------------------------------------------------

    def _check_nl203(self) -> None:
        # (a) argless .read() on a tracked network response
        for sub in _walk_own(self.fr.node):
            if not (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "read"
                    and not sub.args and not sub.keywords):
                continue
            name = _name_of(sub.func.value)
            rec = self.net.get(name) if name else None
            is_resp = (rec is not None and rec["kind"] == "resp")
            if not is_resp:
                attr_rec = self._self_attr_rec(sub.func.value)
                is_resp = attr_rec is not None and attr_rec[0] == "resp"
            if is_resp:
                self._emit(sub, "NL203",
                           "argless .read() buffers the whole response "
                           "— a peer can stream unbounded bytes into "
                           "this process (use netio.read_limited)")
        # (b) uncapped byte-accumulation loops
        for loop in _walk_own(self.fr.node):
            if not isinstance(loop, (ast.While, ast.For)):
                continue
            # names assigned inside the loop from a recv/read call
            chunk_names: Set[str] = set()
            for sub in _loop_own(loop):
                if isinstance(sub, ast.Assign) and \
                        self._is_recv_read(sub.value):
                    chunk_names |= {t.id for t in sub.targets
                                    if isinstance(t, ast.Name)}
            accums = []
            for sub in _loop_own(loop):
                if not (isinstance(sub, ast.AugAssign)
                        and isinstance(sub.op, ast.Add)
                        and isinstance(sub.target, ast.Name)):
                    continue
                feeds = (self._is_recv_read(sub.value)
                         or _names_in(sub.value) & chunk_names)
                if feeds:
                    accums.append(sub)
            if not accums:
                continue
            acc_names = {a.target.id for a in accums}
            capped = any(
                isinstance(sub, ast.Compare)
                and _names_in(sub) & acc_names
                for sub in _loop_own(loop))
            if not capped:
                for a in accums:
                    self._emit(a, "NL203",
                               f"{a.target.id!r} accumulates "
                               "recv/read bytes with no max-size "
                               "comparison in the loop (use "
                               "netio.read_limited)")

    def _is_recv_read(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("recv", "read", "recv_into",
                                       "recvfrom"))

    # -- NL301 --------------------------------------------------------------

    def _check_nl301(self) -> None:
        for loop in _walk_own(self.fr.node):
            if not isinstance(loop, (ast.While, ast.For)):
                continue
            # a NETWORK retry loop: an exception handler inside it
            # that explicitly `continue`s (service loops that merely
            # log and fall through are not retries), guarding a try
            # body that actually touches the network (parse-retry
            # loops over files/strings are not this rule's business)
            retries = False
            for sub in _loop_own(loop):
                if isinstance(sub, ast.Try):
                    handler_continues = any(
                        isinstance(s, ast.Continue)
                        for h in sub.handlers
                        for stmt in h.body
                        for s in ast.walk(stmt))
                    if handler_continues and self._try_is_net(sub):
                        retries = True
            if not retries:
                continue
            backoff = any(
                isinstance(sub, ast.Call)
                and (self._canon(sub.func) == "time.sleep"
                     or (isinstance(sub.func, ast.Attribute)
                         and sub.func.attr in ("sleep", "wait")))
                for sub in _loop_own(loop))
            capped = self._loop_capped(loop)
            if backoff and capped:
                continue
            missing = []
            if not backoff:
                missing.append("backoff")
            if not capped:
                missing.append("an attempt cap")
            self._emit(loop, "NL301",
                       f"retry loop without {' or '.join(missing)} — "
                       "retries need BOTH (exponential sleep + finite "
                       "attempts) or one struggling peer becomes a "
                       "self-inflicted flood")

    _NET_OPS = {"request", "getresponse", "recv", "recv_into",
                "recvfrom", "connect", "sendall", "urlopen"}

    def _try_is_net(self, tr: ast.Try) -> bool:
        for stmt in tr.body:
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Call):
                    continue
                canon = self._canon(sub.func)
                if canon in ("urllib.request.urlopen",
                             "socket.create_connection"):
                    return True
                if isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr in self._NET_OPS:
                    return True
        return False

    def _loop_capped(self, loop: ast.AST) -> bool:
        if isinstance(loop, ast.For):
            it = loop.iter
            if isinstance(it, (ast.Tuple, ast.List)):
                return True  # finite literal
            if isinstance(it, ast.Call) and \
                    isinstance(it.func, ast.Name) and \
                    it.func.id in ("range", "enumerate", "reversed"):
                return True
            return False
        test = loop.test
        if isinstance(test, ast.Constant) and test.value:
            return False  # while True
        # any non-trivially-true test reads as a bounded condition
        return not isinstance(test, ast.Constant)


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def analyze_paths(paths: Sequence[str]) -> List[Finding]:
    files = iter_py_files(paths)
    mods = [m for m in (_load(f) for f in files) if m is not None]
    for m in mods:
        _Collector(m).visit(m.tree)
    corpus = NCorpus(mods)
    _factory_fixpoint(corpus)
    findings: List[Finding] = []
    for m in mods:
        mod_findings: List[Finding] = []
        for q, fr in m.funcs.items():
            mod_findings.extend(_FuncCheck(m, fr, corpus).run())
        findings.extend(apply_waivers(m.path, m.waivers, mod_findings,
                                      RULES, prefix="NL",
                                      tool="netlint"))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return findings


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    return analyze_paths(paths)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="netlint",
        description="network-surface static analysis of the port")
    p.add_argument("paths", nargs="*", default=["mx_rcnn_tpu_torch"],
                   help="files or directories to lint")
    p.add_argument("--json", action="store_true",
                   help="emit findings as JSON records")
    p.add_argument("--show-waived", action="store_true",
                   help="also print waived findings")
    p.add_argument("--list-rules", action="store_true")
    args = p.parse_args(argv)
    if args.list_rules:
        for code, desc in sorted(RULES.items()):
            print(f"{code}  {desc}")
        return 0
    rc = check_paths_exist("netlint", args.paths)
    if rc is not None:
        return rc
    findings = lint_paths(args.paths)
    active = [f for f in findings if f.waived is None]
    waived = [f for f in findings if f.waived is not None]
    shown = findings if args.show_waived else active
    if args.json:
        for f in shown:
            print(json.dumps({"path": f.path, "line": f.line,
                              "col": f.col + 1, "code": f.code,
                              "message": f.message, "func": f.func,
                              "waived": f.waived}))
    else:
        for f in shown:
            print(f.render())
    print(f"netlint: {len(active)} finding(s), {len(waived)} waived",
          file=sys.stderr)
    return 1 if active else 0


if __name__ == "__main__":
    raise SystemExit(main())
