"""persistlint — AST linter for the port's durable-write surface (the
tmp → fsync → rename → dir-fsync → manifest-last idiom).

Counterpart of ``mx_rcnn_tpu/analysis/persistlint.py``: the same rules,
fragments and rule texts, so the two linters give the same findings on
the same source.  The port's checkpoints (``utils/checkpoint.py``), the
snapshot writer (``ft/snapshot.py``), export stores
(``serve/export.py``), bulk shards (``serve/bulk.py``) and run records
(``obs/runrec.py``) all claim one hand-maintained protocol: write to a
uniquely-staged tmp, fsync the file, rename over the target, fsync the
directory, and write the commit-point manifest LAST
(``utils/checkpoint.py — _atomic_write``).  persistlint checks the claim
from the AST; its runtime twin, ``analysis/crashsim.py``, records a real
workload's write ops and enumerates every crash state against the real
recovery paths (``tools/crashsim.py``).

The durable-path model (what counts as a durable artifact):

* a write is DURABLE when its path expression carries a durable
  artifact name — resolved through constants, f-strings, ``+``/``%``
  concatenation, ``os.path.join``, module-level string constants,
  ``self.<attr>`` assignments anywhere in the class, local assignments,
  and the RETURN expressions of called naming helpers
  (``checkpoint_path`` → ``.ckpt``, ``manifest_path`` →
  ``.manifest.json``, ``BulkSink.shard_path`` → ``shard-`` …) — the
  call-graph closure into the checkpoint/export/bulk/manifest writers;
* the durable fragments are ``manifest`` / ``.ckpt`` / ``.jaxexp`` /
  ``shard-`` / ``summary.json`` / ``events.jsonl`` (case-insensitive);
  everything else (bench reports, eval dumps, rebuildable pickles) is
  EPHEMERAL by inference — and anything inside the durable surface
  that is genuinely ephemeral takes a reasoned waiver;
* a ``manifest`` fragment additionally marks a write as a COMMIT-POINT
  write for the ordering rule.

Rule catalogue:

* PL101 — a raw write-mode ``open`` reaches a durable artifact path
  without going through ``utils/checkpoint.py — _atomic_write``.  The
  staging write of the atomic idiom itself (an ``open`` whose path is
  later the SOURCE of an ``os.replace``/``os.rename`` in the same
  function) is exempt — PL102/PL103/PL105 govern it instead.
* PL102 — ``os.rename``/``os.replace`` whose source was not fsynced
  first: the rename can persist while the data does not, publishing a
  torn file under the durable name.
* PL103 — rename without a following directory fsync: a host crash
  can lose the rename itself, so a commit the caller was told is
  durable silently vanishes (the bug the JAX store's ``finish`` once
  had).
* PL104 — manifest-ordering violation: a commit-point write placed
  before a payload write in the same function (intra-function
  statement order, with call-closure classification of helpers) —
  a crash between the two leaves a manifest naming files that do not
  exist yet.
* PL105 — a ``.tmp`` staging file with no exception-path cleanup (no
  enclosing ``try`` whose handler/finally unlinks it): failed writes
  leak staging files, and a non-uniquely-named orphan can be adopted
  by a later writer.
* PL201 — ``json.dump(s)`` of a sha-pinned or commit-point artifact
  without canonical ``sort_keys=True``: byte-identity invariants
  (manifest admission, fingerprints) must not depend on dict insertion
  order.

Waivers: same protocol as the other linters (``analysis/common.py``) —
``# persistlint: disable=PL101 <reason>`` on the line or the line
above; a reasonless waiver is PL001, an unknown rule PL002.

CLI::

    python -m mx_rcnn_tpu_torch.analysis.persistlint [paths...] [--json]
        [--show-waived] [--list-rules]

Exit status 0 iff no unwaived findings.
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
    "PL001": "waiver without a reason (every waiver must say why)",
    "PL002": "waiver names an unknown rule code",
    "PL101": "raw write-mode open of a durable artifact path (use "
             "utils/checkpoint._atomic_write)",
    "PL102": "os.rename/os.replace whose source was not fsynced",
    "PL103": "rename without a following directory fsync",
    "PL104": "commit-point (manifest) write before the payload it names",
    "PL105": "tmp staging file not cleaned up on exception paths",
    "PL201": "json.dump of a sha-pinned artifact without sort_keys=True",
}

# the durable-path model: fragments that mark a path as a durable
# artifact (the JAX linter's, kept so both linters agree; ``.jaxexp``
# never matches a port path)
DURABLE_FRAGMENTS = ("manifest", ".ckpt", ".jaxexp", "shard-",
                     "summary.json", "events.jsonl")
# fragments that additionally mark a COMMIT-POINT write (PL104)
COMMIT_FRAGMENTS = ("manifest",)

# the blessed atomic-write channel: calls to these (or to functions
# that transitively call them) are not raw writes
_ATOMIC_LEAVES = {"_atomic_write"}

_WRITE_MODES = ("w", "a", "x")


# --------------------------------------------------------------------------
# module model
# --------------------------------------------------------------------------

@dataclass
class FuncRec:
    qualname: str
    node: ast.AST
    cls: Optional[str] = None
    # constant fragments appearing in this function's return expressions
    return_frags: Set[str] = field(default_factory=set)
    # resolved direct callee keys ("<uid>:<qualname>")
    callees: Set[str] = field(default_factory=set)


@dataclass
class ModRec:
    path: str
    name: str
    uid: str
    tree: ast.Module
    aliases: Dict[str, str] = field(default_factory=dict)
    waivers: Dict[int, Tuple[Set[str], str]] = field(default_factory=dict)
    funcs: Dict[str, FuncRec] = field(default_factory=dict)
    # module-level NAME = "str" constants -> fragments
    const_frags: Dict[str, Set[str]] = field(default_factory=dict)
    # class -> {attr: fragments} from self.<attr> = <expr> assignments
    attr_frags: Dict[str, Dict[str, Set[str]]] = field(default_factory=dict)


class PCorpus:
    """Cross-module index for fragment resolution through naming
    helpers: top-level functions by name (when unambiguous) and methods
    by leaf name (when exactly one class defines them)."""

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
        print(f"persistlint: cannot parse {path}: {e}", file=sys.stderr)
        return None
    m = ModRec(path=path, name=os.path.basename(path)[:-3], uid=path,
               tree=tree)
    m.aliases = collect_import_aliases(tree)
    m.waivers = parse_waivers(source, "persistlint")
    return m


def _const_frags_of(node: ast.AST) -> Set[str]:
    """Literal string fragments syntactically inside an expression
    (constants, f-string parts) — no name resolution."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            out.add(sub.value.lower())
    return out


class _Collector(ast.NodeVisitor):
    """Pass 1: functions (with return fragments + callees), module
    string constants, per-class self-attr fragments."""

    def __init__(self, mod: ModRec):
        self.mod = mod
        self.cls_stack: List[str] = []
        self.func_stack: List[FuncRec] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.cls_stack.append(node.name)
        self.mod.attr_frags.setdefault(node.name, {})
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
        if self.func_stack and node.value is not None:
            self.func_stack[-1].return_frags |= _const_frags_of(node.value)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            if isinstance(t, ast.Name) and not self.func_stack \
                    and not self.cls_stack:
                frags = _const_frags_of(node.value)
                if frags:
                    self.mod.const_frags[t.id] = frags
            elif isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and \
                    t.value.id == "self" and self.cls_stack:
                frags = _const_frags_of(node.value)
                if frags:
                    self.mod.attr_frags[self.cls_stack[-1]].setdefault(
                        t.attr, set()).update(frags)
        self.generic_visit(node)


# --------------------------------------------------------------------------
# fragment resolution (the durable-path inference)
# --------------------------------------------------------------------------

class _Resolver:
    """Resolves a path expression to its constant string fragments,
    following local assignments, self-attrs, module constants and the
    return expressions of called naming helpers (depth-bounded)."""

    def __init__(self, mod: ModRec, fr: FuncRec, corpus: PCorpus):
        self.mod = mod
        self.fr = fr
        self.corpus = corpus
        # local name -> fragments, from every assignment in the function
        # (order-insensitive: staging paths are assigned before use)
        self.local_frags: Dict[str, Set[str]] = {}
        for sub in ast.walk(fr.node):
            if isinstance(sub, ast.Assign):
                frags = self.frags(sub.value, depth=1)
                for t in sub.targets:
                    if isinstance(t, ast.Name) and frags:
                        self.local_frags.setdefault(t.id,
                                                    set()).update(frags)

    def frags(self, node: ast.AST, depth: int = 0) -> Set[str]:
        if depth > 4 or node is None:
            return set()
        out: Set[str] = set()
        if isinstance(node, ast.Constant):
            if isinstance(node.value, str):
                out.add(node.value.lower())
            return out
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                out |= self.frags(v, depth + 1)
            return out
        if isinstance(node, ast.FormattedValue):
            return self.frags(node.value, depth + 1)
        if isinstance(node, ast.BinOp):
            return (self.frags(node.left, depth + 1)
                    | self.frags(node.right, depth + 1))
        if isinstance(node, ast.Name):
            if node.id in self.local_frags:
                out |= self.local_frags[node.id]
            if node.id in self.mod.const_frags:
                out |= self.mod.const_frags[node.id]
            alias = self.mod.aliases.get(node.id)
            if alias:  # ``from x import MANIFEST_NAME`` style constants
                for m in self.corpus.mods:
                    leaf = alias.rsplit(".", 1)[-1]
                    if leaf in m.const_frags:
                        out |= m.const_frags[leaf]
            return out
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and \
                    node.value.id == "self" and self.fr.cls:
                out |= self.mod.attr_frags.get(self.fr.cls, {}).get(
                    node.attr, set())
            return out
        if isinstance(node, ast.Call):
            # the call-graph closure into naming helpers: the callee's
            # return-expression fragments count, plus the args' own
            key = self._callee(node.func)
            if key is not None:
                out |= self.corpus.funcs[key].return_frags
            for a in node.args:
                out |= self.frags(a, depth + 1)
            return out
        if isinstance(node, (ast.Tuple, ast.List)):
            for e in node.elts:
                out |= self.frags(e, depth + 1)
        return out

    def _callee(self, func: ast.AST) -> Optional[str]:
        if isinstance(func, ast.Name):
            if func.id in self.mod.funcs:
                return f"{self.mod.uid}:{func.id}"
            alias = self.mod.aliases.get(func.id)
            leaf = (alias or func.id).rsplit(".", 1)[-1]
            return self.corpus.unique_leaf(leaf)
        if isinstance(func, ast.Attribute):
            # self.helper() within the same class, else unique leaf
            if isinstance(func.value, ast.Name) and \
                    func.value.id == "self" and self.fr.cls:
                q = f"{self.fr.cls}.{func.attr}"
                if q in self.mod.funcs:
                    return f"{self.mod.uid}:{q}"
            return self.corpus.unique_leaf(func.attr)
        return None


def _durable(frags: Set[str]) -> bool:
    return any(d in f for f in frags for d in DURABLE_FRAGMENTS)


def _commit(frags: Set[str]) -> bool:
    return any(c in f for f in frags for c in COMMIT_FRAGMENTS)


# --------------------------------------------------------------------------
# atomic-writer closure
# --------------------------------------------------------------------------

def _atomic_writer_keys(corpus: PCorpus) -> Set[str]:
    """Functions that ARE the atomic channel: ``_atomic_write`` and
    everything that transitively calls it."""
    keys = {k for k, fr in corpus.funcs.items()
            if fr.qualname.rsplit(".", 1)[-1] in _ATOMIC_LEAVES}
    changed = True
    while changed:
        changed = False
        for k, fr in corpus.funcs.items():
            if k in keys:
                continue
            if fr.callees & keys:
                keys.add(k)
                changed = True
    return keys


# --------------------------------------------------------------------------
# pass 2: per-function checks
# --------------------------------------------------------------------------

def _open_mode(call: ast.Call) -> Optional[str]:
    """The mode of an ``open`` call (positional or kwarg), None when not
    a constant (conservative: unknown modes are not flagged)."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return "r"
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value
    return None


def _is_write_mode(mode: Optional[str]) -> bool:
    return mode is not None and any(c in mode for c in _WRITE_MODES)


class _FuncCheck:
    """All per-function rule checks (one linear walk in statement
    order, mirroring the on-disk op order the function would emit)."""

    def __init__(self, mod: ModRec, fr: FuncRec, corpus: PCorpus,
                 atomic_keys: Set[str],
                 resolver: Optional[_Resolver] = None):
        self.mod = mod
        self.fr = fr
        self.corpus = corpus
        self.atomic_keys = atomic_keys
        self.res = resolver or _Resolver(mod, fr, corpus)
        self.findings: List[Finding] = []
        # collected call sites in lexical order
        self.opens: List[Tuple[ast.Call, Set[str], Optional[str]]] = []
        self.renames: List[Tuple[ast.Call, Optional[str], Set[str]]] = []
        # (node, is_dir, bound src name or None): a file fsync through a
        # with-alias fileno() binds to THAT staged file — one fsync must
        # never vouch for a second staged file's rename
        self.fsyncs: List[Tuple[ast.Call, bool, Optional[str]]] = []
        self.durable_writes: List[Tuple[int, bool]] = []  # (line, commit)
        # names assigned from os.open(...) — their fsync is a dir fsync
        self.osopen_names: Set[str] = set()
        # Name -> open-call line for write-mode opens (rename-src pairing)
        self.open_src_names: Dict[str, ast.Call] = {}
        self.tmp_opens: List[Tuple[ast.Call, Optional[str]]] = []

    # -- helpers ------------------------------------------------------------

    def _canon(self, func: ast.AST) -> str:
        return canonical(self.mod.aliases, func) or ""

    def _src_name(self, node: ast.AST) -> Optional[str]:
        return node.id if isinstance(node, ast.Name) else None

    def run(self) -> List[Finding]:
        node = self.fr.node
        # pre-pass: names assigned from os.open / write-mode open
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Assign, ast.withitem)):
                val = sub.value if isinstance(sub, ast.Assign) \
                    else sub.context_expr
                if isinstance(val, ast.Call) and \
                        self._canon(val.func) == "os.open":
                    tgts = sub.targets if isinstance(sub, ast.Assign) \
                        else [sub.optional_vars]
                    for t in tgts:
                        if isinstance(t, ast.Name):
                            self.osopen_names.add(t.id)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._classify_call(sub)
        self._check_pl101()
        self._check_pl102_pl103()
        self._check_pl104()
        self._check_pl105()
        return self.findings

    def _classify_call(self, call: ast.Call) -> None:
        canon = self._canon(call.func)
        if canon == "open" and call.args:
            mode = _open_mode(call)
            if _is_write_mode(mode):
                frags = self.res.frags(call.args[0])
                self.opens.append((call, frags, mode))
                src = self._src_name(call.args[0])
                if src:
                    self.open_src_names[src] = call
                if any(".tmp" in f for f in frags):
                    self.tmp_opens.append((call, src))
        elif canon in ("os.rename", "os.replace") and len(call.args) >= 2:
            frags = self.res.frags(call.args[1])
            self.renames.append((call, self._src_name(call.args[0]),
                                 frags))
            if _durable(frags):
                self.durable_writes.append((call.lineno, _commit(frags)))
        elif canon == "os.fsync" and call.args:
            arg = call.args[0]
            is_dir = isinstance(arg, ast.Name) and \
                arg.id in self.osopen_names
            self.fsyncs.append((call, is_dir, self._fsync_src(arg)))
        elif canon in ("json.dumps", "json.dump"):
            self._check_pl201(call, canon)
        else:
            key = self.res._callee(call.func)
            if key is not None and key in self.atomic_keys:
                # an atomic durable write: classify for PL104 ordering.
                # path-unresolvable atomic writes default to PAYLOAD (a
                # commit write is identified by its manifest fragment)
                frags = self.res.frags(call.args[0]) if call.args \
                    else set()
                commit = _commit(frags) or bool(
                    self.corpus.funcs[key].return_frags
                    and _commit(self.corpus.funcs[key].return_frags))
                # known commit-writer helpers: their NAME says manifest
                leaf = self.corpus.funcs[key].qualname.rsplit(
                    ".", 1)[-1].lower()
                commit = commit or "manifest" in leaf
                self.durable_writes.append((call.lineno, commit))

    # -- PL101 --------------------------------------------------------------

    def _check_pl101(self) -> None:
        if self._in_atomic_channel():
            return
        rename_srcs = {s for _, s, _ in self.renames if s}
        for call, frags, mode in self.opens:
            if not _durable(frags):
                continue
            src = self._src_name(call.args[0])
            if src and src in rename_srcs:
                continue  # the staging write of an atomic idiom
            self.findings.append(Finding(
                self.mod.path, call.lineno, call.col_offset, "PL101",
                f"raw open(..., {mode!r}) writes a durable artifact "
                "path — route it through utils/checkpoint._atomic_write "
                "(tmp -> fsync -> rename -> dir-fsync) or waive with the "
                "ephemeral/contract reason", self.fr.qualname))
            self.durable_writes.append((call.lineno, _commit(frags)))

    def _in_atomic_channel(self) -> bool:
        key = f"{self.mod.uid}:{self.fr.qualname}"
        fr = self.corpus.funcs.get(key)
        return fr is not None and fr.qualname.rsplit(
            ".", 1)[-1] in _ATOMIC_LEAVES

    # -- PL102 / PL103 ------------------------------------------------------

    def _fsync_src(self, arg: ast.AST) -> Optional[str]:
        """The staged-file NAME an ``os.fsync(f.fileno())`` vouches for,
        via the with-alias of the open that produced ``f`` (None when
        the fd expression is anything else)."""
        if isinstance(arg, ast.Call) and \
                isinstance(arg.func, ast.Attribute) and \
                arg.func.attr == "fileno" and \
                isinstance(arg.func.value, ast.Name):
            alias = arg.func.value.id
            for sub in ast.walk(self.fr.node):
                if not isinstance(sub, ast.With):
                    continue
                for item in sub.items:
                    if isinstance(item.optional_vars, ast.Name) and \
                            item.optional_vars.id == alias and \
                            isinstance(item.context_expr, ast.Call):
                        c = item.context_expr
                        if self._canon(c.func) == "open" and c.args:
                            return self._src_name(c.args[0])
        return None

    def _check_pl102_pl103(self) -> None:
        for call, src, frags in self.renames:
            file_sync_before = any(
                f.lineno <= call.lineno and not is_dir
                # bound fsyncs vouch only for their own staged file;
                # unbindable fd expressions stay a conservative match
                and (bound is None or src is None or bound == src)
                for f, is_dir, bound in self.fsyncs)
            if not file_sync_before:
                self.findings.append(Finding(
                    self.mod.path, call.lineno, call.col_offset, "PL102",
                    "rename source was never fsynced — the rename can "
                    "persist while the data does not, publishing a torn "
                    "file under the durable name", self.fr.qualname))
            dir_sync_after = any(
                f.lineno >= call.lineno and is_dir
                for f, is_dir, _bound in self.fsyncs)
            if not dir_sync_after:
                self.findings.append(Finding(
                    self.mod.path, call.lineno, call.col_offset, "PL103",
                    "rename without a following directory fsync — a host "
                    "crash can lose the rename, so a commit the caller "
                    "was told is durable silently vanishes",
                    self.fr.qualname))

    # -- PL104 --------------------------------------------------------------

    def _check_pl104(self) -> None:
        commits = [line for line, c in self.durable_writes if c]
        payloads = [line for line, c in self.durable_writes if not c]
        if commits and payloads and min(commits) < max(payloads):
            line = min(commits)
            self.findings.append(Finding(
                self.mod.path, line, 0, "PL104",
                "commit-point (manifest) write precedes a payload write "
                "in this function — a crash between the two leaves a "
                "manifest naming files that do not exist yet; the "
                "manifest must be written LAST", self.fr.qualname))

    # -- PL105 --------------------------------------------------------------

    def _check_pl105(self) -> None:
        if not self.tmp_opens:
            return
        # try blocks whose handler/finally unlink something
        cleanup_spans: List[Tuple[int, int]] = []
        for sub in ast.walk(self.fr.node):
            if not isinstance(sub, ast.Try):
                continue
            cleanup = []
            for h in sub.handlers:
                cleanup.extend(h.body)
            cleanup.extend(sub.finalbody)
            has_unlink = any(
                isinstance(c, ast.Call)
                and self._canon(c.func) in ("os.unlink", "os.remove")
                for stmt in cleanup for c in ast.walk(stmt))
            if has_unlink:
                end = max((s.end_lineno or s.lineno)
                          for s in sub.body) if sub.body else sub.lineno
                cleanup_spans.append((sub.lineno, end))
        for call, _src in self.tmp_opens:
            covered = any(a <= call.lineno <= b for a, b in cleanup_spans)
            if not covered:
                self.findings.append(Finding(
                    self.mod.path, call.lineno, call.col_offset, "PL105",
                    "tmp staging file is not cleaned up on exception "
                    "paths — wrap the write in try/except (unlink the "
                    "tmp, re-raise) and give concurrent writers "
                    "uniquely-named staging files (pid/thread suffix)",
                    self.fr.qualname))

    # -- PL201 --------------------------------------------------------------

    def _check_pl201(self, call: ast.Call, canon: str) -> None:
        for kw in call.keywords:
            if kw.arg == "sort_keys" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value:
                return
        if self._dump_is_pinned(call, canon):
            self.findings.append(Finding(
                self.mod.path, call.lineno, call.col_offset, "PL201",
                f"{canon} of a sha-pinned/commit artifact without "
                "sort_keys=True — byte identity must not depend on dict "
                "insertion order", self.fr.qualname))

    def _dump_is_pinned(self, call: ast.Call, canon: str) -> bool:
        """A dump is pinned when its bytes feed a hash or land on a
        commit-point path — found by scanning the enclosing expression
        tree (hashlib call / atomic write with a manifest path whose
        args contain this dump)."""
        for sub in ast.walk(self.fr.node):
            if not isinstance(sub, ast.Call) or sub is call:
                continue
            contains = any(inner is call for inner in ast.walk(sub))
            if not contains:
                continue
            c = self._canon(sub.func)
            if c.startswith("hashlib."):
                return True
            key = self.res._callee(sub.func)
            if key is not None and key in self.atomic_keys and sub.args:
                if _commit(self.res.frags(sub.args[0])):
                    return True
        # json.dump(obj, f) into a file opened on a commit path
        if canon == "json.dump" and len(call.args) >= 2:
            fname = self._src_name(call.args[1])
            for ocall, frags, _mode in self.opens:
                if _commit(frags):
                    with_name = self._with_alias(ocall)
                    if with_name and with_name == fname:
                        return True
        return False

    def _with_alias(self, ocall: ast.Call) -> Optional[str]:
        for sub in ast.walk(self.fr.node):
            if isinstance(sub, ast.With):
                for item in sub.items:
                    if item.context_expr is ocall and \
                            isinstance(item.optional_vars, ast.Name):
                        return item.optional_vars.id
        return None


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def analyze_paths(paths: Sequence[str]) -> List[Finding]:
    files = iter_py_files(paths)
    mods = [m for m in (_load(f) for f in files) if m is not None]
    for m in mods:
        _Collector(m).visit(m.tree)
        # callee edges for the atomic-writer closure
    corpus = PCorpus(mods)
    # one resolver per function, reused by the check pass (building the
    # local-fragment map walks the whole body — do it once, not twice)
    resolvers: Dict[str, _Resolver] = {}
    for m in mods:
        for q, fr in m.funcs.items():
            res = _Resolver(m, fr, corpus)
            resolvers[f"{m.uid}:{q}"] = res
            for sub in ast.walk(fr.node):
                if isinstance(sub, ast.Call):
                    key = res._callee(sub.func)
                    if key is not None:
                        fr.callees.add(key)
    atomic_keys = _atomic_writer_keys(corpus)
    findings: List[Finding] = []
    for m in mods:
        mod_findings: List[Finding] = []
        for q, fr in m.funcs.items():
            mod_findings.extend(
                _FuncCheck(m, fr, corpus, atomic_keys,
                           resolver=resolvers[f"{m.uid}:{q}"]).run())
        findings.extend(apply_waivers(m.path, m.waivers, mod_findings,
                                      RULES, prefix="PL",
                                      tool="persistlint"))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return findings


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    return analyze_paths(paths)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="persistlint",
        description="durability static analysis of the port")
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
    rc = check_paths_exist("persistlint", args.paths)
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
    print(f"persistlint: {len(active)} finding(s), {len(waived)} waived",
          file=sys.stderr)
    return 1 if active else 0


if __name__ == "__main__":
    raise SystemExit(main())
