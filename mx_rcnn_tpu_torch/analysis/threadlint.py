"""threadlint — AST linter for the port's concurrency surface (locks,
threads, signal handlers).

Counterpart of ``mx_rcnn_tpu/analysis/threadlint.py``: the same rules,
rule texts, lock identities, waiver protocol and graph dump, so the two
linters give the same findings on the same source.  The port's serving
queue and engine, fleet, scheduler, snapshot writer, supervisor, obs
plane and decode pool all hold locks and run threads; the runtime twin
is the opt-in lock sanitizer (``analysis/sanitizer.py``), which records
REAL acquisition order on the paths the smokes drive.  threadlint sees
every path, driven or not.

What the port adds to the JAX linter's names (strings read from source
text, never imports):

* TL301 counts ``torch.cuda.synchronize`` and the ``.synchronize()``
  method of a CUDA event or stream as blocking calls, as it counts
  ``jax.block_until_ready`` and ``.block_until_ready()``;
* TL401 flags calls into ``torch`` from a signal handler, as it flags
  calls into ``jax``.

Other host syncs (``.item()``, ``.cpu()``, ``.tolist()``) are not
flagged: their receiver's type is not known from the AST, and the same
names are plain host calls on numpy arrays and lists.

Rule families:

* TL1xx — lock ordering: a cross-module lock-order graph (which locks
  are acquired while which are held, following calls through the
  cross-module call graph) is built from every ``with <lock>:`` block;
  cycles are potential deadlocks (TL101), and re-acquiring a
  non-reentrant ``Lock`` already held is a guaranteed self-deadlock
  (TL102).  ``--graph`` dumps the graph as JSON.
* TL2xx — shared-state discipline: writes to ``self.<attr>`` / module
  globals from functions reachable from a ``threading.Thread`` target,
  outside any ``with <lock>:`` block, when the same state is also
  touched from non-thread code (TL201); check-then-act on a shared
  container outside the guarding lock (TL202).
* TL3xx — blocking while holding a lock: ``.result()``,
  ``jax.block_until_ready``, ``torch.cuda.synchronize``,
  ``subprocess``/HTTP, ``time.sleep``, ``Queue.get/put`` or
  ``Event.wait`` without a timeout, thread
  ``join`` — any of these inside a ``with <lock>:`` body stalls every
  other thread that needs the lock (TL301).
* TL4xx — signal-handler safety: a handler registered via
  ``signal.signal`` runs on the main thread at an arbitrary bytecode
  boundary; taking locks, calling into jax or torch, or doing I/O
  there is the exact class that deadlocked the SIGUSR2 profiler (the
  handler must only flip state; a worker thread does the work).  (TL401)
* TL5xx — condition-variable protocol: ``Condition.wait`` outside a
  ``while``-predicate loop misses spurious wakeups and stolen wakeups
  (TL501).

Lock identity: ``self.<attr> = threading.Lock()/RLock()/Condition()``
defines lock node ``Class.attr``; module-level ``X = threading.Lock()``
defines ``module.X``; function-local locks get ``module.func.X``.  An
acquisition through another object (``r._lock``) resolves through local
type inference (parameter annotations, ``x = Class(...)`` assignments,
``for x in <List[Class]-typed>`` iteration); when the attribute name is
defined as a lock by exactly one class in the corpus, that class is
assumed; otherwise the node is ``?.attr`` (ambiguous — visible in the
graph dump, merged conservatively).

Waivers: the JAX linters' protocol (``analysis/common.py``) —
``# threadlint: disable=TL201 <reason>`` on the line or the line above;
a reasonless waiver is TL001, an unknown rule TL002.

CLI::

    python -m mx_rcnn_tpu_torch.analysis.threadlint [paths...] [--json]
        [--show-waived] [--list-rules] [--graph]

Exit status 0 iff no unwaived findings (``--graph`` always exits 0 —
it is a reporting mode).
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
    "TL001": "waiver without a reason (every waiver must say why)",
    "TL002": "waiver names an unknown rule code",
    "TL101": "lock-order cycle across the lock graph (potential deadlock)",
    "TL102": "non-reentrant Lock acquired while already held "
             "(self-deadlock)",
    "TL201": "unguarded write to shared state reachable from a Thread "
             "target",
    "TL202": "check-then-act on a shared container outside the guarding "
             "lock",
    "TL301": "blocking call while holding a lock",
    "TL401": "non-async-signal-safe work inside a signal handler",
    "TL501": "Condition.wait outside a while-predicate loop",
}

_LOCK_CTORS = {
    "threading.Lock": "Lock",
    "threading.RLock": "RLock",
    "threading.Condition": "Condition",
}
# constructor -> type tag for attribute/local type tracking; types in
# _THREADSAFE_TYPES are internally synchronized, so unguarded method
# calls/writes on them are not shared-state findings
_KNOWN_CTORS = dict(_LOCK_CTORS)
_KNOWN_CTORS.update({
    "threading.Event": "Event",
    "threading.Semaphore": "Semaphore",
    "threading.BoundedSemaphore": "Semaphore",
    "threading.Thread": "Thread",
    "queue.Queue": "Queue",
    "queue.LifoQueue": "Queue",
    "queue.PriorityQueue": "Queue",
    "queue.SimpleQueue": "Queue",
    "collections.deque": "deque",
    "collections.OrderedDict": "dict",
})
_THREADSAFE_TYPES = {"Lock", "RLock", "Condition", "Event", "Semaphore",
                     "Queue", "Thread"}

# container mutators for TL201/TL202 ("set" is deliberately absent —
# Event.set would false-positive on untyped receivers)
_MUTATORS = {"append", "appendleft", "extend", "insert", "add", "update",
             "pop", "popleft", "popitem", "remove", "discard", "clear",
             "setdefault"}

# blocking calls for TL301 (canonical names)
_BLOCKING_CANON = {
    "time.sleep", "jax.block_until_ready",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen", "os.system",
    "urllib.request.urlopen", "socket.create_connection",
    "jax.device_get", "jax.device_put",
    "torch.cuda.synchronize",
}
_BLOCKING_CANON_PREFIXES = ("requests.", "http.client.")


# --------------------------------------------------------------------------
# data model
# --------------------------------------------------------------------------

@dataclass
class LockDef:
    node_id: str                 # "Class.attr" / "module.name" / local
    kind: str                    # Lock | RLock | Condition
    path: str
    line: int


@dataclass
class FuncInfo:
    qualname: str                # "Class.method", "func", "outer.inner"
    module: "ModuleInfo"
    node: ast.AST
    cls: Optional[str] = None
    callees: Set[str] = field(default_factory=set)   # resolved keys
    direct_acquires: Set[str] = field(default_factory=set)
    trans_acquires: Set[str] = field(default_factory=set)
    # calls made while lexically holding locks: (held ids, callee key, node)
    calls_under_lock: List[Tuple[Tuple[str, ...], str, ast.AST]] = \
        field(default_factory=list)
    thread_scope: bool = False   # reachable from a threading.Thread target
    handler_scope: bool = False  # reachable from a signal.signal handler


@dataclass
class ClassInfo:
    name: str
    module: "ModuleInfo"
    attr_types: Dict[str, str] = field(default_factory=dict)  # attr -> tag
    lock_attrs: Dict[str, LockDef] = field(default_factory=dict)
    # attr -> set of qualnames (of THIS corpus) touching it, split by
    # write/read for the shared-state rule
    attr_writers: Dict[str, Set[str]] = field(default_factory=dict)
    attr_readers: Dict[str, Set[str]] = field(default_factory=dict)


@dataclass
class ModuleInfo:
    path: str
    name: str                    # module basename (no .py), for display
    uid: str                     # unique key (the path) — two modules
    # may share a basename (serve/fleet.py vs tools/fleet.py), and
    # keying the corpus by basename would silently overwrite entries
    tree: ast.Module
    aliases: Dict[str, str] = field(default_factory=dict)
    waivers: Dict[int, Tuple[Set[str], str]] = field(default_factory=dict)
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    funcs: Dict[str, FuncInfo] = field(default_factory=dict)  # by qualname
    module_locks: Dict[str, LockDef] = field(default_factory=dict)
    global_writers: Dict[str, Set[str]] = field(default_factory=dict)
    global_readers: Dict[str, Set[str]] = field(default_factory=dict)


@dataclass
class Edge:
    """One observed ordering: ``acquired`` taken while ``held``."""
    held: str
    acquired: str
    path: str
    line: int
    func: str
    via: str = ""                # callee chain note for closure edges


class Corpus:
    """Cross-module index: classes by name, functions by UNIQUE module
    key (two modules may share a basename — serve/fleet.py vs
    tools/fleet.py — so cross-module references resolve through the
    basename index and must be unambiguous to count)."""

    def __init__(self, mods: List[ModuleInfo]):
        self.mods = mods
        self.classes: Dict[str, ClassInfo] = {}
        self.funcs: Dict[str, FuncInfo] = {}        # "<uid>:<qualname>"
        self.lock_attr_owners: Dict[str, List[ClassInfo]] = {}
        self.method_owners: Dict[str, List[str]] = {}  # name -> [keys]
        self.mods_by_tail: Dict[str, List[ModuleInfo]] = {}
        for m in mods:
            self.mods_by_tail.setdefault(m.name, []).append(m)
            for cname, ci in m.classes.items():
                self.classes.setdefault(cname, ci)
                for attr in ci.lock_attrs:
                    self.lock_attr_owners.setdefault(attr, []).append(ci)
            for q, fi in m.funcs.items():
                self.funcs[f"{m.uid}:{q}"] = fi
                if "." in q:
                    mname = q.rsplit(".", 1)[-1]
                    self.method_owners.setdefault(mname, []).append(
                        f"{m.uid}:{q}")

    def resolve(self, key: str) -> Optional[FuncInfo]:
        return self.funcs.get(key)

    def module_func_key(self, mod_tail: str, fname: str) -> Optional[str]:
        """Key of top-level ``fname`` in the module whose basename is
        ``mod_tail`` — None unless exactly one candidate defines it."""
        cands = [m for m in self.mods_by_tail.get(mod_tail, [])
                 if fname in m.funcs]
        if len(cands) == 1:
            return f"{cands[0].uid}:{fname}"
        return None


# --------------------------------------------------------------------------
# pass 1: per-module collection
# --------------------------------------------------------------------------

def _ctor_tag(mod: ModuleInfo, value: ast.AST,
              corpus_classes: Set[str]) -> Optional[str]:
    """Type tag of an assigned value: known ctor tag, a corpus class
    name, or a container literal tag."""
    if isinstance(value, (ast.List, ast.ListComp)):
        return "list"
    if isinstance(value, (ast.Dict, ast.DictComp)):
        return "dict"
    if isinstance(value, (ast.Set, ast.SetComp)):
        return "set"
    calls = [value]
    if isinstance(value, ast.BoolOp):     # e.g. ``policy or RestartPolicy()``
        calls = list(value.values)
    if isinstance(value, ast.IfExp):
        calls = [value.body, value.orelse]
    for v in calls:
        if not isinstance(v, ast.Call):
            continue
        canon = canonical(mod.aliases, v.func) or ""
        if canon in _KNOWN_CTORS:
            return _KNOWN_CTORS[canon]
        leaf = canon.rsplit(".", 1)[-1]
        if leaf in corpus_classes:
            return leaf
    return None


def _elem_tag(mod: ModuleInfo, value: ast.AST,
              corpus_classes: Set[str]) -> Optional[str]:
    """Element type of a list literal/comprehension of constructor calls
    (``[Replica(i) for i in ...]`` -> ``Replica``)."""
    elts: List[ast.AST] = []
    if isinstance(value, ast.ListComp):
        elts = [value.elt]
    elif isinstance(value, ast.List):
        elts = value.elts
    for e in elts:
        if isinstance(e, ast.Call):
            canon = canonical(mod.aliases, e.func) or ""
            leaf = canon.rsplit(".", 1)[-1]
            if leaf in corpus_classes:
                return leaf
    return None


def _ann_class(ann: Optional[ast.AST]) -> Optional[str]:
    """Class name out of an annotation (``Replica``,
    ``Optional[ServingEngine]``, ``List[Replica]`` -> element handled by
    caller)."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Attribute):
        return ann.attr
    if isinstance(ann, ast.Subscript):      # Optional[X] / List[X]
        return _ann_class(ann.slice)
    if isinstance(ann, ast.BinOp):          # X | None
        return _ann_class(ann.left)
    return None


def _ann_is_seq(ann: Optional[ast.AST]) -> bool:
    if isinstance(ann, ast.Subscript):
        base = ann.value
        return isinstance(base, ast.Name) and base.id in (
            "List", "Sequence", "Tuple", "Iterable", "list", "tuple")
    return False


class _Scanner(ast.NodeVisitor):
    """Collects classes, functions (incl. nested), lock/attr types."""

    def __init__(self, mod: ModuleInfo, corpus_classes: Set[str]):
        self.mod = mod
        self.corpus_classes = corpus_classes
        self.cls_stack: List[ClassInfo] = []
        self.func_stack: List[FuncInfo] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        ci = ClassInfo(name=node.name, module=self.mod)
        self.mod.classes[node.name] = ci
        self.cls_stack.append(ci)
        self.generic_visit(node)
        self.cls_stack.pop()

    def _enter_func(self, node) -> None:
        if self.func_stack:
            qual = f"{self.func_stack[-1].qualname}.{node.name}"
        elif self.cls_stack:
            qual = f"{self.cls_stack[-1].name}.{node.name}"
        else:
            qual = node.name
        fi = FuncInfo(qualname=qual, module=self.mod, node=node,
                      cls=self.cls_stack[-1].name if self.cls_stack
                      else None)
        self.mod.funcs[qual] = fi
        self.func_stack.append(fi)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._enter_func(node)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign) -> None:
        self._record_assign(node.targets, node.value, node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        tgts = [node.target]
        if node.value is not None:
            self._record_assign(tgts, node.value, node)
        # annotated attr with no useful value: take the annotation type
        t = node.target
        if (self.cls_stack and isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name) and t.value.id == "self"):
            cname = _ann_class(node.annotation)
            if cname and t.attr not in self.cls_stack[-1].attr_types:
                if cname in self.corpus_classes or cname in (
                        "Thread", "Queue", "Event"):
                    self.cls_stack[-1].attr_types[t.attr] = cname
        self.generic_visit(node)

    def _record_assign(self, targets, value, node) -> None:
        tag = _ctor_tag(self.mod, value, self.corpus_classes)
        elem = _elem_tag(self.mod, value, self.corpus_classes)
        for t in targets:
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and t.value.id == "self" \
                    and self.cls_stack:
                ci = self.cls_stack[-1]
                if tag is not None:
                    ci.attr_types[t.attr] = tag
                    if tag in _LOCK_CTORS.values():
                        ci.lock_attrs[t.attr] = LockDef(
                            node_id=f"{ci.name}.{t.attr}", kind=tag,
                            path=self.mod.path, line=node.lineno)
                if elem is not None:
                    ci.attr_types.setdefault(t.attr, f"List[{elem}]")
            elif isinstance(t, ast.Name) and not self.func_stack \
                    and not self.cls_stack:
                if tag in _LOCK_CTORS.values():
                    self.mod.module_locks[t.id] = LockDef(
                        node_id=f"{self.mod.name}.{t.id}", kind=tag,
                        path=self.mod.path, line=node.lineno)


def load_module(path: str) -> Optional[ModuleInfo]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError) as e:
        print(f"threadlint: cannot parse {path}: {e}", file=sys.stderr)
        return None
    name = os.path.basename(path)[:-3]
    mod = ModuleInfo(path=path, name=name, uid=path, tree=tree)
    mod.aliases = collect_import_aliases(tree)
    mod.waivers = parse_waivers(source, "threadlint")
    return mod


# --------------------------------------------------------------------------
# pass 2: per-function analysis (types, locks, calls, writes)
# --------------------------------------------------------------------------

class _FuncAnalysis(ast.NodeVisitor):
    """One function body: local types, with-lock regions, acquisitions,
    calls-under-lock, writes, signal registrations, thread targets."""

    def __init__(self, fi: FuncInfo, corpus: Corpus):
        self.fi = fi
        self.mod = fi.module
        self.corpus = corpus
        self.local_types: Dict[str, str] = {}
        self.local_locks: Dict[str, LockDef] = {}
        self.with_stack: List[str] = []       # lock node ids held lexically
        self.with_kinds: Dict[str, str] = {}  # node id -> kind
        self.while_depth = 0
        self.edges: List[Edge] = []
        self.findings: List[Finding] = []
        # (class, attr, node) for every unguarded attribute write
        self.unguarded_self_writes: List[Tuple[str, str, ast.AST]] = []
        self.unguarded_global_writes: List[Tuple[str, ast.AST]] = []
        self.thread_targets: List[str] = []   # resolved callee keys
        self.handler_targets: List[str] = []
        self.globals_declared: Set[str] = set()
        self._param_types()
        self._nested = {q.rsplit(".", 1)[-1]: q for q, f in
                        self.mod.funcs.items()
                        if q.startswith(fi.qualname + ".")
                        and q.count(".") == fi.qualname.count(".") + 1}

    # -- type plumbing ------------------------------------------------------

    def _param_types(self) -> None:
        node = self.fi.node
        if isinstance(node, (ast.Lambda, ast.Module)):
            return
        for a in node.args.posonlyargs + node.args.args + \
                node.args.kwonlyargs:
            cname = _ann_class(a.annotation)
            if cname and cname in self.corpus.classes:
                if _ann_is_seq(a.annotation):
                    self.local_types[a.arg] = f"List[{cname}]"
                else:
                    self.local_types[a.arg] = cname

    def _type_of(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name):
            return self.local_types.get(node.id)
        if isinstance(node, ast.Attribute):
            base: Optional[ClassInfo] = None
            if isinstance(node.value, ast.Name):
                if node.value.id == "self" and self.fi.cls:
                    base = self.corpus.classes.get(self.fi.cls)
                else:
                    t = self.local_types.get(node.value.id)
                    base = self.corpus.classes.get(t) if t else None
            elif isinstance(node.value, ast.Attribute):
                t = self._type_of(node.value)
                base = self.corpus.classes.get(t) if t else None
            if base is not None:
                return base.attr_types.get(node.attr)
        return None

    # -- lock resolution ----------------------------------------------------

    def _lock_node(self, expr: ast.AST) -> Optional[LockDef]:
        """Resolve a with-item / receiver expression to a lock node."""
        if isinstance(expr, ast.Name):
            if expr.id in self.local_locks:
                return self.local_locks[expr.id]
            if expr.id in self.mod.module_locks:
                return self.mod.module_locks[expr.id]
            return None
        if isinstance(expr, ast.Attribute):
            attr = expr.attr
            owner: Optional[str] = None
            if isinstance(expr.value, ast.Name) and \
                    expr.value.id == "self" and self.fi.cls:
                owner = self.fi.cls
            else:
                owner = self._type_of(expr.value)
            if owner:
                ci = self.corpus.classes.get(owner)
                if ci is not None and attr in ci.lock_attrs:
                    return ci.lock_attrs[attr]
                if ci is not None:
                    return None   # known type, not a lock attr
            cands = self.corpus.lock_attr_owners.get(attr, [])
            if len(cands) == 1:
                return cands[0].lock_attrs[attr]
            if len(cands) > 1:
                # ambiguous: merged node, visible in the graph dump
                return LockDef(node_id=f"?.{attr}",
                               kind=cands[0].lock_attrs[attr].kind,
                               path=self.mod.path, line=expr.lineno)
        return None

    # -- callee resolution --------------------------------------------------

    def _callee_key(self, func: ast.AST) -> Optional[str]:
        if isinstance(func, ast.Name):
            if func.id in self._nested:
                return f"{self.mod.uid}:{self._nested[func.id]}"
            if func.id in self.mod.funcs:
                return f"{self.mod.uid}:{func.id}"
            alias = self.mod.aliases.get(func.id)
            if alias and "." in alias:
                m, _, f = alias.rpartition(".")
                return self.corpus.module_func_key(m.rsplit(".", 1)[-1], f)
            return None
        if isinstance(func, ast.Attribute):
            mname = func.attr
            owner: Optional[str] = None
            if isinstance(func.value, ast.Name) and \
                    func.value.id == "self" and self.fi.cls:
                owner = self.fi.cls
            else:
                owner = self._type_of(func.value)
            if owner and owner.startswith("List["):
                owner = None
            if owner:
                for key in self.corpus.method_owners.get(mname, []):
                    if key.split(":", 1)[1] == f"{owner}.{mname}":
                        return key
                return None
            # unique method name across the corpus (e.g. ``req._finish``)
            cands = self.corpus.method_owners.get(mname, [])
            if len(cands) == 1:
                return cands[0]
            # module-qualified call through an import alias
            canon = canonical(self.mod.aliases, func) or ""
            if "." in canon:
                m, _, f = canon.rpartition(".")
                return self.corpus.module_func_key(m.rsplit(".", 1)[-1], f)
        return None

    # -- traversal ----------------------------------------------------------

    def run(self) -> None:
        node = self.fi.node
        body = node.body if not isinstance(node, ast.Lambda) else [node.body]
        for stmt in body:
            self._visit_stmt(stmt)
        if not isinstance(node, ast.Module):
            self._index_attr_access()

    def _attr_owner(self, node: ast.Attribute) -> Optional[str]:
        """The class owning an attribute access: ``self.x`` → enclosing
        class; ``r.x`` → r's inferred class."""
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            return self.fi.cls
        t = self._type_of(node.value) if isinstance(
            node.value, (ast.Name, ast.Attribute)) else None
        return t if t in self.corpus.classes else None

    def _index_attr_access(self) -> None:
        """Full-body read/write index over self- and typed-object
        attribute accesses — feeds the shared-state rule's 'who else
        touches this' test (local types are complete by now)."""
        me = f"{self.mod.uid}:{self.fi.qualname}"
        for sub in ast.walk(self.fi.node):
            if not isinstance(sub, ast.Attribute):
                continue
            owner = self._attr_owner(sub)
            if owner is None:
                continue
            ci = self.corpus.classes.get(owner)
            if ci is None:
                continue
            if isinstance(sub.ctx, ast.Load):
                ci.attr_readers.setdefault(sub.attr, set()).add(me)
            else:
                ci.attr_writers.setdefault(sub.attr, set()).add(me)

    def _visit_stmt(self, node: ast.AST) -> None:
        # skip nested function bodies (analyzed as their own FuncInfos)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if isinstance(node, ast.Global):
            self.globals_declared.update(node.names)
        if isinstance(node, ast.With):
            self._visit_with(node)
            return
        if isinstance(node, ast.While):
            self.while_depth += 1
            for sub in ast.iter_child_nodes(node):
                self._visit_stmt(sub)
            self.while_depth -= 1
            return
        if isinstance(node, ast.Assign):
            self._bind_types(node)
            self._propagate_attr_type(node)
            self._check_write(node.targets, node)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            # annotated assignments are writes too — `self.n: int = 1`
            # must not dodge TL201 just by carrying an annotation
            synth = ast.Assign(targets=[node.target], value=node.value)
            ast.copy_location(synth, node)
            self._bind_types(synth)
            self._propagate_attr_type(synth)
            self._check_write([node.target], node)
        elif isinstance(node, ast.AugAssign):
            self._check_write([node.target], node)
        elif isinstance(node, ast.For):
            self._bind_for(node)
        elif isinstance(node, ast.If):
            self._check_check_then_act(node)
        elif isinstance(node, ast.Call):
            self._visit_call(node)
        for sub in ast.iter_child_nodes(node):
            self._visit_stmt(sub)

    def _visit_with(self, node: ast.With) -> None:
        acquired: List[str] = []
        for item in node.items:
            ld = self._lock_node(item.context_expr)
            if ld is None:
                continue
            self._record_acquire(ld, item.context_expr)
            acquired.append(ld.node_id)
            self.with_stack.append(ld.node_id)
        for stmt in node.body:
            self._visit_stmt(stmt)
        for _ in acquired:
            self.with_stack.pop()

    def _record_acquire(self, ld: LockDef, site: ast.AST) -> None:
        self.fi.direct_acquires.add(ld.node_id)
        self.with_kinds[ld.node_id] = ld.kind
        if ld.node_id in self.with_stack:
            if ld.kind == "Lock":
                self.findings.append(Finding(
                    self.mod.path, site.lineno, site.col_offset, "TL102",
                    f"non-reentrant Lock '{ld.node_id}' acquired while "
                    "already held — guaranteed self-deadlock",
                    self.fi.qualname))
            return  # reentrant re-acquire: no ordering edge
        for held in self.with_stack:
            if held != ld.node_id:
                self.edges.append(Edge(
                    held=held, acquired=ld.node_id, path=self.mod.path,
                    line=site.lineno, func=self.fi.qualname))

    def _bind_types(self, node: ast.Assign) -> None:
        tag = _ctor_tag(self.mod, node.value,
                        set(self.corpus.classes))
        for t in node.targets:
            if not isinstance(t, ast.Name):
                continue
            if tag in _LOCK_CTORS.values():
                self.local_locks[t.id] = LockDef(
                    node_id=f"{self.mod.name}.{self.fi.qualname}.{t.id}",
                    kind=tag, path=self.mod.path, line=node.lineno)
            if tag is not None:
                self.local_types[t.id] = tag

    def _propagate_attr_type(self, node: ast.Assign) -> None:
        """``self.manager = manager`` with an annotated ``manager`` param
        types the attribute (so other-class accessors resolve)."""
        if not self.fi.cls or not isinstance(node.value, ast.Name):
            return
        t = self.local_types.get(node.value.id)
        if t is None:
            return
        ci = self.corpus.classes.get(self.fi.cls)
        if ci is not None:
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self":
                    ci.attr_types.setdefault(tgt.attr, t)

    def _bind_for(self, node: ast.For) -> None:
        if not isinstance(node.target, ast.Name):
            return
        it = node.iter
        t: Optional[str] = None
        if isinstance(it, (ast.Name, ast.Attribute)):
            t = self._type_of(it)
        elif isinstance(it, ast.Call):
            # iteration over a call with a List[C] return annotation
            key = self._callee_key(it.func)
            fi = self.corpus.resolve(key) if key else None
            if fi is not None and not isinstance(fi.node, ast.Lambda):
                ret = getattr(fi.node, "returns", None)
                cname = _ann_class(ret)
                if cname in self.corpus.classes and _ann_is_seq(ret):
                    t = f"List[{cname}]"
            if isinstance(it.func, ast.Name) and it.func.id == "enumerate" \
                    and it.args:
                inner = it.args[0]
                et = self._type_of(inner) if isinstance(
                    inner, (ast.Name, ast.Attribute)) else None
                if et and et.startswith("List["):
                    # ``for j, r in enumerate(reqs)`` — handled below via
                    # tuple targets; single-name target gets the tuple
                    t = et
        if t and t.startswith("List["):
            self.local_types[node.target.id] = t[5:-1]

    # -- writes (TL201) -----------------------------------------------------

    def _self_attr(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "self":
            return node.attr
        return None

    def _check_write(self, targets: List[ast.AST], node: ast.AST) -> None:
        guarded = bool(self.with_stack)
        for t in targets:
            if isinstance(t, ast.Tuple):
                self._check_write(list(t.elts), node)
                continue
            tgt = t
            if isinstance(tgt, ast.Subscript):
                tgt = tgt.value
            if isinstance(tgt, ast.Attribute):
                owner = self._attr_owner(tgt)
                if owner is not None and not guarded:
                    self.unguarded_self_writes.append(
                        (owner, tgt.attr, node))
            if isinstance(t, ast.Name) and t.id in self.globals_declared:
                self.mod.global_writers.setdefault(t.id, set()).add(
                    f"{self.mod.uid}:{self.fi.qualname}")
                if not guarded:
                    self.unguarded_global_writes.append((t.id, node))

    def _check_check_then_act(self, node: ast.If) -> None:
        """TL202: ``if <reads self.A>`` whose body mutates ``self.A``,
        outside any lock, in a class that owns locks or threads."""
        if self.with_stack or not self.fi.cls:
            return
        ci = self.corpus.classes.get(self.fi.cls)
        if ci is None:
            return
        concurrent = bool(ci.lock_attrs) or any(
            t in ("Thread", "Event", "Queue", "Condition")
            for t in ci.attr_types.values())
        if not concurrent:
            return
        read_attrs = {self._self_attr(sub)
                      for sub in ast.walk(node.test)} - {None}
        if not read_attrs:
            return
        for stmt in node.body:
            for sub in ast.walk(stmt):
                attr = None
                if isinstance(sub, ast.Assign):
                    for t in sub.targets:
                        if isinstance(t, ast.Subscript):
                            attr = self._self_attr(t.value)
                elif isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr in _MUTATORS:
                    attr = self._self_attr(sub.func.value)
                if attr is not None and attr in read_attrs and \
                        ci.attr_types.get(attr) not in _THREADSAFE_TYPES:
                    self.findings.append(Finding(
                        self.mod.path, node.lineno, node.col_offset,
                        "TL202",
                        f"check-then-act on 'self.{attr}' outside the "
                        "guarding lock — the state can change between "
                        "the test and the mutation", self.fi.qualname))
                    return

    # -- calls --------------------------------------------------------------

    def _visit_call(self, node: ast.Call) -> None:
        canon = canonical(self.mod.aliases, node.func) or ""
        # thread targets / signal handlers
        if canon == "threading.Thread" or canon.endswith(".Thread"):
            for kw in node.keywords:
                if kw.arg == "target":
                    key = self._callee_key(kw.value)
                    if key:
                        self.thread_targets.append(key)
        if canon == "signal.signal" and len(node.args) >= 2:
            key = self._callee_key(node.args[1])
            if key:
                self.handler_targets.append(key)
        # mutator calls are writes for TL201
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATORS and \
                isinstance(node.func.value, ast.Attribute):
            recv = node.func.value
            owner = self._attr_owner(recv)
            if owner is not None:
                ci = self.corpus.classes.get(owner)
                if ci is not None:
                    ci.attr_writers.setdefault(recv.attr, set()).add(
                        f"{self.mod.uid}:{self.fi.qualname}")
                    if not self.with_stack and \
                            ci.attr_types.get(recv.attr) not in \
                            _THREADSAFE_TYPES:
                        self.unguarded_self_writes.append(
                            (owner, recv.attr, node))
        # TL501: Condition.wait outside a while loop
        if isinstance(node.func, ast.Attribute) and node.func.attr == "wait":
            ld = self._lock_node(node.func.value)
            if ld is not None and ld.kind == "Condition" and \
                    self.while_depth == 0:
                self.findings.append(Finding(
                    self.mod.path, node.lineno, node.col_offset, "TL501",
                    f"Condition.wait on '{ld.node_id}' outside a while "
                    "loop — spurious/stolen wakeups break the predicate; "
                    "use 'while not <pred>: cond.wait()'",
                    self.fi.qualname))
        # lock-order + blocking checks while lexically holding locks
        if self.with_stack:
            self._check_blocking(node, canon)
            key = self._callee_key(node.func)
            if key is not None:
                self.fi.calls_under_lock.append(
                    (tuple(self.with_stack), key, node))
        # record callee for reachability closures
        key = self._callee_key(node.func)
        if key is not None:
            self.fi.callees.add(key)

    def _check_blocking(self, node: ast.Call, canon: str) -> None:
        held = self.with_stack[-1]
        msg = None
        kwargs = {kw.arg for kw in node.keywords}
        if canon in _BLOCKING_CANON or \
                canon.startswith(_BLOCKING_CANON_PREFIXES):
            msg = f"'{canon}'"
        elif isinstance(node.func, ast.Attribute):
            a = node.func.attr
            recv_t = self._type_of(node.func.value)
            if a == "result":
                msg = "'.result()' (future wait)"
            elif a == "block_until_ready":
                msg = "'.block_until_ready()'"
            elif a == "synchronize":
                # a CUDA event's or stream's host wait
                msg = "'.synchronize()'"
            elif a == "join" and not node.args and \
                    not isinstance(node.func.value, ast.Constant):
                # 1-positional-arg join is str.join — skipped; a bare
                # or timeout-kwarg join is a thread/queue wait
                msg = "'.join()' (thread/queue wait)"
            elif a in ("get", "put") and recv_t == "Queue" and \
                    "timeout" not in kwargs and \
                    "block" not in kwargs and \
                    len(node.args) <= (0 if a == "get" else 1):
                # only the bare default form is flagged: any block=/
                # timeout= kwarg or positional (block[, timeout]) arg —
                # get(False), get(True, 5), put(item, False) — means the
                # author chose the blocking semantics explicitly
                msg = f"'Queue.{a}()' without a timeout"
            elif a == "wait":
                ld = self._lock_node(node.func.value)
                if ld is not None and ld.kind == "Condition" and \
                        ld.node_id in self.with_stack:
                    msg = None     # the condition protocol itself
                elif (recv_t == "Event" or
                      (ld is not None and ld.kind == "Condition")) and \
                        "timeout" not in kwargs and not node.args:
                    msg = "'.wait()' without a timeout"
        if msg:
            self.findings.append(Finding(
                self.mod.path, node.lineno, node.col_offset, "TL301",
                f"blocking call {msg} while holding '{held}' stalls "
                "every thread that needs the lock", self.fi.qualname))


# --------------------------------------------------------------------------
# pass 3: closures + graph rules
# --------------------------------------------------------------------------

def _fixpoint_scope(corpus: Corpus, roots: List[str], attr: str) -> None:
    """Mark ``attr`` (thread_scope / handler_scope) on roots and their
    transitive callees."""
    work = [k for k in roots if k in corpus.funcs]
    while work:
        key = work.pop()
        fi = corpus.funcs[key]
        if getattr(fi, attr):
            continue
        setattr(fi, attr, True)
        for c in fi.callees:
            if c in corpus.funcs and not getattr(corpus.funcs[c], attr):
                work.append(c)


def _trans_acquires(corpus: Corpus) -> None:
    for fi in corpus.funcs.values():
        fi.trans_acquires = set(fi.direct_acquires)
    changed = True
    while changed:
        changed = False
        for fi in corpus.funcs.values():
            for c in fi.callees:
                callee = corpus.funcs.get(c)
                if callee is None:
                    continue
                add = callee.trans_acquires - fi.trans_acquires
                if add:
                    fi.trans_acquires |= add
                    changed = True


def _closure_edges(corpus: Corpus) -> List[Edge]:
    """Ordering edges through calls: every lock the callee (transitively)
    acquires is acquired while the caller's held set is held."""
    edges: List[Edge] = []
    for key, fi in corpus.funcs.items():
        for held_ids, callee_key, node in fi.calls_under_lock:
            callee = corpus.funcs.get(callee_key)
            if callee is None:
                continue
            for acq in callee.trans_acquires:
                for held in held_ids:
                    if held != acq:
                        edges.append(Edge(
                            held=held, acquired=acq, path=fi.module.path,
                            line=node.lineno, func=fi.qualname,
                            via=callee_key))
    return edges


def _find_cycles(edges: List[Edge]) -> List[List[str]]:
    """Strongly-connected components of size > 1 in the lock graph."""
    graph: Dict[str, Set[str]] = {}
    for e in edges:
        graph.setdefault(e.held, set()).add(e.acquired)
        graph.setdefault(e.acquired, set())
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        # iterative Tarjan (recursion depth is unbounded on long chains)
        work = [(v, iter(sorted(graph[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph[w]))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1:
                    sccs.append(sorted(scc))

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    return sccs


def _shared_write_findings(corpus: Corpus,
                           analyses: Dict[str, _FuncAnalysis]
                           ) -> List[Finding]:
    out: List[Finding] = []
    for key, an in analyses.items():
        fi = corpus.funcs[key]
        if not fi.thread_scope:
            continue
        qual_leaf = fi.qualname.rsplit(".", 1)[-1]
        if qual_leaf in ("__init__", "__enter__"):
            continue   # construction happens-before thread start
        seen: Set[Tuple[str, str]] = set()
        for owner, attr, node in an.unguarded_self_writes:
            ci = corpus.classes.get(owner)
            if ci is None or (owner, attr) in seen:
                continue
            if ci.attr_types.get(attr) in _THREADSAFE_TYPES:
                continue
            touchers = (ci.attr_writers.get(attr, set())
                        | ci.attr_readers.get(attr, set()))
            outside = [t for t in touchers
                       if t in corpus.funcs
                       and not corpus.funcs[t].thread_scope
                       and not t.endswith(".__init__")]
            if not outside:
                continue
            seen.add((owner, attr))
            ref = "self" if owner == fi.cls else owner
            out.append(Finding(
                fi.module.path, node.lineno, node.col_offset, "TL201",
                f"unguarded write to shared '{ref}.{attr}' on a thread "
                f"reachable from a Thread target (also touched by "
                f"{sorted(outside)[0].split(':', 1)[1]}) — guard both "
                "sides with one lock", fi.qualname))
        for name, node in an.unguarded_global_writes:
            mod = fi.module
            readers = (mod.global_readers.get(name, set())
                       | mod.global_writers.get(name, set()))
            outside = [t for t in readers
                       if t in corpus.funcs
                       and not corpus.funcs[t].thread_scope]
            if not outside:
                continue
            out.append(Finding(
                fi.module.path, node.lineno, node.col_offset, "TL201",
                f"unguarded write to module global '{name}' on a thread "
                "reachable from a Thread target — guard both sides with "
                "one lock", fi.qualname))
    return out


_HANDLER_SAFE_LEAVES = {"append"}


def _handler_findings(corpus: Corpus,
                      analyses: Dict[str, _FuncAnalysis]) -> List[Finding]:
    """TL401: lock acquisition, jax or torch calls, blocking waits or file
    I/O in a signal-handler closure.  Deliberately NOT flagged: logging (its
    RLock is reentrant for the interrupted main thread) and
    ``threading.Thread(...).start()`` — handing work to a thread is the
    FIX pattern (obs/profiler.py)."""
    out: List[Finding] = []
    for key, an in analyses.items():
        fi = corpus.funcs[key]
        if not fi.handler_scope:
            continue
        node = fi.node
        if isinstance(node, ast.Lambda):
            continue
        # skip nested function bodies: work handed to a worker thread
        # (`def work(): ...jax...; Thread(target=work).start()`) is the
        # documented FIX pattern, not handler-context work — the nested
        # def is only flagged if something CALLS it from handler scope
        # (then it is its own handler-scope FuncInfo)
        nested = {sub for stmt in ast.iter_child_nodes(node)
                  for sub in ast.walk(stmt)
                  if isinstance(sub, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda))}

        def _walk_own(n):
            yield n
            for child in ast.iter_child_nodes(n):
                if child in nested:
                    continue
                yield from _walk_own(child)

        for sub in _walk_own(node):
            bad: Optional[str] = None
            if isinstance(sub, ast.With):
                for item in sub.items:
                    if an._lock_node(item.context_expr) is not None:
                        bad = "acquires a lock"
            elif isinstance(sub, ast.Call):
                canon = canonical(fi.module.aliases, sub.func) or ""
                leaf = canon.rsplit(".", 1)[-1]
                if canon.startswith("jax"):
                    bad = f"calls into jax ('{canon}')"
                elif canon == "torch" or canon.startswith("torch."):
                    bad = f"calls into torch ('{canon}')"
                elif canon in _BLOCKING_CANON or canon.startswith(
                        _BLOCKING_CANON_PREFIXES):
                    bad = f"blocking call '{canon}'"
                elif leaf == "open" and canon == "open":
                    bad = "file I/O"
                elif isinstance(sub.func, ast.Attribute):
                    a = sub.func.attr
                    if a == "acquire":
                        bad = "acquires a lock"
                    elif a in ("get", "put") and \
                            an._type_of(sub.func.value) == "Queue":
                        bad = f"Queue.{a}"
                    elif a == "join" and not sub.args:
                        bad = "blocking join"
            if bad:
                out.append(Finding(
                    fi.module.path, sub.lineno, sub.col_offset, "TL401",
                    f"signal handler {bad} — handlers run on the main "
                    "thread at an arbitrary bytecode boundary and must "
                    "only flip state (do the work on a worker thread; "
                    "see obs/profiler.py install_sigusr2)",
                    fi.qualname))
    return out


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def analyze_paths(paths: Sequence[str]
                  ) -> Tuple[List[Finding], List[Edge], List[List[str]],
                             Corpus]:
    """Full analysis: returns (findings, lock edges, cycles, corpus)."""
    files = iter_py_files(paths)
    mods = [m for m in (load_module(f) for f in files) if m is not None]
    corpus_classes: Set[str] = set()
    for m in mods:
        for node in ast.walk(m.tree):
            if isinstance(node, ast.ClassDef):
                corpus_classes.add(node.name)
    for m in mods:
        _Scanner(m, corpus_classes).visit(m.tree)
        # module-level statements (signal.signal / Thread registrations
        # outside any function) analyze as a synthetic "<module>" scope
        m.funcs["<module>"] = FuncInfo(qualname="<module>", module=m,
                                       node=m.tree)
    corpus = Corpus(mods)

    analyses: Dict[str, _FuncAnalysis] = {}
    thread_roots: List[str] = []
    handler_roots: List[str] = []
    findings: List[Finding] = []
    edges: List[Edge] = []
    # two passes: attr types accrete across classes first (done in
    # _Scanner), then function bodies analyze against the full corpus
    for m in mods:
        for q, fi in m.funcs.items():
            an = _FuncAnalysis(fi, corpus)
            an.run()
            analyses[f"{m.uid}:{q}"] = an
            thread_roots.extend(an.thread_targets)
            handler_roots.extend(an.handler_targets)
            findings.extend(an.findings)
            edges.extend(an.edges)
    # module-global read index for TL201 (simple name loads)
    for m in mods:
        global_names = set(m.global_writers)
        for q, fi in m.funcs.items():
            for sub in ast.walk(fi.node):
                if isinstance(sub, ast.Name) and \
                        isinstance(sub.ctx, ast.Load) and \
                        sub.id in global_names:
                    m.global_readers.setdefault(sub.id, set()).add(
                        f"{m.uid}:{q}")

    _fixpoint_scope(corpus, thread_roots, "thread_scope")
    _fixpoint_scope(corpus, handler_roots, "handler_scope")
    _trans_acquires(corpus)
    edges.extend(_closure_edges(corpus))

    cycles = _find_cycles(edges)
    cycle_nodes = {n for scc in cycles for n in scc}
    seen_edges: Set[Tuple[str, str]] = set()
    for e in edges:
        if e.held in cycle_nodes and e.acquired in cycle_nodes:
            scc = next(s for s in cycles if e.held in s)
            if e.acquired not in scc:
                continue
            if (e.held, e.acquired) in seen_edges:
                continue
            seen_edges.add((e.held, e.acquired))
            findings.append(Finding(
                e.path, e.line, 0, "TL101",
                f"lock-order cycle: '{e.acquired}' acquired while "
                f"holding '{e.held}' but the cycle "
                f"{' -> '.join(scc + [scc[0]])} means another thread can "
                "acquire them in the opposite order — pick one global "
                "order", e.func))

    findings.extend(_shared_write_findings(corpus, analyses))
    findings.extend(_handler_findings(corpus, analyses))

    # waivers per module
    by_path: Dict[str, List[Finding]] = {}
    for f in findings:
        by_path.setdefault(f.path, []).append(f)
    out: List[Finding] = []
    for m in mods:
        out.extend(apply_waivers(m.path, m.waivers,
                                 by_path.get(m.path, []), RULES,
                                 prefix="TL", tool="threadlint"))
    out.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return out, edges, cycles, corpus


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    return analyze_paths(paths)[0]


def lock_graph(paths: Sequence[str]) -> Dict:
    """The lock-order graph as a JSON-able dict (the ``--graph`` dump)."""
    _, edges, cycles, corpus = analyze_paths(paths)
    nodes: Dict[str, Dict] = {}
    for m in corpus.mods:
        for ld in m.module_locks.values():
            nodes[ld.node_id] = {"id": ld.node_id, "kind": ld.kind,
                                 "defined": f"{ld.path}:{ld.line}"}
        for ci in m.classes.values():
            for ld in ci.lock_attrs.values():
                nodes[ld.node_id] = {"id": ld.node_id, "kind": ld.kind,
                                     "defined": f"{ld.path}:{ld.line}"}
    seen: Set[Tuple[str, str]] = set()
    edge_list = []
    for e in sorted(edges, key=lambda e: (e.held, e.acquired, e.line)):
        if (e.held, e.acquired) in seen:
            continue
        seen.add((e.held, e.acquired))
        for nid in (e.held, e.acquired):
            nodes.setdefault(nid, {"id": nid, "kind": "?", "defined": "?"})
        edge_list.append({"held": e.held, "acquired": e.acquired,
                          "site": f"{e.path}:{e.line}", "func": e.func,
                          **({"via": e.via} if e.via else {})})
    return {"nodes": sorted(nodes.values(), key=lambda n: n["id"]),
            "edges": edge_list,
            "cycles": cycles}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="threadlint",
        description="concurrency static analysis of the port")
    p.add_argument("paths", nargs="*", default=["mx_rcnn_tpu_torch"],
                   help="files or directories to lint")
    p.add_argument("--json", action="store_true",
                   help="emit findings as JSON records")
    p.add_argument("--show-waived", action="store_true",
                   help="also print waived findings")
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("--graph", action="store_true",
                   help="emit the lock-order graph as JSON and exit 0")
    args = p.parse_args(argv)
    if args.list_rules:
        for code, desc in sorted(RULES.items()):
            print(f"{code}  {desc}")
        return 0
    rc = check_paths_exist("threadlint", args.paths)
    if rc is not None:
        return rc
    if args.graph:
        print(json.dumps(lock_graph(args.paths), indent=1))
        return 0
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
    print(f"threadlint: {len(active)} finding(s), {len(waived)} waived",
          file=sys.stderr)
    return 1 if active else 0


if __name__ == "__main__":
    raise SystemExit(main())
