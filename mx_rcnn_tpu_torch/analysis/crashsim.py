"""crashsim — crash-consistency simulator: persistlint's runtime twin.

Counterpart of ``mx_rcnn_tpu/analysis/crashsim.py``, unchanged in
semantics.  The static pass (``analysis/persistlint.py``) reasons about
the tmp → fsync → rename → dir-fsync → manifest-last idiom from the AST;
this module checks what actually matters: that EVERY state a crash can
leave on disk is one the real recovery paths either restore from or
cleanly refuse.  The technique is CrashMonkey's (Mohan et al.,
OSDI '18): record the workload's persistence operations, enumerate the
crash states the POSIX persistence model allows, materialize each one,
and run the real recovery code against it — systematic enumeration
instead of the kill-at-step-K fault plans of ``ft/faults.py`` (which
sample wall-clock crash points, not reordering semantics).

Three pieces:

* :class:`CrashRecorder` — an opt-in interposition shim (same
  allocation-site pattern as the lock sanitizer,
  ``analysis/sanitizer.py``): while armed it patches, for the whole
  process,
  ``builtins.open`` / ``os.replace`` / ``os.rename`` / ``os.fsync`` /
  ``os.open`` / ``os.close`` / ``os.unlink`` and records every
  PACKAGE-ORIGINATED operation under the capture root into an op log —
  ``write`` (cumulative content snapshot, emitted at fsync and close),
  ``fsync`` / ``dirfsync`` (the ordering barriers), ``rename``,
  ``unlink``, and logical ``commit`` markers the workload runner
  plants when a commit call RETURNS (the durability the code just
  promised its caller).  The real syscalls always execute — the shim
  only observes.  Build every CUDA kernel before arming it: a build
  under a recording would run inside the patched ``open``.
* :func:`crash_states` — the enumerator.  For every truncation point
  of the op log it yields the states the persistence model allows:
  operations ordered by a barrier are applied; in-flight data writes
  may persist fully, as a torn prefix, or not at all (per-file prefix
  semantics: later snapshots supersede earlier ones, a tear never
  rewinds past a synced prefix); in-flight directory operations
  (rename/unlink) may individually persist or vanish — including the
  classic torn state where a rename persists without its source's
  un-fsynced data.
* :func:`simulate` — the verdict engine.  Each materialized state is
  handed to the workload's real recovery function; the verdict is
  RECOVER-OR-REFUSE: the state must either restore a byte-identical
  known artifact at least as new as the DURABLE FLOOR (the newest
  ``commit`` marker in the truncated log — what the code had already
  promised) or be cleanly refused — and refusal is only legal while
  nothing has been promised.  A recovered artifact that matches no
  known version, or a refusal after a commit returned, is a
  VIOLATION — the class of bug a removed fsync or dir-fsync plants
  (``tools/crashsim.py`` proves sensitivity by running exactly that
  arm and requiring the violation to be found).

Model honesty (documented limits): content tears at byte granularity
within one write session (prefix of the session's delta); an
in-place-overwrite session that crashes before its first fsync/close
is not modeled (the tree's durable writers never overwrite in place —
persistlint enforces the staging idiom); directory creation is assumed
durable (every workload root pre-exists).  When a crash point's
combination count exceeds the cap the point is truncated
DETERMINISTICALLY and reported in the result (no silent coverage
loss).
"""

from __future__ import annotations

import builtins
import hashlib
import os
import shutil
import sys
from dataclasses import dataclass, field
from itertools import product
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

_RAW_OPEN = builtins.open
_RAW_OS = {name: getattr(os, name)
           for name in ("replace", "rename", "fsync", "open", "close",
                        "unlink", "remove")}

# the port's package directory: the frame filter records only its I/O
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _from_package_or_tests(extra: Tuple[str, ...] = ()) -> bool:
    """True when the calling frame (outside this module) lives under
    mx_rcnn_tpu_torch or an explicitly-registered runner file — the
    allocation-site filter the lock sanitizer uses, so pytest/stdlib
    I/O under the capture root never pollutes the log."""
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:
        return False
    fn = f.f_code.co_filename
    return fn.startswith(_PKG_DIR) or any(fn.startswith(e) for e in extra)


@dataclass
class Op:
    """One logged persistence operation.  ``kind`` ∈ write | fsync |
    dirfsync | rename | unlink | commit."""
    kind: str
    path: str = ""
    dst: str = ""                  # rename target
    data: Optional[bytes] = None   # write: cumulative content snapshot
    ident: str = ""                # commit marker payload

    def brief(self) -> Dict:
        d = {"kind": self.kind}
        if self.path:
            d["path"] = self.path
        if self.dst:
            d["dst"] = self.dst
        if self.data is not None:
            d["bytes"] = len(self.data)
            d["sha256"] = hashlib.sha256(self.data).hexdigest()[:12]
        if self.ident:
            d["ident"] = self.ident
        return d


class _FileProxy:
    """Wraps a real writable file under the capture root: emits a
    cumulative content snapshot into the op log at every fsync (via the
    recorder's fd map) and at close.  All I/O passes through to the
    real file — the content snapshot is read back from disk, so
    position-seeking writers (np.save headers) are captured exactly."""

    def __init__(self, rec: "CrashRecorder", inner, path: str):
        self._rec = rec
        self._inner = inner
        self._path = path
        self._closed = False

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self):
        return iter(self._inner)

    def snapshot(self) -> None:
        try:
            self._inner.flush()
        except ValueError:
            pass
        with _RAW_OPEN(self._path, "rb") as f:
            content = f.read()
        self._rec._emit_write(self._path, content)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._rec._fd_map.pop(self._fd_safe(), None)
            try:
                self.snapshot()
            finally:
                self._inner.close()
        else:
            self._inner.close()

    def _fd_safe(self) -> int:
        try:
            return self._inner.fileno()
        except (OSError, ValueError):
            return -1


class CrashRecorder:
    """Context manager that arms the shim and collects the op log for
    everything package code persists under ``root``.

    ``drop`` simulates REMOVED durability calls for the sensitivity
    arms: ``"fsync"`` omits file-fsync barriers from the log,
    ``"dirfsync"`` omits directory-fsync barriers — the real syscalls
    still run (the workload must behave identically), only the recorded
    ordering guarantees weaken, exactly as if the code never made the
    calls.
    """

    def __init__(self, root: str, drop: Sequence[str] = (),
                 extra_caller_files: Sequence[str] = ()):
        self.root = os.path.abspath(root)
        self.drop = frozenset(drop)
        self.ops: List[Op] = []
        self._armed = False
        self._fd_map: Dict[int, str] = {}   # fd -> path (os.open + proxies)
        self._extra = tuple(os.path.abspath(e) for e in extra_caller_files)

    # -- log helpers --------------------------------------------------------

    def _under_root(self, path) -> bool:
        try:
            p = os.path.abspath(os.fspath(path))
        except TypeError:
            return False
        # the capture root itself counts: the workload dir's own
        # dir-fsync (the rename barrier) happens on exactly that fd
        return p == self.root or p.startswith(self.root + os.sep)

    def _emit_write(self, path: str, content: bytes) -> None:
        # cumulative snapshots: skip only if identical to the file's last
        # snapshot (fsync followed by close with no new bytes)
        for op in reversed(self.ops):
            if op.kind == "write" and op.path == path:
                if op.data == content:
                    return
                break
            if op.kind == "rename" and (op.path == path or op.dst == path):
                break  # new session under a recycled name
        self.ops.append(Op("write", path=path, data=content))

    def mark_commit(self, ident: str) -> None:
        """Plant a logical durability marker: the workload's commit call
        for ``ident`` has RETURNED, so from here on recovery refusing to
        produce ≥ ``ident`` is a violation."""
        self.ops.append(Op("commit", ident=ident))

    # -- patches ------------------------------------------------------------

    def __enter__(self) -> "CrashRecorder":
        assert not self._armed
        self._armed = True
        rec = self

        def p_open(path, mode="r", *a, **kw):
            f = _RAW_OPEN(path, mode, *a, **kw)
            if (any(c in str(mode) for c in "wax")
                    and rec._under_root(path)
                    and _from_package_or_tests(rec._extra)):
                proxy = _FileProxy(rec, f, os.path.abspath(os.fspath(path)))
                fd = proxy._fd_safe()
                if fd >= 0:
                    rec._fd_map[fd] = proxy._path
                return proxy
            return f

        def p_os_open(path, flags, *a, **kw):
            fd = _RAW_OS["open"](path, flags, *a, **kw)
            if rec._under_root(path) and _from_package_or_tests(rec._extra):
                rec._fd_map[fd] = os.path.abspath(os.fspath(path))
            return fd

        def p_os_close(fd):
            rec._fd_map.pop(fd, None)
            return _RAW_OS["close"](fd)

        def p_fsync(fd):
            path = rec._fd_map.get(fd)
            if path is not None:
                if os.path.isdir(path):
                    if "dirfsync" not in rec.drop:
                        rec.ops.append(Op("dirfsync", path=path))
                else:
                    # snapshot the synced content FIRST so the barrier
                    # covers exactly the bytes that were just made durable
                    with _RAW_OPEN(path, "rb") as f:
                        rec._emit_write(path, f.read())
                    if "fsync" not in rec.drop:
                        rec.ops.append(Op("fsync", path=path))
            return _RAW_OS["fsync"](fd)

        def p_replace(src, dst, **kw):
            out = _RAW_OS["replace"](src, dst, **kw)
            if rec._under_root(dst) and _from_package_or_tests(rec._extra):
                rec.ops.append(Op(
                    "rename", path=os.path.abspath(os.fspath(src)),
                    dst=os.path.abspath(os.fspath(dst))))
            return out

        def p_rename(src, dst, **kw):
            out = _RAW_OS["rename"](src, dst, **kw)
            if rec._under_root(dst) and _from_package_or_tests(rec._extra):
                rec.ops.append(Op(
                    "rename", path=os.path.abspath(os.fspath(src)),
                    dst=os.path.abspath(os.fspath(dst))))
            return out

        def p_unlink(path, **kw):
            out = _RAW_OS["unlink"](path, **kw)
            if rec._under_root(path) and _from_package_or_tests(rec._extra):
                rec.ops.append(Op("unlink",
                                  path=os.path.abspath(os.fspath(path))))
            return out

        builtins.open = p_open
        os.open = p_os_open
        os.close = p_os_close
        os.fsync = p_fsync
        os.replace = p_replace
        os.rename = p_rename
        os.unlink = p_unlink
        os.remove = p_unlink
        return self

    def __exit__(self, *exc) -> bool:
        builtins.open = _RAW_OPEN
        for name, fn in _RAW_OS.items():
            setattr(os, name, fn)
        os.remove = _RAW_OS["remove"]
        self._armed = False
        return False

    def journal(self) -> List[Dict]:
        return [op.brief() for op in self.ops]


# --------------------------------------------------------------------------
# crash-state enumeration
# --------------------------------------------------------------------------

@dataclass
class CrashState:
    """One enumerable post-crash disk state: file contents relative to
    the capture root, the crash point, the in-flight decisions that
    produced it, and the durable floor promised by then."""
    point: int
    fs: Dict[str, bytes]
    floor: Optional[str]
    decisions: Tuple = ()

    def key(self) -> str:
        h = hashlib.sha256()
        for rel in sorted(self.fs):
            h.update(rel.encode())
            h.update(b"\0")
            h.update(hashlib.sha256(self.fs[rel]).digest())
            h.update(b"\1")
        return h.hexdigest()


def _torn(prev: bytes, full: bytes) -> Optional[bytes]:
    """A mid-session tear: the synced prefix plus half the un-synced
    delta (byte granularity; never rewinds past the synced prefix)."""
    if full.startswith(prev):
        delta = full[len(prev):]
        if len(delta) >= 2:
            return prev + delta[:len(delta) // 2]
        return None
    if len(full) >= 2:
        return full[:len(full) // 2]
    return None


def crash_states(ops: Sequence[Op], root: str,
                 max_states_per_point: int = 256
                 ) -> Iterator[CrashState]:
    """Yield every enumerable crash state of the log.  A crash point
    whose combination count exceeds the cap is truncated
    DETERMINISTICALLY and signalled by one sentinel state with
    ``decisions == ("CAPPED",)`` (``simulate`` aggregates these into
    ``capped_points`` — capping is reported, never silent).

    Barrier semantics at a crash point ``k`` (the crash lands after ops
    ``0..k-1`` were issued):

    * a ``write`` on file f followed by an ``fsync`` on f before ``k``
      is FORCED (applied in full);
    * trailing writes after f's last fsync are in flight: each may
      persist in full, as a torn prefix of its session delta, or not at
      all — per-file PREFIX semantics (a later cumulative snapshot
      supersedes an earlier one, so the candidate set is every
      intermediate snapshot plus tears between them);
    * a ``rename``/``unlink`` followed by a ``dirfsync`` of its parent
      directory before ``k`` is FORCED; trailing directory ops may
      individually persist or vanish (same-directory reordering is
      allowed — the model errs toward MORE reachable states);
    * a rename that persists moves whatever content its source has in
      the state (possibly nothing — then the target exists EMPTY: the
      dir entry made it, the un-synced data did not: the classic torn
      publish).
    """
    root = os.path.abspath(root)
    n = len(ops)
    for k in range(n + 1):
        prefix = ops[:k]
        floor: Optional[str] = None
        for op in prefix:
            if op.kind == "commit":
                floor = op.ident
        # forced write per file: the last snapshot at or before the
        # file's last fsync (within the prefix)
        last_fsync: Dict[str, int] = {}
        last_dsync: Dict[str, int] = {}
        for i, op in enumerate(prefix):
            if op.kind == "fsync":
                last_fsync[op.path] = i
            elif op.kind == "dirfsync":
                last_dsync[op.path] = i
        # decision slots, in log order
        slots: List[Tuple[int, List]] = []   # (op index, choices)
        for i, op in enumerate(prefix):
            if op.kind == "write":
                forced = last_fsync.get(op.path, -1) > i
                if forced:
                    continue
                prev = _prev_snapshot(prefix, i)
                choices = [("apply", i), ("skip", i)]
                t = _torn(prev, op.data or b"")
                if t is not None:
                    choices.append(("torn", i, t))
                slots.append((i, choices))
            elif op.kind in ("rename", "unlink"):
                d = os.path.dirname(op.dst or op.path)
                forced = last_dsync.get(d, -1) > i
                if not forced:
                    slots.append((i, [("apply", i), ("skip", i)]))
        combos = product(*[c for _, c in slots]) if slots else iter([()])
        emitted = 0
        capped = False
        for combo in combos:
            if emitted >= max_states_per_point:
                capped = True
                break
            decisions = {c[1]: c for c in combo}
            fs = _materialize_fs(prefix, decisions, root)
            yield CrashState(point=k, fs=fs, floor=floor,
                             decisions=tuple(combo))
            emitted += 1
        if capped:
            yield CrashState(point=k, fs={}, floor=floor,
                             decisions=("CAPPED",))


def _prev_snapshot(prefix: Sequence[Op], i: int) -> bytes:
    """The previous content snapshot of prefix[i]'s file within its
    write session (for tear computation)."""
    path = prefix[i].path
    for j in range(i - 1, -1, -1):
        op = prefix[j]
        if op.kind == "write" and op.path == path:
            return op.data or b""
        if op.kind == "rename" and (op.path == path or op.dst == path):
            return b""
    return b""


def _materialize_fs(prefix: Sequence[Op], decisions: Dict[int, Tuple],
                    root: str) -> Dict[str, bytes]:
    fs: Dict[str, bytes] = {}
    for i, op in enumerate(prefix):
        d = decisions.get(i)
        if op.kind == "write":
            if d is None:                     # forced
                fs[_rel(op.path, root)] = op.data or b""
            elif d[0] == "apply":
                fs[_rel(op.path, root)] = op.data or b""
            elif d[0] == "torn":
                fs[_rel(op.path, root)] = d[2]
            # skip: nothing
        elif op.kind == "rename":
            if d is None or d[0] == "apply":
                src, dst = _rel(op.path, root), _rel(op.dst, root)
                # the rename persists: the target gets whatever data the
                # source has — possibly none (torn publish: empty file)
                fs[dst] = fs.pop(src, b"")
        elif op.kind == "unlink":
            if d is None or d[0] == "apply":
                fs.pop(_rel(op.path, root), None)
    return fs


def _rel(path: str, root: str) -> str:
    return os.path.relpath(path, root)


def materialize(state: CrashState, scratch: str) -> str:
    """Write a crash state into ``scratch`` (wiped first)."""
    if os.path.exists(scratch):
        shutil.rmtree(scratch)
    os.makedirs(scratch)
    for rel, content in state.fs.items():
        p = os.path.join(scratch, rel)
        os.makedirs(os.path.dirname(p) or scratch, exist_ok=True)
        with _RAW_OPEN(p, "wb") as f:
            f.write(content)
    return scratch


# --------------------------------------------------------------------------
# verdict engine
# --------------------------------------------------------------------------

def simulate(ops: Sequence[Op], root: str,
             recover: Callable[[str], Tuple[str, str]],
             idents: Sequence[str], scratch: str,
             max_states_per_point: int = 256) -> Dict:
    """Enumerate every crash state of ``ops``, run ``recover`` against
    each, and assert recover-or-refuse.

    ``recover(dir)`` is the workload's REAL recovery path wrapped to a
    verdict: ``("recovered", ident)`` — it restored a byte-validated
    known artifact; ``("refused", why)`` — it cleanly detected the state
    as unusable through its documented refusal surface; ``("corrupt",
    detail)`` — it SERVED something that matches no known artifact (an
    immediate violation).  ``idents`` is the workload's commit order:
    recovering older than the durable floor, or refusing while a floor
    exists, is a violation.

    Returns a report dict: state counts, verdict tallies, the violation
    list (each with crash point + decisions for reproduction), and the
    per-point cap count (capped points are reported, never silent).
    """
    order = {ident: i for i, ident in enumerate(idents)}
    verdict_cache: Dict[str, Tuple[str, str]] = {}
    seen: set = set()
    report: Dict = {
        "ops": len(ops), "crash_points": len(ops) + 1,
        "states_total": 0, "states_unique": 0,
        "recovered": 0, "refused": 0,
        "violations": [], "capped_points": 0,
    }
    for state in crash_states(ops, root, max_states_per_point):
        if state.decisions == ("CAPPED",):
            report["capped_points"] += 1
            continue
        report["states_total"] += 1
        key = state.key()
        if key not in verdict_cache:
            report["states_unique"] += 1
            materialize(state, scratch)
            try:
                verdict_cache[key] = recover(scratch)
            except Exception as e:  # noqa: BLE001 — an untyped crash in a
                # recovery path is itself a verdict: the documented
                # refusal surface did not cover this state (recorded as
                # a violation, never an aborted enumeration)
                verdict_cache[key] = (
                    "corrupt",
                    f"recovery path crashed with an UNTYPED exception: "
                    f"{type(e).__name__}: {e}")
        outcome, detail = verdict_cache[key]
        if outcome == "recovered":
            report["recovered"] += 1
        elif outcome == "refused":
            report["refused"] += 1
        violation = None
        if outcome == "corrupt":
            violation = (f"recovery SERVED an unknown/corrupt artifact: "
                         f"{detail}")
        elif outcome == "recovered":
            if detail not in order:
                violation = f"recovered unknown ident {detail!r}"
            elif state.floor is not None and \
                    order[detail] < order[state.floor]:
                violation = (f"recovered {detail!r} but {state.floor!r} "
                             "was already durably committed — a promised "
                             "artifact was lost")
        elif outcome == "refused" and state.floor is not None:
            violation = (f"recovery refused ({detail}) but "
                         f"{state.floor!r} was already durably "
                         "committed — a promised artifact was lost")
        if violation is not None and (state.point, key) not in seen:
            seen.add((state.point, key))
            report["violations"].append({
                "point": state.point,
                "floor": state.floor,
                "outcome": outcome,
                "detail": str(detail)[:300],
                "decisions": [list(map(str, d))
                              for d in state.decisions],
                "problem": violation,
            })
    report["ok"] = not report["violations"]
    return report
