"""Checkpoint verification on restore, and retention.

Counterpart of ``mx_rcnn_tpu/ft/integrity.py``.  A host that dies
mid-write, or a byte that rots, can leave the newest checkpoint useless;
:func:`latest_valid_checkpoint` scans the candidates newest first,
verifies each against its manifest (present, parseable, every file's
size and SHA-256), logs a warning for each one it falls back past, and
returns the newest that verifies.

Candidates are ordered by the step their manifest records, not by file
name: a stale interrupt file, left when a run stops between an epoch
checkpoint's commit and ``clear_interrupt``, records an older step than
the epoch checkpoint that superseded it.  At equal steps an epoch file
outranks an interrupt.

Retention (:func:`gc_checkpoints`) keeps the newest ``keep_last`` epoch
checkpoints and every ``keep_every``-th epoch; the snapshot writer runs
it after each epoch checkpoint commits.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import NamedTuple, Optional, Sequence, Set, Tuple

from mx_rcnn_tpu_torch.utils.checkpoint import (interrupt_path,
                                                list_checkpoints,
                                                manifest_path, read_manifest)

logger = logging.getLogger("mx_rcnn_tpu_torch")


class CheckpointRef(NamedTuple):
    """A checkpoint on disk, candidate or verified."""

    kind: str             # 'epoch' | 'interrupt'
    path: str
    step: int             # from the manifest; -1 without one
    epoch: Optional[int]  # the epoch of kind 'epoch', else None
    manifest: dict


def verify_checkpoint(path: str) -> Tuple[bool, str]:
    """(ok, reason): valid when the manifest exists and parses and every
    file it lists has its recorded size and SHA-256.  Catches truncation,
    flipped bytes and uncommitted writes without reading the payload's
    structure."""
    manifest = read_manifest(path)
    if manifest is None:
        return False, "no manifest (uncommitted or pre-manifest checkpoint)"
    files = manifest.get("files") or {}
    if not files:
        return False, "manifest lists no files"
    d = os.path.dirname(path) or "."
    for name, meta in files.items():
        fpath = os.path.join(d, name)
        try:
            with open(fpath, "rb") as f:
                data = f.read()
        except OSError as e:
            return False, f"{name}: unreadable ({e})"
        if len(data) != meta.get("bytes"):
            return False, (f"{name}: size {len(data)} != manifest "
                           f"{meta.get('bytes')} (truncated?)")
        if hashlib.sha256(data).hexdigest() != meta.get("sha256"):
            return False, f"{name}: sha256 mismatch (corrupt)"
    return True, "ok"


def scan_candidates(prefix: str) -> Tuple[CheckpointRef, ...]:
    """Every restore candidate under ``prefix``, best first: by manifest
    step, descending; at equal steps an epoch checkpoint before the
    interrupt, then the higher epoch.  Files without a readable manifest
    sort last (step -1)."""
    cands = []
    for epoch, path in list_checkpoints(prefix):
        m = read_manifest(path)
        cands.append(CheckpointRef(
            "epoch", path, int(m["step"]) if m and "step" in m else -1,
            epoch, m or {}))
    ipath = interrupt_path(prefix)
    if os.path.exists(ipath):
        m = read_manifest(ipath)
        cands.append(CheckpointRef(
            "interrupt", ipath, int(m["step"]) if m and "step" in m else -1,
            None, m or {}))
    cands.sort(key=lambda c: (c.step, 1 if c.kind == "epoch" else 0,
                              c.epoch if c.epoch is not None else -1),
               reverse=True)
    return tuple(cands)


def latest_valid_checkpoint(prefix: str) -> Optional[CheckpointRef]:
    """The newest checkpoint under ``prefix`` that verifies, with a
    warning for each candidate skipped; None when none does."""
    for cand in scan_candidates(prefix):
        ok, reason = verify_checkpoint(cand.path)
        if ok:
            return cand
        logger.warning(
            "checkpoint integrity: SKIPPING %s (%s) — falling back to the "
            "next-newest candidate", cand.path, reason)
    return None


def retention_keep_set(epochs: Sequence[int], keep_last: int,
                       keep_every: int) -> Set[int]:
    """The epochs retention keeps: the newest ``keep_last`` and every
    epoch divisible by ``keep_every`` (0: none of the latter)."""
    epochs = sorted(epochs)
    keep = set(epochs[-keep_last:]) if keep_last else set()
    if keep_every:
        keep.update(e for e in epochs if e % keep_every == 0)
    return keep


def gc_checkpoints(prefix: str, keep_last: int = 3,
                   keep_every: int = 5) -> Tuple[str, ...]:
    """Delete the epoch checkpoints outside the keep set, each manifest
    before its file; returns the deleted files' paths."""
    found = list_checkpoints(prefix)
    keep = retention_keep_set([e for e, _ in found], keep_last, keep_every)
    deleted = []
    for epoch, path in found:
        if epoch in keep:
            continue
        for p in (manifest_path(path), path):
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass
        deleted.append(path)
    if deleted:
        logger.info("retention GC: dropped %d checkpoint(s) under %s "
                    "(keep_last=%d, keep_every=%d)", len(deleted), prefix,
                    keep_last, keep_every)
    return tuple(deleted)
