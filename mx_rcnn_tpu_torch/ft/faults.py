"""Deterministic fault injection: the training process attacks itself.

Counterpart of ``mx_rcnn_tpu/ft/faults.py``.  A fault plan is a
comma-separated spec that the supervisor (``ft/supervisor.py``) passes
to ``tools/train.py --fault_plan`` and tests pass to ``train_net``; the
:class:`FaultInjector` runs each fault once, when the global step first
reaches its trigger.  Kinds:

* ``kill@step=K[@sig=TERM|KILL]``: send the signal to this process.  TERM
  goes through the training CLI's SIGTERM handler, the stop flag and the
  interrupt checkpoint, the path a real preemption takes; KILL leaves no
  checkpoint, so a resume starts from the last committed snapshot;
* ``truncate-last-ckpt@step=K``: truncate the newest epoch checkpoint to
  half its bytes (a torn write), leaving its manifest stale;
* ``flip-byte@step=K[@offset=N]``: XOR one byte of the newest epoch
  checkpoint with 0xFF (bit rot; by default the middle byte);
* ``stale-interrupt@step=K``: copy the newest epoch checkpoint over the
  interrupt path with a valid manifest recording its older step, the
  artifact of a crash between a commit and the interrupt's removal.

File faults wait (bounded) for a committed checkpoint, at or after step
``@after=S`` when given, corrupt it and return; they matter once a later
``kill`` forces a resume.  Same plan and same training stream, same
faults at the same steps.

In a run over ranks (``tools/train.py --num_devices N``) the plan runs in
rank 0 alone, so that a file fault corrupts once, and its signals go to
the launcher, the process a supervisor watches: a TERM there reaches
every rank through the launcher's forwarding, and its death ends the
ranks (``parallel/dp.py — launch``).
"""

from __future__ import annotations

import logging
import os
import shutil
import signal
import time
from typing import Callable, NamedTuple, Optional, Tuple

from mx_rcnn_tpu_torch.utils.checkpoint import (interrupt_path,
                                                latest_checkpoint,
                                                manifest_path, read_manifest,
                                                write_manifest)

logger = logging.getLogger("mx_rcnn_tpu_torch")

KINDS = ("kill", "truncate-last-ckpt", "flip-byte", "stale-interrupt")

_SIGNALS = {"TERM": signal.SIGTERM, "KILL": signal.SIGKILL}


class Fault(NamedTuple):
    kind: str
    step: int
    sig: str = "KILL"             # kill only
    offset: Optional[int] = None  # flip-byte only
    # file faults: the committed checkpoint to wait for is at step >= this
    after: Optional[int] = None


def parse_plan(spec: str) -> Tuple[Fault, ...]:
    """``"kill@step=5@sig=TERM,flip-byte@step=9@offset=64"`` → the faults
    by step.  An unknown kind or field, a missing step or a signal other
    than TERM and KILL raises: a typo that skipped a fault would certify
    nothing."""
    faults = []
    for item in filter(None, (s.strip() for s in spec.split(","))):
        kind, *kvs = item.split("@")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; have {KINDS}")
        kw = {}
        for kv in kvs:
            key, sep, val = kv.partition("=")
            if not sep:
                raise ValueError(f"fault field {kv!r} must be key=value")
            kw[key] = val
        if "step" not in kw:
            raise ValueError(f"fault {item!r} needs @step=K")
        step = int(kw.pop("step"))
        sig = kw.pop("sig", "KILL").upper()
        if sig not in _SIGNALS:
            raise ValueError(f"fault sig must be TERM or KILL, got {sig!r}")
        offset = int(kw.pop("offset")) if "offset" in kw else None
        after = int(kw.pop("after")) if "after" in kw else None
        if kw:
            raise ValueError(f"fault {item!r}: unknown fields {sorted(kw)}")
        faults.append(Fault(kind, step, sig, offset, after))
    return tuple(sorted(faults, key=lambda f: f.step))


class FaultInjector:
    """Runs a plan against the training run under ``prefix``: wire
    :meth:`on_step` as the fit loop's ``step_callback``.  ``kill_fn``
    takes the signal; by default it goes to this process."""

    def __init__(self, plan: Tuple[Fault, ...], prefix: str,
                 kill_fn: Optional[Callable[[int], None]] = None):
        self.plan = tuple(plan)
        self.prefix = prefix
        self._fired = [False] * len(self.plan)
        self._kill = kill_fn or (lambda s: os.kill(os.getpid(), s))

    def on_step(self, step: int) -> None:
        for i, fault in enumerate(self.plan):
            if self._fired[i] or step < fault.step:
                continue
            self._fired[i] = True
            logger.warning("FAULT INJECTION at step %d: %s", step, fault)
            getattr(self, "_do_" + fault.kind.replace("-", "_"))(fault)

    def _do_kill(self, fault: Fault) -> None:
        self._kill(_SIGNALS[fault.sig])

    def _newest_epoch_ckpt(self, min_step: Optional[int] = None,
                           wait_s: float = 15.0) -> Optional[str]:
        """The newest committed epoch checkpoint (at or after ``min_step``
        when given), waited for up to ``wait_s``: the background writer
        commits a beat after the epoch ends, and a file not yet committed
        is already invisible to a resume."""
        deadline = time.monotonic() + wait_s
        while True:
            found = latest_checkpoint(self.prefix)
            if found is not None and os.path.exists(manifest_path(found[1])):
                m = read_manifest(found[1])
                if (min_step is None
                        or (m is not None and m.get("step", -1) >= min_step)):
                    return found[1]
            if time.monotonic() >= deadline:
                logger.warning(
                    "fault wants a committed checkpoint (step >= %s) to "
                    "corrupt but none appeared under %s within %.0fs",
                    min_step, self.prefix, wait_s)
                return None
            time.sleep(0.05)

    def _do_truncate_last_ckpt(self, fault: Fault) -> None:
        path = self._newest_epoch_ckpt(min_step=fault.after)
        if path is None:
            return
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        logger.warning("truncated %s: %d -> %d bytes (manifest now stale)",
                       path, size, size // 2)

    def _do_flip_byte(self, fault: Fault) -> None:
        path = self._newest_epoch_ckpt(min_step=fault.after)
        if path is None:
            return
        size = os.path.getsize(path)
        offset = fault.offset if fault.offset is not None else size // 2
        offset = min(max(offset, 0), size - 1)
        with open(path, "r+b") as f:
            f.seek(offset)
            b = f.read(1)
            f.seek(offset)
            f.write(bytes([b[0] ^ 0xFF]))
        logger.warning("flipped byte at offset %d of %s", offset, path)

    def _do_stale_interrupt(self, fault: Fault) -> None:
        path = self._newest_epoch_ckpt(min_step=fault.after)
        if path is None:
            return
        ipath = interrupt_path(self.prefix)
        shutil.copyfile(path, ipath)
        m = read_manifest(path) or {}
        with open(ipath, "rb") as f:
            data = f.read()
        # a valid manifest recording the older step: the scanner must rank
        # the newer epoch checkpoint above it
        write_manifest(ipath, data, kind="interrupt",
                       step=int(m.get("step", 0)),
                       steps_per_epoch=m.get("steps_per_epoch"),
                       config_fp=m.get("config_fingerprint"))
        logger.warning("planted stale interrupt checkpoint at %s (step %s)",
                       ipath, m.get("step"))
