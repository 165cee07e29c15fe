"""Checkpoints in the JAX package's file layout.

Counterpart of ``mx_rcnn_tpu/utils/checkpoint.py``: one file per epoch,
``prefix-%04d.ckpt``, holding flax's msgpack of the whole train state
``{step, params, batch_stats, opt_state}`` (``utils/bridge.py —
host_state_to_flax`` gives its layout), written through a durable
atomic rename, then a ``.manifest.json`` sidecar with the payload's
sha256 and byte count, written last as the commit point.  Either
package reads the other's files.  The msgpack is the port's own
(``utils/flax_msgpack.py``): no msgpack package is needed.

A checkpoint is committed once its manifest exists.  The manifest
records its ``kind`` (``epoch``, or ``interrupt`` for the mid-epoch
``prefix-interrupt.ckpt`` a stopped run writes, whose payload is
``{"state": ..., "steps_per_epoch": ...}``), the writing run's
``topology`` (:func:`make_topology`) and, from it, the ``data_cursor``
a resumed run positions its loader by.  :func:`serialize_state` and
:func:`commit_checkpoint` split a save at the seam the background writer
needs (``ft/snapshot.py``): the owned host copy is taken on the step's
thread, the bytes are made and written on another.

Weights stay in normalised bbox space (the predictor de-normalises at
decode time), so a checkpoint is both the eval format and the resume
format, and resuming from one is exact.

A reader checks the payload against the manifest when one is present and
refuses a mismatch.  The manifest's ``config_fingerprint`` hashes the
port's own config; it is recorded, never compared with a JAX
fingerprint, since the two configs have different fields.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np

from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.utils import flax_msgpack
from mx_rcnn_tpu_torch.utils.bridge import (HostTrainState, from_flax,
                                            host_state_to_flax,
                                            host_train_state,
                                            load_train_state, to_flax)


def checkpoint_path(prefix: str, epoch: int) -> str:
    """``prefix-%04d.ckpt``."""
    return f"{prefix}-{epoch:04d}.ckpt"


def manifest_path(path: str) -> str:
    """The commit-point manifest beside a checkpoint file."""
    return path + ".manifest.json"


def _atomic_write(path: str, data: bytes) -> str:
    """tmp → fsync(tmp) → replace → fsync(dir): a crash leaves the old
    file or the new one whole, and the rename survives a host crash.  The
    staging name is unique per process and thread; a failed write removes
    it."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}-{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    dir_fd = os.open(d or ".", os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)
    return path


_FINGERPRINT_SECTIONS = ("train", "network", "dataset", "default", "bucket")


def config_fingerprint(cfg) -> str:
    """sha256 prefix of the port config's training sections (their
    dataclass reprs, :func:`_fingerprint_repr`)."""
    parts = "\n".join(_fingerprint_repr(getattr(cfg, s))
                      for s in _FINGERPRINT_SECTIONS)
    return hashlib.sha256(parts.encode()).hexdigest()[:16]


# levers added after fingerprints were first recorded: left out of the
# fingerprint at their default, so every earlier fingerprint still holds;
# a lever that is set changes the model and lands in it
_DEFAULT_STRIPPED_LEVERS = frozenset({"stem_channel_pad"})


def _fingerprint_repr(section) -> str:
    """``repr(section)`` without the :data:`_DEFAULT_STRIPPED_LEVERS` that
    sit at their default (the dataclass repr's format otherwise)."""
    if not dataclasses.is_dataclass(section):
        return repr(section)
    parts = []
    for f in dataclasses.fields(section):
        if not f.repr:
            continue
        v = getattr(section, f.name)
        if (f.name in _DEFAULT_STRIPPED_LEVERS
                and f.default is not dataclasses.MISSING
                and v == f.default):
            continue
        parts.append(f"{f.name}={v!r}")
    return f"{type(section).__qualname__}({', '.join(parts)})"


def make_topology(num_devices: int, num_processes: int = 1,
                  grad_accum: int = 1, batch_images: int = 1) -> Dict:
    """The manifest's ``topology``: the writing run's device and process
    counts, its ``grad_accum`` and its effective batch, the images one
    optimizer step consumes (devices x batch_images x grad_accum)."""
    return {
        "devices": int(num_devices),
        "processes": int(num_processes),
        "grad_accum": int(grad_accum),
        "global_batch": int(num_devices) * int(batch_images)
        * int(grad_accum),
    }


def write_manifest(path: str, data: bytes, *, kind: str, step: int,
                   epoch: Optional[int] = None,
                   steps_per_epoch: Optional[int] = None,
                   config_fp: Optional[str] = None,
                   topology: Optional[Dict] = None) -> str:
    """Write the manifest of ``path`` whose payload is ``data`` (hashed
    here, not re-read), as sorted-key JSON.  With a ``topology`` and
    ``steps_per_epoch`` it carries the data cursor: the epoch, the
    optimizer steps into it, the loader batches they consumed
    (``grad_accum`` each) and the images consumed since step 0."""
    manifest = {
        "format": 1,
        "kind": kind,
        "step": int(step),
        "epoch": epoch,
        "steps_per_epoch": steps_per_epoch,
        "config_fingerprint": config_fp,
        "files": {os.path.basename(path): {
            "sha256": hashlib.sha256(data).hexdigest(),
            "bytes": len(data),
        }},
    }
    if topology is not None:
        manifest["topology"] = topology
        if steps_per_epoch:
            in_epoch = int(step) % int(steps_per_epoch)
            manifest["data_cursor"] = {
                "epoch": int(step) // int(steps_per_epoch),
                "steps_in_epoch": in_epoch,
                "batches_consumed": in_epoch
                * int(topology.get("grad_accum", 1)),
                "images_consumed": int(step)
                * int(topology.get("global_batch", 0)),
            }
    return _atomic_write(manifest_path(path),
                         json.dumps(manifest, indent=1,
                                    sort_keys=True).encode())


def read_manifest(path: str) -> Optional[Dict[str, Any]]:
    """The parsed manifest of ``path``, or None if absent or unparseable."""
    try:
        with open(manifest_path(path), "rb") as f:
            return json.loads(f.read().decode())
    except (FileNotFoundError, ValueError, UnicodeDecodeError):
        return None


def _read_verified(path: str) -> bytes:
    """The payload of ``path``, checked against its manifest's sha256 and
    byte count when a manifest is present."""
    with open(path, "rb") as f:
        data = f.read()
    if not os.path.exists(manifest_path(path)):
        return data
    manifest = read_manifest(path)
    entry = (manifest or {}).get("files", {}).get(os.path.basename(path))
    if entry is None:
        raise ValueError(f"{manifest_path(path)} is unreadable or does not "
                         f"name {os.path.basename(path)}")
    digest = hashlib.sha256(data).hexdigest()
    if entry.get("sha256") != digest or entry.get("bytes") != len(data):
        raise ValueError(
            f"{path} does not match its manifest: sha256 {digest}, "
            f"{len(data)} bytes; the manifest says {entry.get('sha256')}, "
            f"{entry.get('bytes')} bytes")
    return data


def serialize_state(host: HostTrainState) -> bytes:
    """The checkpoint bytes of a host copy of the train state
    (``utils/bridge.py — host_train_state``)."""
    return flax_msgpack.packb(host_state_to_flax(host))


def serialize_interrupt(host: HostTrainState,
                        steps_per_epoch: Optional[int]) -> bytes:
    """The bytes of an interrupt checkpoint: the state and the
    steps per epoch of the run that wrote it."""
    return flax_msgpack.packb({"state": host_state_to_flax(host),
                               "steps_per_epoch": steps_per_epoch})


def commit_checkpoint(path: str, data: bytes, *, kind: str, step: int,
                      epoch: Optional[int] = None,
                      steps_per_epoch: Optional[int] = None,
                      config_fp: Optional[str] = None,
                      topology: Optional[Dict] = None) -> str:
    """Durably write ``data``, then its manifest (the commit point)."""
    _atomic_write(path, data)
    write_manifest(path, data, kind=kind, step=step, epoch=epoch,
                   steps_per_epoch=steps_per_epoch, config_fp=config_fp,
                   topology=topology)
    return path


def save_checkpoint(prefix: str, epoch: int, state, *,
                    steps_per_epoch: Optional[int] = None,
                    config_fp: Optional[str] = None,
                    topology: Optional[Dict] = None) -> str:
    """Write the train state (``core/train.py — TrainState``) as
    ``prefix-%04d.ckpt``, then its manifest; returns the path."""
    host = host_train_state(state.model, state.optimizer)
    return commit_checkpoint(
        checkpoint_path(prefix, epoch), serialize_state(host), kind="epoch",
        step=host.step, epoch=epoch, steps_per_epoch=steps_per_epoch,
        config_fp=config_fp, topology=topology)


def save_params(prefix: str, epoch: int, state_dict) -> str:
    """Write weights alone as ``prefix-%04d.ckpt`` (step 0, no optimizer
    state, the JAX package's ``TrainState(step=0, params, batch_stats,
    opt_state={})``), then its manifest; returns the path.  The
    alternate schedule's combined model is saved so."""
    tree = to_flax(state_dict)
    return commit_checkpoint(
        checkpoint_path(prefix, epoch), flax_msgpack.packb({
            "step": np.array(0, np.int32), "params": tree["params"],
            "batch_stats": tree["batch_stats"], "opt_state": {}}),
        kind="epoch", step=0, epoch=epoch)


def load_checkpoint(prefix: str, epoch: int) -> Dict[str, Any]:
    """The raw tree of a checkpoint, checked against its manifest."""
    return flax_msgpack.unpackb(_read_verified(checkpoint_path(prefix,
                                                               epoch)))


def restore_state(state, prefix: str, epoch: int):
    """Write a checkpoint into ``state`` (a freshly built ``TrainState``
    of the same model and optimizer) in place; returns it."""
    load_train_state(load_checkpoint(prefix, epoch), state.model,
                     state.optimizer)
    return state


def load_param(prefix: str, epoch: int) -> Tuple[Dict, Dict]:
    """(params, batch_stats) flax trees of a checkpoint: the eval view
    (``utils/bridge.py — from_flax`` takes them to a state_dict)."""
    raw = load_checkpoint(prefix, epoch)
    return raw["params"], raw.get("batch_stats", {})


def load_state_dict(prefix: str, epoch: int) -> Dict:
    """A checkpoint's weights and statistics as the port's state_dict
    (fp32 tensors on the host)."""
    params, batch_stats = load_param(prefix, epoch)
    return from_flax({"params": params, "batch_stats": batch_stats})


def combine_model(state_a: Mapping, state_b: Mapping,
                  from_a: Iterable[str]) -> Dict:
    """Merge two state_dicts by top-level component (``backbone``,
    ``rpn``, ``head``, ``cls_score``, ``bbox_pred``): the entries whose
    component starts with a ``from_a`` prefix come from ``state_a``, the
    rest from ``state_b`` (``mx_rcnn_tpu/utils/checkpoint.py —
    combine_model`` on flax trees; the alternate schedule takes the RPN
    and the shared convs from rpn2 and the head from rcnn2)."""
    from_a = tuple(from_a)
    ours = lambda key: key.split(".", 1)[0].startswith(from_a)
    out = {k: v for k, v in state_b.items() if not ours(k)}
    out.update((k, v) for k, v in state_a.items() if ours(k))
    return out


def load_model(cfg, prefix: str, epoch: int, device="cuda"):
    """The test-mode model of ``cfg`` on ``device`` (CUDA unless the
    caller asks for the CPU) with the weights of ``prefix``@``epoch``."""
    model = build_model(cfg, device, seed=None)
    model.load_state_dict(load_state_dict(prefix, epoch))
    return model


def list_checkpoints(prefix: str) -> Tuple[Tuple[int, str], ...]:
    """Every epoch checkpoint under ``prefix`` as (epoch, path), by epoch."""
    d = os.path.dirname(prefix) or "."
    base = os.path.basename(prefix)
    if not os.path.isdir(d):
        return ()
    found = []
    for name in os.listdir(d):
        if name.startswith(base + "-") and name.endswith(".ckpt"):
            stem = name[len(base) + 1:-5]
            if stem.isdigit():
                found.append((int(stem), os.path.join(d, name)))
    return tuple(sorted(found))


def latest_checkpoint(prefix: str) -> Optional[Tuple[int, str]]:
    """The highest-epoch checkpoint under ``prefix``, or None."""
    found = list_checkpoints(prefix)
    return found[-1] if found else None


def interrupt_path(prefix: str) -> str:
    """The mid-epoch checkpoint a stopped run writes (SIGTERM)."""
    return f"{prefix}-interrupt.ckpt"


def save_interrupt(prefix: str, state, steps_per_epoch: Optional[int] = None,
                   *, config_fp: Optional[str] = None,
                   topology: Optional[Dict] = None) -> str:
    """Write the train state at its current step as the interrupt
    checkpoint, with ``steps_per_epoch``: a resumed run maps the step
    back to (epoch, batches consumed) only under the same value."""
    host = host_train_state(state.model, state.optimizer)
    return commit_checkpoint(
        interrupt_path(prefix), serialize_interrupt(host, steps_per_epoch),
        kind="interrupt", step=host.step, steps_per_epoch=steps_per_epoch,
        config_fp=config_fp, topology=topology)


def restore_interrupt(state, prefix: str) -> Tuple[Any, Optional[int]]:
    """Write the interrupt checkpoint (either package's) into ``state``
    in place, checked against its manifest; returns (state,
    steps_per_epoch), the latter None for a file that did not record
    it."""
    raw = flax_msgpack.unpackb(_read_verified(interrupt_path(prefix)))
    spe = None
    if isinstance(raw, dict) and "state" in raw and "steps_per_epoch" in raw:
        raw, spe = raw["state"], raw["steps_per_epoch"]
    load_train_state(raw, state.model, state.optimizer)
    return state, (int(spe) if spe is not None else None)


def clear_interrupt(prefix: str) -> None:
    """Remove the interrupt checkpoint once an epoch checkpoint supersedes
    it: the manifest first, so a kill between the two unlinks leaves an
    uncommitted file that resume skips."""
    for p in (manifest_path(interrupt_path(prefix)), interrupt_path(prefix)):
        try:
            os.unlink(p)
        except FileNotFoundError:
            pass
