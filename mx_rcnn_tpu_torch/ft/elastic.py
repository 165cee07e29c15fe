"""Elastic run controller: a preemption becomes a resize, not a crash.

Counterpart of ``mx_rcnn_tpu/ft/elastic.py``.  A scheduler (the drills'
``ft/supervisor.py``, or any fleet controller) atomically writes a
topology directive ``{"generation": G, "num_devices": D,
"num_processes": P, "ts": ...}`` to ``<prefix>.topology.json`` and may
SIGUSR1 the process to read it at once; otherwise the controller reads it
every ``elastic.poll_steps`` polls of the stop flag.  A directive newer
than the applied one drains the run through the stop flag (the step in
flight finishes, the interrupt checkpoint is written, ``train_net``
returns), then:

* **the live resize.**  A single ``tools/train.py --elastic`` process
  trains each generation in process (a world of one) or over ranks it
  launches (``tools/train.py — _launch_ranks``, one process a device).
  A directive changing the device count starts the next generation at
  the new size without exiting.  Its generation restores the newest
  checkpoint that verifies, onto freshly built ranks that
  ``parallel/dp.py — replicate`` makes equal (the JAX ``respec``, here
  :data:`respec`), and checks the restore bit for bit
  (:func:`_verify_restore`: the state re-serialised hashes to the
  manifest's sha256);
* **the world resize.**  A host of a world over several processes
  (``--coordinator``/``--num_processes``/``--process_id``) drains and
  exits :data:`EXIT_RESIZE` at any resize, as does a single process
  whose directive changes the process count: the supervisor relaunches
  the world at the new size, and it restores through the same path.

The effective global batch stays the recipe's: ``grad_accum =
base_devices / devices`` (:func:`infer_base_devices`), so a world of half
the devices runs two microbatches an optimizer step, and
``steps_per_epoch``, ``state.step`` and the lr decay boundaries never
move.

Every transition is emitted as an ``ELASTIC_EVENT {json}`` stdout line
(the supervisor's timeline, :func:`parse_events`), a run-record event
and the obs registry's ``elastic.*`` gauges and counters.

Stated differences from the JAX package:

- The launcher polls the directive between its ranks' results (about
  every 0.2 s), not after each step.  In a generation over ranks, rank 0
  emits ``first_step`` and ``restore`` (its stdout is the launcher's)
  and the ranks open no obs session; the launcher's registry keeps the
  gauges and the shrink, grow, rescale and drain counters.
- There is no lowering to count: ``first_step`` and ``generation_end``
  carry ``builds``, the kernel libraries built in the process since the
  generation began (``kernels.load_events``), 0 in a steady run.
- Peers of a world stop together (the collective stop flag,
  ``core/fit.py``), so a preempted host drains its peers instead of
  wedging them; a host whose world stopped under it before the run's end
  reports ``peer_failure`` and exits :data:`EXIT_PEER_FAILURE`.
- On a card a directive asks for at most the cards there are (times the
  hosts); on the CPU for any number of ranks.
"""

from __future__ import annotations

import hashlib
import json
import logging
import signal
import threading
import time
from typing import Callable, Dict, NamedTuple, Optional

from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.ft.integrity import (CheckpointRef,
                                            latest_valid_checkpoint)
from mx_rcnn_tpu_torch.parallel.dp import replicate
from mx_rcnn_tpu_torch.utils.bridge import host_train_state
from mx_rcnn_tpu_torch.utils.checkpoint import (_atomic_write,
                                                serialize_interrupt,
                                                serialize_state)

logger = logging.getLogger("mx_rcnn_tpu_torch")

# exit codes the supervisor keys on: EXIT_RESIZE, a clean drain for a
# resize this process cannot apply (its world's process set changes);
# EXIT_PEER_FAILURE, a peer of the world failed or stopped it under this
# process, which recovers from the last committed snapshot
EXIT_RESIZE = 77
EXIT_PEER_FAILURE = 78

# the JAX ``respec`` (re-place restored state on the new mesh): here each
# rank restores the checkpoint and rank 0's copy is broadcast
respec = replicate


class Topology(NamedTuple):
    """One topology directive, or the topology applied."""

    generation: int
    num_devices: int
    num_processes: int = 1
    ts: float = 0.0  # when the scheduler issued it (recovery counts from it)


def topology_path(prefix: str, cfg=None) -> str:
    """Where directives land for ``prefix`` (``elastic.topology_path``
    overrides)."""
    override = getattr(getattr(cfg, "elastic", None), "topology_path", "")
    return override or f"{prefix}.topology.json"


def write_topology(path: str, generation: int, num_devices: int,
                   num_processes: int = 1, ts: Optional[float] = None) -> str:
    """Atomically publish a directive (the scheduler's side); ``ts``
    defaults to now."""
    payload = {"generation": int(generation),
               "num_devices": int(num_devices),
               "num_processes": int(num_processes),
               "ts": float(time.time() if ts is None else ts)}
    return _atomic_write(path, json.dumps(payload, indent=1).encode())


def read_topology(path: str) -> Optional[Topology]:
    """The directive in ``path``; None when it is absent or unparseable
    (a torn file is ignored until the scheduler's rename lands)."""
    try:
        with open(path, "rb") as f:
            raw = json.loads(f.read().decode())
        return Topology(int(raw["generation"]), int(raw["num_devices"]),
                        int(raw.get("num_processes", 1)),
                        float(raw.get("ts", 0.0)))
    except (FileNotFoundError, ValueError, KeyError, TypeError,
            UnicodeDecodeError):
        return None


def infer_base_devices(cfg, prefix: str, directive: Topology) -> int:
    """The recipe's device count: ``elastic.base_devices`` when set, else
    the newest verified checkpoint's ``global_batch / batch_images``, else
    (a fresh run) the directive's count.  A relaunched world that took a
    shrunken directive as its base would halve the global batch."""
    if cfg.elastic.base_devices:
        return cfg.elastic.base_devices
    ref = latest_valid_checkpoint(prefix)
    gb = ((ref.manifest.get("topology") or {}).get("global_batch")
          if ref is not None else None)
    if gb:
        return max(int(gb) // cfg.train.batch_images, 1)
    return directive.num_devices


def _divide_base(base: int, devices: int, allow_remainder: bool) -> int:
    """``grad_accum`` for ``devices`` under the recipe's ``base``.  A
    count that does not divide it changes the global batch: refused
    unless ``ft.allow_resize_resume``."""
    if base % devices == 0:
        return base // devices
    if allow_remainder:
        accum = max(base // devices, 1)
        logger.warning(
            "elastic: base_devices=%d not divisible by %d devices — "
            "grad_accum=%d changes the effective global batch "
            "(ft.allow_resize_resume permits it)", base, devices, accum)
        return accum
    raise ValueError(
        f"elastic: base_devices={base} is not divisible by "
        f"{devices} devices — the effective global batch cannot be "
        f"preserved; choose a divisor topology or set "
        f"ft.allow_resize_resume=true to accept the change")


def emit_event(event: str, **payload) -> Dict:
    """Print one ``ELASTIC_EVENT`` line; returns its record."""
    rec = {"ts": round(time.time(), 6), "event": event, **payload}
    print("ELASTIC_EVENT " + json.dumps(rec), flush=True)
    return rec


_COUNTERS = {"shrink": "elastic.shrinks", "grow": "elastic.grows",
             "restore": "elastic.restores", "rescale": "elastic.rescales",
             "peer_failure": "elastic.peer_failures",
             "drain": "elastic.drains"}


class ElasticController:
    """Watches the directives of one training process and emits its
    transitions (stdout timeline, ``run_record``, the process registry).
    """

    def __init__(self, cfg, prefix: str, run_record=None,
                 install_signal: bool = True):
        from mx_rcnn_tpu_torch.obs.metrics import registry

        self.cfg = cfg
        self.prefix = prefix
        self.path = topology_path(prefix, cfg)
        self.run_record = run_record
        self.poll_steps = max(int(cfg.elastic.poll_steps), 1)
        self._poll_now = False
        self._applied: Optional[Topology] = None
        self._pending: Optional[Topology] = None
        # poll() may run off the training thread while mark_applied() runs
        # on it; one lock covers the applied/pending pair
        self._topo_lock = threading.Lock()
        self._steps_since_poll = 0
        self._rec = registry()
        if install_signal:
            try:
                signal.signal(signal.SIGUSR1, self._on_sigusr1)
            except ValueError:  # not the main thread
                logger.warning("elastic: not on the main thread — SIGUSR1 "
                               "poll trigger disabled, file polling only")

    def _on_sigusr1(self, signum, frame):
        self._poll_now = True  # a flag only: the handler must not block

    def applied(self) -> Optional[Topology]:
        return self._applied

    def mark_applied(self, topo: Topology) -> None:
        with self._topo_lock:
            self._applied = topo
            self._pending = None
        self._rec.set_gauge("elastic.generation", topo.generation)
        self._rec.set_gauge("elastic.num_devices", topo.num_devices)
        self._rec.set_gauge("elastic.num_processes", topo.num_processes)

    def pending(self) -> Optional[Topology]:
        """The directive awaiting application (from the last poll)."""
        return self._pending

    def poll(self) -> Optional[Topology]:
        """Read the directive now; returns (and keeps) one newer than the
        applied topology, else None."""
        directive = read_topology(self.path)
        with self._topo_lock:
            if directive is not None and (
                    self._applied is None
                    or directive.generation > self._applied.generation):
                self._pending = directive
            return self._pending

    def resize_requested(self) -> bool:
        """The stop flag's check: reads the directive every
        ``poll_steps`` calls, or at once after a SIGUSR1."""
        if self._pending is not None:
            return True
        self._steps_since_poll += 1
        if self._poll_now or self._steps_since_poll >= self.poll_steps:
            self._poll_now = False
            self._steps_since_poll = 0
            if self.poll() is not None:
                self.emit("resize_requested",
                          generation=self._pending.generation,
                          num_devices=self._pending.num_devices,
                          num_processes=self._pending.num_processes,
                          directive_ts=self._pending.ts)
                return True
        return False

    def make_stop_flag(self, user_stop: Optional[Callable[[], bool]] = None
                       ) -> Callable[[], bool]:
        """The run's stop flag: the user's (SIGTERM) or a pending resize;
        both drain through the interrupt checkpoint."""
        def flag() -> bool:
            if user_stop is not None and user_stop():
                return True
            return self.resize_requested()

        return flag

    def emit(self, event: str, **payload) -> None:
        emit_event(event, **payload)
        if self.run_record is not None:
            self.run_record.event("elastic_" + event, **payload)
        counter = _COUNTERS.get(event)
        if counter:
            self._rec.inc(counter)
        if event == "first_step" and "recovery_ms" in payload:
            self._rec.observe("elastic.recovery_ms",
                              float(payload["recovery_ms"]),
                              lo=1.0, hi=600_000.0)
        if event == "peer_failure":
            # the flight record keeps what led into the exit
            try:
                from mx_rcnn_tpu_torch.obs import flightrec

                flightrec.trigger("elastic-peer-failure", **payload)
            except Exception:
                logger.debug("elastic: flight trigger failed",
                             exc_info=True)


def parse_events(text: str):
    """The ``ELASTIC_EVENT`` records of a worker's stdout (torn lines of a
    killed process are skipped)."""
    events = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("ELASTIC_EVENT "):
            try:
                events.append(json.loads(line[len("ELASTIC_EVENT "):]))
            except ValueError:
                pass
    return events


def _verify_restore(ref: CheckpointRef, state,
                    steps_per_epoch: Optional[int]):
    """Whether the restored ``state`` re-serialises to the bytes of the
    checkpoint it came from (sha256 against the manifest); returns
    (bit_identical, sha)."""
    host = host_train_state(state.model, state.optimizer)
    if ref.kind == "interrupt":
        data = serialize_interrupt(host, steps_per_epoch)
    else:
        data = serialize_state(host)
    sha = hashlib.sha256(data).hexdigest()
    recorded = next(iter((ref.manifest.get("files") or {}).values()), {})
    return sha == recorded.get("sha256"), sha


def _builds() -> int:
    return kernels.load_events()["builds"]


class _GenerationHooks:
    """One generation's ``first_step`` and restore audit: ``on_step`` is
    the run's step callback and the object itself its
    ``post_restore_callback``.  It pickles without its controller, so that
    rank 0 of a launch runs it and prints the events itself."""

    def __init__(self, generation: int, detect_ts: Optional[float],
                 ctrl: Optional[ElasticController] = None):
        self.generation = generation
        self.detect_ts = detect_ts
        self.ctrl = ctrl
        self.seen = False
        self.builds0 = _builds()

    def __getstate__(self):
        return {**self.__dict__, "ctrl": None}

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.builds0 = _builds()  # the new process's own count

    def _emit(self, event: str, **payload) -> None:
        if self.ctrl is not None:
            self.ctrl.emit(event, **payload)
        else:
            emit_event(event, **payload)

    def on_step(self, step: int) -> None:
        if self.seen:
            return
        self.seen = True
        payload = dict(generation=self.generation, step=step,
                       builds=_builds() - self.builds0)
        if self.detect_ts:
            payload["recovery_ms"] = round(
                (time.time() - self.detect_ts) * 1e3, 1)
        self._emit("first_step", **payload)

    def __call__(self, state, ref: CheckpointRef,
                 steps_per_epoch: Optional[int]) -> None:
        ok, sha = _verify_restore(ref, state, steps_per_epoch)
        self._emit("restore", generation=self.generation, kind=ref.kind,
                   path=ref.path, step=ref.step, bit_identical=bool(ok),
                   sha256=sha)
        if not ok:
            raise RuntimeError(
                f"elastic restore is NOT bit-identical to {ref.path} "
                f"(re-serialized sha {sha} != manifest); refusing to "
                f"continue training on corrupted state")


def _complete(prefix: str, end_epoch: int) -> Optional[CheckpointRef]:
    """The newest verified checkpoint when it is the run's last epoch's."""
    ref = latest_valid_checkpoint(prefix)
    if ref is not None and ref.kind == "epoch" and ref.epoch >= end_epoch:
        return ref
    return None


def run_elastic(cfg, *, prefix: str, end_epoch: Optional[int] = None,
                lr: Optional[float] = None, lr_step: Optional[str] = None,
                frequent: Optional[int] = None, seed: int = 0,
                dataset_kw: Optional[dict] = None, synthetic: int = 0,
                pretrained: Optional[str] = None, pretrained_epoch: int = 0,
                stop_flag: Optional[Callable[[], bool]] = None,
                run_record=None, fault_plan: Optional[str] = None,
                device="cuda", num_devices: Optional[int] = None,
                coordinator: Optional[str] = None, num_processes: int = 1,
                process_id: int = 0,
                log: Callable[[str], None] = print) -> int:
    """The generation loop (module docstring); returns the process's exit
    code: 0 when the run completed or a SIGTERM drained it,
    :data:`EXIT_RESIZE` or :data:`EXIT_PEER_FAILURE`.

    ``device``: CUDA unless the caller asks for the CPU.  ``num_devices``:
    the first generation's device count when no directive exists (all
    cards of the hosts by default; one rank a process on the CPU).
    ``coordinator``, ``num_processes``, ``process_id``: this process is a
    host of a world over several (``tools/train.py --coordinator``); every
    resize then exits.  ``fault_plan`` acts in the first generation
    only."""
    import torch

    from mx_rcnn_tpu_torch.parallel.multihost import host_ranks
    from mx_rcnn_tpu_torch.tools.train import train_net
    from mx_rcnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    multiproc = coordinator is not None
    nproc = num_processes if multiproc else 1
    ctrl = ElasticController(cfg, prefix, run_record=run_record)
    end_epoch = cfg.default.e2e_epoch if end_epoch is None else end_epoch
    available = (torch.cuda.device_count() * nproc if dev.type == "cuda"
                 else None)
    directive = read_topology(ctrl.path)
    if directive is None:
        directive = Topology(0, num_devices or available or nproc, nproc)
    base = infer_base_devices(cfg, prefix, directive)
    allow = cfg.ft.allow_resize_resume
    rank_cfg = cfg.replace_in("obs", enabled=False)
    generations = 0
    last_accum: Optional[int] = None

    while True:
        generations += 1
        if generations > cfg.elastic.max_generations:
            raise RuntimeError(
                f"elastic: more than {cfg.elastic.max_generations} "
                f"generations in one run — topology thrash; raise "
                f"elastic.max_generations if this is intended")
        devices = directive.num_devices
        if available is not None and devices > available:
            ctrl.emit("clamped", requested=devices, available=available)
            devices = available
        accum = _divide_base(base, devices, allow)
        prev = ctrl.applied()
        ctrl.mark_applied(directive._replace(num_devices=devices))
        ctrl._rec.set_gauge("elastic.grad_accum", accum)
        if prev is not None:
            kind = "shrink" if devices < prev.num_devices else "grow"
            ctrl.emit(kind, generation=directive.generation,
                      num_devices=devices,
                      num_processes=directive.num_processes,
                      from_devices=prev.num_devices,
                      from_processes=prev.num_processes)
            if accum != last_accum:
                ctrl.emit("rescale", grad_accum=accum,
                          global_batch=devices * cfg.train.batch_images
                          * accum)
        last_accum = accum
        in_process = devices == 1 and not multiproc
        ranks = host_ranks(devices, nproc, process_id if multiproc else 0)
        ctrl.emit("mesh", generation=directive.generation,
                  num_devices=devices, num_processes=nproc,
                  grad_accum=accum, base_devices=base,
                  loader_shard=[process_id if multiproc else 0, nproc],
                  ranks=[ranks[0], ranks[-1]])

        gen = directive.generation
        hooks = _GenerationHooks(gen, directive.ts or None,
                                 ctrl if in_process else None)
        kw = dict(prefix=prefix, end_epoch=end_epoch, lr=lr,
                  lr_step=lr_step, frequent=frequent, seed=seed,
                  dataset_kw=dataset_kw, synthetic=synthetic,
                  pretrained=pretrained, pretrained_epoch=pretrained_epoch,
                  resume=("auto" if latest_valid_checkpoint(prefix)
                          is not None else False),
                  stop_flag=ctrl.make_stop_flag(stop_flag),
                  step_callback=hooks.on_step, post_restore_callback=hooks,
                  grad_accum=accum, fault_plan=fault_plan, device=dev,
                  log=log)
        try:
            if in_process:
                state, _ = train_net(cfg, run_record=run_record, **kw)
                final_step = state.step
            else:
                train_net(rank_cfg, num_devices=devices,
                          coordinator=coordinator, num_processes=nproc,
                          process_id=process_id, **kw)
                ref = latest_valid_checkpoint(prefix)
                final_step = ref.step if ref is not None else 0
        except Exception as e:  # noqa: BLE001 — classified below
            if multiproc:
                # a peer or the collectives failed under this host; the
                # relaunched world recovers from the last snapshot
                ctrl.emit("peer_failure", generation=gen,
                          error=repr(e)[:500])
                logger.error("elastic: peer/collective failure: %s", e)
                return EXIT_PEER_FAILURE
            raise
        ctrl.emit("generation_end", generation=gen, step=final_step,
                  **({"builds": _builds() - hooks.builds0}
                     if in_process else {}))
        fault_plan = None  # a plan fires once, in its first generation

        # train_net returns because the run completed, the user's stop
        # fired or a resize drained it, classified in that order
        if stop_flag is not None and stop_flag():
            ctrl.emit("drain", generation=gen, reason="sigterm",
                      step=final_step)
            return 0
        pending = ctrl.pending() or ctrl.poll()
        if pending is None:
            if multiproc and _complete(prefix, end_epoch) is None:
                # the world stopped collectively under this host: a peer
                # was preempted
                ctrl.emit("peer_failure", generation=gen,
                          reason="the world stopped under this host",
                          step=final_step)
                return EXIT_PEER_FAILURE
            ctrl.emit("complete", generation=gen, step=final_step)
            return 0
        if multiproc or pending.num_processes != nproc:
            # the process set changes: the supervisor relaunches the world
            ctrl.emit("drain", generation=pending.generation,
                      reason="process_resize",
                      num_processes=pending.num_processes)
            return EXIT_RESIZE
        directive = pending  # the live resize: the next generation
