"""Crash-loop supervisor: kill training M times, auto-resume, prove the
survivor bit-identical to an uninterrupted run; the elastic storm; the
relaunch pacing of the serving fleet.

Counterpart of ``mx_rcnn_tpu/ft/supervisor.py``:

* :class:`RestartPolicy`: exponential backoff with a deterministic
  jitter between restarts, and the crash-loop verdict (the serving fleet
  paces its replicas with it too);
* :func:`run_crashloop`: a control run of ``tools/train.py``, then a
  survivor killed by the events of a schedule (SIGTERM through the
  production preemption path, SIGKILL with no chance to react, torn
  writes, bit rot, a stale interrupt checkpoint via ``--fault_plan``)
  and restarted with ``--resume auto`` until it completes; its final
  checkpoint is compared with the control's byte for byte.  SIGKILLs
  land past an epoch boundary, where a committed checkpoint exists
  (a storm of them inside one epoch would loop forever); the kill steps
  come from ``np.random.RandomState(rng_seed)``, so a seed realises the
  JAX supervisor's plans at the same resume points;
* :func:`measure_snapshot_overhead`: the train step with and without
  per-epoch snapshots, asynchronous and synchronous;
* :func:`run_elastic_storm`: a world of ``tools/train.py --elastic``
  processes through a preemption storm (``ft/elastic.py``).

Stated differences from the JAX package:

- Each child runs ``tools/train.py``'s ``main`` under a ``-c`` bootstrap
  (:func:`_train_cmd`) that makes cuDNN deterministic and turns TF32
  off, as a byte-equal survivor on a card needs, and prints the kernel
  launches after each step (``KERNEL_LAUNCHES``).  Children train on
  ``device``: the card unless the caller asks for the CPU (the JAX
  children always run on the CPU).
- A storm's world is two ``tools/train.py --elastic --coordinator``
  processes of one rank each.  With fewer cards than ranks (one card)
  the bootstrap places every rank on ``cuda:0`` over gloo (the test rig
  of ``tools/train.py — _launch_ranks``: NCCL refuses two ranks on one
  card); with enough cards each process gets its own through
  ``CUDA_VISIBLE_DEVICES`` and NCCL.  The record says which (``rig``).
- The storm's recompile check reads kernel builds (``builds``), where
  the JAX one reads lowerings.  The storm acts on the world's own lines
  where the JAX one scans checkpoints and sleeps, which a fast world can
  outrun to its end: it preempts the first world once its step lines
  pass the first epoch, and the smoke grows the shrunk world back at its
  ``first_step`` event; the record counts the steps left at the grow
  (``steps_left_at_grow``).
- :func:`measure_snapshot_overhead` takes ``network`` (the JAX one fixes
  the tiny network) and ``device``, and its stall excludes the wait for
  the steps already queued on the card (it synchronises first): that
  wait is the steps' time, which the JAX ``device_get`` folds in.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("mx_rcnn_tpu_torch")


class RestartPolicy:
    """Backoff between restarts, and a verdict on a crash loop.

    Consecutive failures without progress back off exponentially
    (``base_s * factor^(n-1)``, capped at ``cap_s``) with a jitter that
    is a pure function of ``(seed, n)`` (sha256), so a schedule is
    reproducible and supervisors with different seeds do not restart in
    step.  ``give_up_after`` consecutive IDENTICAL failures (same
    signature) return ``give_up``: a run that dies the same way every
    time is a bug, not a transient, and restarting it only burns
    capacity.  Progress resets the schedule.

    The gauges ``ft.supervisor.backoff_s``,
    ``ft.supervisor.consecutive_failures`` and ``ft.supervisor.crash_loop``
    go to ``registry`` (the process registry unless one is given; the
    fleet gives each replica a private one).  ``clock`` stamps
    ``ready_at``, the earliest restart instant.  One RLock guards the
    counts: the fleet's health monitor and its relaunch threads record
    on the same policy.
    """

    def __init__(self, base_s: float = 0.25, factor: float = 2.0,
                 cap_s: float = 30.0, jitter_frac: float = 0.25,
                 give_up_after: int = 4, seed: int = 0, registry=None,
                 clock=time.monotonic):
        self.base_s = base_s
        self.factor = factor
        self.cap_s = cap_s
        self.jitter_frac = jitter_frac
        self.give_up_after = give_up_after
        self.seed = seed
        self._clock = clock
        self.ready_at: float = float("-inf")
        self.failures = 0          # consecutive failures without progress
        self.identical = 0         # consecutive identical failures
        self._last_sig: Optional[tuple] = None
        # reentrant: delay_s is called from inside record
        self._lock = threading.RLock()
        if registry is None:
            from mx_rcnn_tpu_torch.obs.metrics import registry as _registry

            registry = _registry()
        self._rec = registry

    def delay_s(self, n_failures: Optional[int] = None) -> float:
        """The backoff before restart attempt ``n_failures`` (1-based;
        the current count by default); 0.0 while there is progress."""
        with self._lock:
            n = self.failures if n_failures is None else n_failures
        if n <= 0:
            return 0.0
        try:
            d = min(self.base_s * self.factor ** (n - 1), self.cap_s)
        except OverflowError:  # past ~1000 failures the power leaves float
            d = self.cap_s
        # jitter in [-jitter_frac, +jitter_frac], the same for (seed, n)
        h = int(hashlib.sha256(f"{self.seed}:{n}".encode()).hexdigest(),
                16) % 10_000
        return d * (1.0 + self.jitter_frac * (h / 5_000.0 - 1.0))

    def record(self, signature: tuple, made_progress: bool
               ) -> Tuple[float, bool]:
        """Record one attempt's outcome; returns ``(delay_s, give_up)``.
        ``signature`` names the failure mode; ``made_progress`` resets
        the schedule."""
        with self._lock:
            if made_progress:
                self.failures = 0
                self.identical = 0
                self._last_sig = None
            else:
                self.failures += 1
                self.identical = (self.identical + 1
                                  if signature == self._last_sig else 1)
                self._last_sig = signature
            give_up = self.identical >= self.give_up_after
            delay = self.delay_s()
            self.ready_at = self._clock() + delay
            failures, identical = self.failures, self.identical
        self._rec.set_gauge("ft.supervisor.backoff_s", delay)
        self._rec.set_gauge("ft.supervisor.consecutive_failures", failures)
        self._rec.set_gauge("ft.supervisor.crash_loop", int(give_up))
        if give_up:
            logger.error(
                "crash-loop verdict: %d consecutive identical failures "
                "(%r): a deterministic fault, not a transient; refusing to "
                "restart", identical, signature)
        return delay, give_up


# one kill event, realised as a fault plan once the resume point is known:
# (file fault or None, signal name, placement).  'mid': the resume point
# plus a few steps (a step-exact TERM resume); 'boundary': past the next
# epoch boundary, where a committed checkpoint exists to fall back to (a
# SIGKILL's progress and a file fault's target need one)
KillEvent = Tuple[Optional[str], str, str]

DEFAULT_EVENTS: Tuple[KillEvent, ...] = (
    (None, "TERM", "mid"),          # planned preemption, mid-epoch
    (None, "KILL", "boundary"),     # planned hard kill
    (None, "TERM", "mid"),          # random-step preemption
    ("truncate-last-ckpt", "KILL", "boundary"),  # torn write + hard kill
    ("flip-byte", "KILL", "boundary"),           # bit rot + hard kill
    ("stale-interrupt", "KILL", "boundary"),     # crash between commit+clear
)

SMOKE_EVENTS: Tuple[KillEvent, ...] = (
    (None, "TERM", "mid"),
    ("truncate-last-ckpt", "KILL", "boundary"),
)

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# a child's bootstrap: argv[1] names the rig's card ('' for none), argv[2]
# asks for the launch lines ('1'), the rest are tools/train.py's flags
_CHILD = """
import sys, time, torch
t0 = time.perf_counter()
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from mx_rcnn_tpu_torch.parallel.multihost import host_ranks
from mx_rcnn_tpu_torch.tools import train
rig, count = sys.argv[1], sys.argv[2] == "1"
if rig:
    launch = train._launch_ranks

    def _rig(cfg, num_devices, **kw):
        n = len(host_ranks(num_devices, kw.get("num_processes", 1),
                           kw.get("process_id", 0)))
        return launch(cfg, num_devices, devices=[rig] * n, backend="gloo",
                      **kw)

    train._launch_ranks = _rig
if count:
    from mx_rcnn_tpu_torch.ft.supervisor import _StepLine
    net = train.train_net

    def _counted(cfg, **kw):
        kw["step_callback"] = _StepLine(kw.get("step_callback"), t0)
        return net(cfg, **kw)

    train.train_net = _counted
train.main(sys.argv[3:])
"""


class _StepLine:
    """A child's step callback: the run's own, then one ``KERNEL_LAUNCHES``
    line (the step, seconds since the child started, the kernel launches
    so far).  It pickles, so that rank 0 of a launch prints the lines."""

    def __init__(self, callback, t0: float):
        self.callback = callback
        self.t0 = t0  # perf_counter's clock is the host's, in every process

    def __call__(self, step: int) -> None:
        from mx_rcnn_tpu_torch import kernels

        if self.callback is not None:
            self.callback(step)
        print("KERNEL_LAUNCHES " + json.dumps(dict(
            step=step, t=round(time.perf_counter() - self.t0, 3),
            **kernels.launch_counts())), flush=True)


def _child_env() -> Dict[str, str]:
    """This process's environment with the package's root first on
    ``PYTHONPATH``, so a child imports the same package from anywhere."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PKG_ROOT, env.get("PYTHONPATH")) if p)
    return env


def _train_cmd(prefix: str, *, network: str, dataset: str, end_epoch: int,
               seed: int, num_images: int, image_size: Tuple[int, int],
               resume: bool, fault_plan: Optional[str], device: str = "cuda",
               rig: str = "", count_launches: bool = False) -> List[str]:
    """A child's command: ``tools/train.py`` under the :data:`_CHILD`
    bootstrap (deterministic cuDNN, no TF32; ``rig``: every rank on that
    card over gloo; ``count_launches``: the ``KERNEL_LAUNCHES`` lines),
    batch 1 without flips on ``num_images`` synthetic images of
    ``image_size``, in the JAX supervisor's miniature recipe."""
    h, w = image_size
    cmd = [sys.executable, "-c", _CHILD, rig, "1" if count_launches else "0",
           "--network", network, "--dataset", dataset,
           "--prefix", prefix, "--end_epoch", str(end_epoch),
           "--seed", str(seed), "--frequent", "1000", "--no_flip",
           "--device", device,
           "--dataset_kw",
           repr({"num_images": num_images, "image_size": (h, w),
                 "max_objects": 3}),
           "--set", "train__rpn_pre_nms_top_n=1024",
           "--set", "train__rpn_post_nms_top_n=300",
           "--set", "train__max_gt_boxes=8",
           "--set", f"bucket__scale={min(h, w)}",
           "--set", f"bucket__max_size={max(h, w)}",
           "--set", f"bucket__shapes=(({h},{w}),({w},{h}))"]
    if resume:
        cmd += ["--resume", "auto"]
    if fault_plan:
        cmd += ["--fault_plan", fault_plan]
    return cmd


def _progress(prefix: str):
    """(step, ref) of the newest valid checkpoint under ``prefix`` ((0,
    None) when nothing restores): the supervisor's view of a child's
    progress, through the scanner the child resumes with."""
    from mx_rcnn_tpu_torch.ft.integrity import latest_valid_checkpoint

    ref = latest_valid_checkpoint(prefix)
    return (0, None) if ref is None else (ref.step, ref)


def _plan_for(event: KillEvent, cur: int, steps_per_epoch: int,
              total_steps: int, rng) -> Optional[str]:
    """The fault plan realising ``event`` from resume point ``cur``, or
    None when the run is too close to its end (one draw from ``rng``
    either way, as the JAX supervisor draws)."""
    file_fault, sig, placement = event
    if placement == "boundary":
        # +1 epoch: a committed checkpoint exists to resume from.  A
        # corrupting fault goes +2: it destroys the newest committed
        # checkpoint, and an older one must exist for the fallback
        ahead = 2 if file_fault in ("truncate-last-ckpt", "flip-byte") else 1
        boundary = (cur // steps_per_epoch + ahead) * steps_per_epoch
        kill_step = boundary + int(rng.randint(2, 6))
    else:
        boundary = None
        kill_step = cur + int(rng.randint(3, 12))
    if kill_step > total_steps - 2:
        return None
    parts = []
    if file_fault:
        # @after pins the fault to the snapshot committed at this boundary
        parts.append(f"{file_fault}@step={kill_step - 1}@after={boundary}")
    parts.append(f"kill@step={kill_step}@sig={sig}")
    return ",".join(parts)


def _launch_lines(stdout: str) -> List[Dict]:
    out = []
    for line in stdout.splitlines():
        if line.startswith("KERNEL_LAUNCHES "):
            try:
                out.append(json.loads(line[len("KERNEL_LAUNCHES "):]))
            except ValueError:
                pass  # torn by a kill
    return out


def _launches(stdout: str, start_step: int) -> Dict:
    """A child's kernel launches per step (from its last launch line) and
    its seconds from start to its first step."""
    lines = _launch_lines(stdout)
    if not lines:
        return {"steps_run": 0}
    last = lines[-1]
    steps = last["step"] - start_step
    counts = {k: v for k, v in last.items() if k not in ("step", "t")}
    return {"steps_run": steps,
            "launches_per_step": {k: v / max(steps, 1)
                                  for k, v in counts.items()},
            "first_step_s": lines[0]["t"]}


def _same_tree(a, b) -> bool:
    """Two checkpoint trees with the same keys and the same bytes and
    dtype at every leaf."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and sorted(a) == sorted(b)
                and all(_same_tree(a[k], b[k]) for k in a))
    return _leaf(a) == _leaf(b)


def _leaf(x) -> Tuple[str, tuple, bytes]:
    """A checkpoint leaf's dtype, shape and bytes (a bf16 leaf is a torch
    tensor, which numpy cannot hold)."""
    import torch

    if isinstance(x, torch.Tensor):
        flat = x.detach().contiguous().reshape(-1)
        return (str(x.dtype), tuple(x.shape),
                flat.view(torch.uint8).numpy().tobytes())
    x = np.asarray(x)
    return str(x.dtype), x.shape, x.tobytes()


def run_crashloop(workdir: str, *, events: Tuple[KillEvent, ...] = None,
                  network: str = "tiny", dataset: str = "synthetic",
                  end_epoch: int = 5, num_images: int = 32,
                  image_size: Tuple[int, int] = (128, 160), seed: int = 0,
                  rng_seed: int = 0, attempt_timeout_s: float = 900.0,
                  max_attempts: int = 30, device: str = "cuda") -> Dict:
    """Control run, the kill/resume gauntlet and the bit-exact comparison,
    each child a ``tools/train.py`` on ``device``; returns the record
    (``tools/crashloop.py``).  Raises on a child that dies other than by
    an injected kill, on a loop without progress and on a timeout."""
    from mx_rcnn_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                    load_checkpoint)

    events = DEFAULT_EVENTS if events is None else tuple(events)
    steps_per_epoch = num_images  # batch 1, --no_flip
    total_steps = end_epoch * steps_per_epoch
    rng = np.random.RandomState(rng_seed)
    os.makedirs(workdir, exist_ok=True)
    kw = dict(network=network, dataset=dataset, end_epoch=end_epoch,
              seed=seed, num_images=num_images, image_size=image_size,
              device=device, count_launches=True)
    env = _child_env()

    def run_child(prefix, resume, fault_plan, label):
        cmd = _train_cmd(prefix, resume=resume, fault_plan=fault_plan, **kw)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=attempt_timeout_s)
        wall = time.perf_counter() - t0
        fallbacks = (proc.stdout + proc.stderr).count(
            "checkpoint integrity: SKIPPING")
        logger.info("[%s] exit=%s wall=%.1fs fallbacks=%d", label,
                    proc.returncode, wall, fallbacks)
        return proc, wall, fallbacks

    # ---- control: the uninterrupted run ---------------------------------
    control_prefix = os.path.join(workdir, "control", "e2e")
    proc, control_wall, _ = run_child(control_prefix, False, None, "control")
    if proc.returncode != 0:
        raise RuntimeError(f"control run failed (exit {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    cstep, _ = _progress(control_prefix)
    if cstep < total_steps:
        raise RuntimeError(f"control run finished at step {cstep} < "
                           f"{total_steps} — recipe/schedule mismatch")
    control_launches = _launches(proc.stdout, 0)

    # ---- survivor: the kill/resume gauntlet -------------------------------
    prefix = os.path.join(workdir, "survivor", "e2e")
    attempts: List[Dict] = []
    kills_survived = 0
    fallback_events = 0
    pending = list(events)
    policy = RestartPolicy(seed=rng_seed)
    for attempt in range(max_attempts):
        cur, _ref = _progress(prefix)
        if cur >= total_steps:
            break
        plan = None
        if pending:
            plan = _plan_for(pending[0], cur, steps_per_epoch, total_steps,
                             rng)
            if plan is not None:
                pending.pop(0)
            else:
                # too close to the end to kill meaningfully: the caller
                # sees the shortfall in kills_survived
                logger.warning("dropping %d unplaced kill event(s) — run "
                               "too close to completion", len(pending))
                pending.clear()
        proc, wall, fallbacks = run_child(
            prefix, resume=attempt > 0 or cur > 0, fault_plan=plan,
            label=f"attempt {attempt} plan={plan}")
        fallback_events += fallbacks
        after, _ = _progress(prefix)
        rec = {"attempt": attempt, "plan": plan, "exit": proc.returncode,
               "resume_step": cur, "progress_step": after,
               "wall_s": round(wall, 1), "fallbacks": fallbacks,
               **_launches(proc.stdout, cur)}
        attempts.append(rec)
        killed = proc.returncode < 0 or (
            plan is not None and "sig=TERM" in plan and proc.returncode == 0
            and after < total_steps)
        if killed:
            kills_survived += 1
        elif proc.returncode != 0:
            raise RuntimeError(
                f"survivor attempt {attempt} died WITHOUT an injected kill "
                f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}")
        # progress resets the backoff; identical failures without progress
        # eventually give up
        delay, give_up = policy.record((proc.returncode, cur), after > cur)
        rec["backoff_s"] = round(delay, 3)
        if give_up:
            raise RuntimeError(
                f"crash-loop verdict after {policy.identical} identical "
                f"no-progress failures (exit {proc.returncode} at step "
                f"{cur}); attempts={attempts}")
        if delay:
            logger.info("restart backoff: sleeping %.2fs", delay)
            time.sleep(delay)
    else:
        raise RuntimeError(f"crashloop did not converge in {max_attempts} "
                           f"attempts; attempts={attempts}")

    # ---- verdict: the final train states, bit for bit ---------------------
    pa = checkpoint_path(control_prefix, end_epoch)
    pb = checkpoint_path(prefix, end_epoch)
    sha = []
    for p in (pa, pb):
        with open(p, "rb") as f:
            sha.append(hashlib.sha256(f.read()).hexdigest())
    bit_identical = _same_tree(load_checkpoint(control_prefix, end_epoch),
                               load_checkpoint(prefix, end_epoch))
    return {
        "total_steps": total_steps,
        "steps_per_epoch": steps_per_epoch,
        "end_epoch": end_epoch,
        "device": device,
        "kills_survived": kills_survived,
        "kills_planned": len(events),
        "fallback_events": fallback_events,
        "attempts": attempts,
        "control_wall_s": round(control_wall, 1),
        "control": control_launches,
        "final_ckpt_sha256": {"control": sha[0], "survivor": sha[1]},
        "files_identical": sha[0] == sha[1],
        "bit_identical": bool(bit_identical),
    }


def measure_snapshot_overhead(steps: int = 96, snapshot_every: int = 32,
                              warmup: int = 5, network: str = "tiny",
                              device: str = "cuda") -> Dict:
    """Snapshot cost at the crash loop's per-epoch cadence, two views:

    * ``*_overhead_pct_1core``: the mean step's inflation against no
      checkpointing, end to end (the JAX record's names; on a host with
      cores to spare the writer thread contends little);
    * ``*_stall_ms_per_snapshot`` and ``async_stall_overhead_pct``: the
      time the training thread is blocked a snapshot (asynchronous: the
      owned host copy and the hand-over; synchronous: the whole write),
      after the queued steps are done, with the pinned copies prepared
      before the first step as ``core/fit.py`` prepares them (each
      snapshot's stall in ``stalls_ms``); the crash loop's <5% criterion
      reads ``async_stall_overhead_pct``.

    ``network``: ``'tiny'`` on a 128x160 canvas with the JAX function's
    miniature recipe, or a full network (``'resnet101'``) on the 608x1024
    bucket with pre/post-NMS 6000/2000; batch 1 either way, on
    ``device`` (the card unless the caller asks for the CPU)."""
    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.train import make_train_step, setup_training
    from mx_rcnn_tpu_torch.ft.snapshot import (AsyncSnapshotter,
                                               SyncSnapshotter)
    from mx_rcnn_tpu_torch.tools.profile_step import make_batch
    from mx_rcnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if network == "tiny":
        cfg = generate_config("tiny", "PascalVOC").replace_in(
            "train", rpn_pre_nms_top_n=256, rpn_post_nms_top_n=64,
            batch_rois=32, max_gt_boxes=8, rpn_min_size=2)
        h, w = 128, 160
    else:
        cfg = generate_config(network, "PascalVOC",
                              train__rpn_pre_nms_top_n=6000,
                              train__rpn_post_nms_top_n=2000)
        h, w = 608, 1024
    if dev.type == "cuda":
        kernels.build_all()
    batch = make_batch(cfg, 1, h, w, device=dev)
    step = make_train_step(cfg)
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))

    def run(n, snap=None):
        s = setup_training(cfg, dev, 0, steps_per_epoch=1000)
        for _ in range(warmup):
            step(s, batch)
        if snap is not None:
            t1 = time.perf_counter()
            snap.prepare(s)  # as fit does before its first step
            prepare_ms[snap] = round((time.perf_counter() - t1) * 1e3, 2)
        sync()
        stalls = []
        t0 = time.perf_counter()
        for i in range(n):
            step(s, batch)
            if snap is not None and (i + 1) % snapshot_every == 0:
                sync()  # the queued steps' time is theirs
                t1 = time.perf_counter()
                snap.save_epoch((i + 1) // snapshot_every, s)
                stalls.append(time.perf_counter() - t1)
        sync()
        if snap is not None:
            snap.flush()
        wall = time.perf_counter() - t0
        stall_ms[snap] = [round(x * 1e3, 2) for x in stalls]
        return wall / n, (float(np.mean(stalls)) if stalls else 0.0)

    stall_ms, prepare_ms = {}, {}
    base, _ = run(steps)
    with tempfile.TemporaryDirectory() as d:
        a = AsyncSnapshotter(os.path.join(d, "async", "m"), cfg,
                             steps_per_epoch=snapshot_every)
        t_async, stall_a = run(steps, a)
        a.close()
        sync_snap = SyncSnapshotter(os.path.join(d, "sync", "m"), cfg,
                                    snapshot_every)
        t_sync, stall_s = run(steps, sync_snap)
    epoch_s = snapshot_every * base
    return {
        "network": network,
        "device": str(dev),
        "steps": steps,
        "snapshot_every": snapshot_every,
        "base_step_ms": round(base * 1e3, 2),
        "async_step_ms": round(t_async * 1e3, 2),
        "sync_step_ms": round(t_sync * 1e3, 2),
        "async_overhead_pct_1core": round((t_async - base) / base * 100, 2),
        "sync_overhead_pct_1core": round((t_sync - base) / base * 100, 2),
        "async_stall_ms_per_snapshot": round(stall_a * 1e3, 2),
        "sync_stall_ms_per_snapshot": round(stall_s * 1e3, 2),
        "async_stall_overhead_pct": round(stall_a / epoch_s * 100, 2),
        "sync_stall_overhead_pct": round(stall_s / epoch_s * 100, 2),
        "stalls_ms": {"async": stall_ms[a], "sync": stall_ms[sync_snap]},
        # the pinned copies' allocation, once a run before its first step
        "prepare_ms": {"async": prepare_ms[a],
                       "sync": prepare_ms[sync_snap]},
    }


# ---------------------------------------------------------------------------
# The elastic storm
# ---------------------------------------------------------------------------
# The crash loop's generalisation: a world of tools/train.py --elastic
# processes through a preemption storm.  Every casualty becomes a resize:
# the supervisor publishes a topology directive (ft/elastic.py —
# write_topology) naming the surviving devices, relaunches (or SIGUSR1s)
# the world, and the controller restores the newest valid checkpoint,
# checks it bit for bit and keeps stepping.  Recovery is timed from the
# detection to the first step of the new generation.


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


class _Worker:
    """One supervised training process whose stdout is read as it comes:
    the supervisor synchronises on the ``ELASTIC_EVENT`` timeline and the
    ``KERNEL_LAUNCHES`` step lines while the worker runs."""

    def __init__(self, proc: subprocess.Popen, idx: int, gen: int):
        self.proc = proc
        self.idx = idx
        self.gen = gen
        # the pump appends while the supervisor polls: both under _lock
        self._lock = threading.Lock()
        self._lines: List[str] = []
        self._events: List[Dict] = []
        self.step = 0  # the last step of its KERNEL_LAUNCHES lines
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    @property
    def events(self) -> List[Dict]:
        """The ``ELASTIC_EVENT`` records seen so far (the dicts are
        shared: the harvest tags them in place)."""
        with self._lock:
            return list(self._events)

    def _pump(self) -> None:
        for line in self.proc.stdout:
            line = line.rstrip("\n")
            with self._lock:
                self._lines.append(line)
            if line.startswith("ELASTIC_EVENT "):
                try:
                    ev = json.loads(line[len("ELASTIC_EVENT "):])
                    ev["proc"] = self.idx
                    with self._lock:
                        self._events.append(ev)
                except ValueError:
                    pass  # torn by a kill
            elif line.startswith("KERNEL_LAUNCHES "):
                lines = _launch_lines(line)
                if lines:
                    self.step = lines[0]["step"]

    def alive(self) -> bool:
        return self.proc.poll() is None

    def signal(self, sig: int) -> None:
        if self.alive():
            self.proc.send_signal(sig)

    def join(self, timeout: float) -> Optional[int]:
        """The exit code, or None on timeout."""
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None
        self._thread.join(timeout=5.0)
        return self.proc.returncode

    def tail(self, n: int = 30) -> str:
        with self._lock:
            return "\n".join(self._lines[-n:])

    def locksan_dirty(self) -> bool:
        """Whether a sanitizer-armed child reported an inversion or a
        watchdog trip (``LOCKSAN_DIRTY``)."""
        with self._lock:
            return any(line.startswith("LOCKSAN_DIRTY")
                       for line in self._lines)


def run_elastic_storm(workdir: str, *, smoke: bool = False,
                      network: str = "tiny", dataset: str = "synthetic",
                      end_epoch: Optional[int] = None, num_images: int = 24,
                      image_size: Tuple[int, int] = (128, 160),
                      seed: int = 0, base_devices: int = 2,
                      grace_s: float = 60.0, world_timeout_s: float = 600.0,
                      device: str = "cuda") -> Dict:
    """Drive a world of elastic training processes on ``device`` through
    a preemption storm; returns the record (``tools/crashloop.py
    --elastic``).

    The full drill: 4 planned kills (2 SIGTERM, 2 SIGKILL), a world shrink
    (2 processes x 1 device -> 1 x 1, grad_accum 2), a live device grow
    (1 -> 2 devices, no relaunch), a SIGKILL on the grown run and a world
    grow back (1 -> 2 processes) that runs to completion; on CUDA it needs
    ``base_devices`` cards.  ``smoke``: one TERM preemption -> shrink ->
    grow back at the shrunk world's first step -> completion.  The record's
    ``steps_left_at_grow`` counts the steps the grown world had left."""
    import torch

    from mx_rcnn_tpu_torch.ft.elastic import (EXIT_RESIZE, topology_path,
                                              write_topology)

    cards = torch.cuda.device_count() if device.startswith("cuda") else 0
    if device.startswith("cuda") and not smoke and cards < base_devices:
        # its live grow to base_devices in one process needs the cards
        raise ValueError(f"the full storm needs {base_devices} cards, "
                         f"{cards} found; run the smoke")
    end_epoch = end_epoch or (4 if smoke else 12)
    spe = num_images // base_devices  # optimizer steps an epoch
    total_steps = end_epoch * spe
    prefix = os.path.join(workdir, "storm", "e2e")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    tpath = topology_path(prefix)
    env = _child_env()
    rig = "cuda:0" if device.startswith("cuda") and cards < base_devices \
        else ""
    kw = dict(network=network, dataset=dataset, end_epoch=end_epoch,
              seed=seed, num_images=num_images, image_size=image_size,
              resume=False, fault_plan=None, device=device, rig=rig,
              count_launches=True)

    timeline: List[Dict] = []
    recoveries: List[Dict] = []
    kills = {"TERM": 0, "KILL": 0}
    casualties = 0
    worlds = 0
    locksan_dirty_workers = 0
    all_events: List[Dict] = []
    policy = RestartPolicy(seed=seed)

    def sup_event(event: str, **payload) -> Dict:
        rec = {"ts": round(time.time(), 6), "event": event,
               "by": "supervisor", **payload}
        timeline.append(rec)
        logger.info("storm: %s %s", event, payload)
        return rec

    def harvest(workers: List[_Worker]) -> None:
        nonlocal locksan_dirty_workers
        for w in workers:
            evs = w.events
            for ev in evs:
                ev.setdefault("by", f"worker{w.idx}.g{w.gen}")
            all_events.extend(evs)
            if w.locksan_dirty():
                locksan_dirty_workers += 1

    def launch_world(gen: int, devices: int, procs: int,
                     local_devices: int) -> List[_Worker]:
        nonlocal worlds
        worlds += 1
        cmd_base = _train_cmd(prefix, **kw)
        cmd_base += ["--elastic",
                     "--set", f"elastic__base_devices={base_devices}"]
        workers = []
        port = _free_port() if procs > 1 else None
        for i in range(procs):
            cmd = list(cmd_base)
            wenv = dict(env)
            if device.startswith("cuda") and not rig:
                # this host's cards, as a host of its own would see them
                wenv["CUDA_VISIBLE_DEVICES"] = ",".join(
                    str(i * local_devices + j) for j in range(local_devices))
            if procs > 1:
                cmd += ["--coordinator", f"localhost:{port}",
                        "--num_processes", str(procs),
                        "--process_id", str(i)]
            workers.append(_Worker(subprocess.Popen(
                cmd, env=wenv, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), i, gen))
        sup_event("world_launch", generation=gen, num_processes=procs,
                  num_devices=devices, local_devices=local_devices)
        return workers

    def wait_event(workers: List[_Worker], name: str, gen: int,
                   timeout: float) -> Dict:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for w in workers:
                for ev in list(w.events):
                    if ev["event"] == name and ev.get("generation") == gen:
                        return ev
            if all(not w.alive() for w in workers):
                break
            time.sleep(0.05)
        tails = "\n---\n".join(w.tail() for w in workers)
        raise RuntimeError(
            f"storm: timed out ({timeout:.0f}s) waiting for worker event "
            f"{name!r} gen {gen} (workers alive="
            f"{[w.alive() for w in workers]}):\n{tails}")

    def wait_progress(step: int, timeout: float = None) -> int:
        deadline = time.monotonic() + (timeout or world_timeout_s)
        while time.monotonic() < deadline:
            cur, _ = _progress(prefix)
            if cur >= step:
                return cur
            time.sleep(0.1)
        raise RuntimeError(f"storm: no progress to step {step} "
                           f"(at {_progress(prefix)[0]})")

    def wait_step(workers: List[_Worker], step: int) -> None:
        deadline = time.monotonic() + world_timeout_s
        while time.monotonic() < deadline:
            if any(w.step >= step for w in workers):
                return
            if all(not w.alive() for w in workers):
                break
            time.sleep(0.01)
        raise RuntimeError(f"storm: no step line reached step {step} "
                           f"(at {[w.step for w in workers]})")

    def record_recovery(kind: str, detect_ts: float, ev: Dict) -> None:
        recoveries.append({
            "kind": kind, "detect_ts": round(detect_ts, 6),
            "first_step_ts": ev["ts"], "generation": ev.get("generation"),
            "recovery_ms": round((ev["ts"] - detect_ts) * 1e3, 1)})
        sup_event("recovered", kind=kind, generation=ev.get("generation"),
                  recovery_ms=recoveries[-1]["recovery_ms"])

    def preempt(workers: List[_Worker], victim: int, sig_name: str
                ) -> float:
        """One preemption, then the world wound down; returns the detect
        timestamp (the send).  TERM gets its grace window: the victim's
        world drains (its peers stop with it, by the collective stop
        flag).  The rest are asked to stop and, past 5 s, killed.  Exit
        codes after a member dies are the preemption's collateral and
        are not policed."""
        nonlocal casualties
        kills[sig_name] += 1
        detect = time.time()
        sup_event("preempt", victim=victim, sig=sig_name)
        workers[victim].signal(getattr(signal, "SIG" + sig_name))
        if sig_name == "TERM":
            deadline = time.monotonic() + grace_s
            while time.monotonic() < deadline:
                drained = not workers[victim].alive() or any(
                    e["event"] in ("drain", "generation_end")
                    for e in list(workers[victim].events))
                if drained:
                    break
                time.sleep(0.05)
        for w in workers:
            w.signal(signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while (time.monotonic() < deadline
               and any(w.alive() for w in workers)):
            time.sleep(0.05)
        for w in workers:
            if w.alive():
                w.proc.kill()
                casualties += 1
                sup_event("hard_casualty", proc=w.idx,
                          reason="still running 5 s after the stop")
        for w in workers:
            w.join(30.0)
        harvest(workers)
        return detect

    # ---- phase 1: the full world, then lose a process --------------------
    gen = 0
    write_topology(tpath, gen, base_devices, 2)
    workers = launch_world(gen, base_devices, 2, 1)
    wait_event(workers, "first_step", gen, world_timeout_s)
    # an epoch stepped (its snapshot taken) and the next begun, read from
    # the world's step lines: it could end before a checkpoint scan and a
    # pause into the next epoch
    wait_step(workers, spe + 1)
    detect = preempt(workers, victim=1, sig_name="TERM")
    cur, _ = _progress(prefix)
    policy.record(("TERM", cur), made_progress=cur > 0)

    # ---- phase 2: shrink onto the survivor's devices ---------------------
    gen = 1
    sup_event("shrink", from_devices=base_devices, from_processes=2,
              num_devices=base_devices // 2, num_processes=1)
    write_topology(tpath, gen, base_devices // 2, 1, ts=detect)
    workers = launch_world(gen, base_devices // 2, 1,
                           local_devices=base_devices)
    ev = wait_event(workers, "first_step", gen, world_timeout_s)
    record_recovery("shrink_world", detect, ev)

    if not smoke:
        wait_progress(_progress(prefix)[0] + spe)
        # ---- phase 3: SIGKILL, no grace; restart at the same size ---------
        time.sleep(0.3)
        detect = preempt(workers, victim=0, sig_name="KILL")
        cur2, _ = _progress(prefix)
        delay, give_up = policy.record(("KILL", cur2),
                                       made_progress=cur2 > cur)
        assert not give_up, "storm made progress — give-up must not fire"
        if delay:
            time.sleep(delay)
        write_topology(tpath, gen, base_devices // 2, 1, ts=detect)
        workers = launch_world(gen, base_devices // 2, 1,
                               local_devices=base_devices)
        ev = wait_event(workers, "first_step", gen, world_timeout_s)
        record_recovery("kill_restart", detect, ev)
        wait_progress(_progress(prefix)[0] + spe)

        # ---- phase 4: graceful TERM; the step-exact interrupt resume ------
        time.sleep(0.3)
        detect = preempt(workers, victim=0, sig_name="TERM")
        cur3, _ = _progress(prefix)
        policy.record(("TERM", cur3), made_progress=True)
        write_topology(tpath, gen, base_devices // 2, 1, ts=detect)
        workers = launch_world(gen, base_devices // 2, 1,
                               local_devices=base_devices)
        ev = wait_event(workers, "first_step", gen, world_timeout_s)
        record_recovery("term_restart", detect, ev)
        wait_progress(_progress(prefix)[0] + spe)

        # ---- phase 5: the live device grow (no relaunch) ------------------
        gen = 2
        detect = time.time()
        sup_event("grow", kind="live", num_devices=base_devices,
                  num_processes=1)
        write_topology(tpath, gen, base_devices, 1, ts=detect)
        workers[0].signal(signal.SIGUSR1)
        ev = wait_event(workers, "first_step", gen, world_timeout_s)
        record_recovery("grow_live", detect, ev)
        wait_progress(_progress(prefix)[0] + spe)

        # ---- phase 6: SIGKILL the grown run, restart it --------------------
        time.sleep(0.3)
        detect = preempt(workers, victim=0, sig_name="KILL")
        write_topology(tpath, gen, base_devices, 1, ts=detect)
        workers = launch_world(gen, base_devices, 1,
                               local_devices=base_devices)
        ev = wait_event(workers, "first_step", gen, world_timeout_s)
        record_recovery("kill_restart_grown", detect, ev)
        wait_progress(_progress(prefix)[0] + spe)

    # ---- final phase: grow the world back and run to completion ----------
    # the smoke grows at the shrunk world's first step (its event, not a
    # checkpoint scan: a large checkpoint commits seconds after its epoch,
    # and the world could end before the directive lands); the drain's
    # step says how many steps were left
    final_gen = 3 if not smoke else 2
    detect = time.time()
    sup_event("grow", kind="world", num_devices=base_devices,
              num_processes=2)
    write_topology(tpath, final_gen, base_devices, 2, ts=detect)
    workers[0].signal(signal.SIGUSR1)
    code = workers[0].join(grace_s)
    if code is None:
        raise RuntimeError("storm: worker did not drain for the world "
                           "grow within the grace window:\n"
                           + workers[0].tail(60))
    if code != EXIT_RESIZE:
        raise RuntimeError(f"storm: expected EXIT_RESIZE={EXIT_RESIZE} "
                           f"drain, got exit {code}:\n{workers[0].tail(60)}")
    harvest(workers)
    drained_at = max(e["step"] for e in workers[0].events
                     if e["event"] == "generation_end")
    sup_event("drain_observed", exit=code, step=drained_at)
    workers = launch_world(final_gen, base_devices, 2, 1)
    ev = wait_event(workers, "first_step", final_gen, world_timeout_s)
    record_recovery("grow_world", detect, ev)
    exit_codes = [w.join(world_timeout_s) for w in workers]
    harvest(workers)
    if any(c != 0 for c in exit_codes):
        tails = "\n---\n".join(w.tail(60) for w in workers)
        raise RuntimeError(
            f"storm: final world did not complete cleanly "
            f"(exits {exit_codes}):\n{tails}")
    final_step, final_ref = _progress(prefix)
    sup_event("complete", step=final_step)

    # ---- verdicts --------------------------------------------------------
    restores = [e for e in all_events if e["event"] == "restore"]
    first_steps = [e for e in all_events if e["event"] == "first_step"]
    gen_ends = [e for e in all_events if e["event"] == "generation_end"]
    # no kernel built after a generation's first step (the steps of an
    # in-process generation: one process emits both events)
    unexpected = []
    for ge in gen_ends:
        if "builds" not in ge:
            continue
        match = [fs for fs in first_steps
                 if fs.get("by") == ge.get("by")
                 and fs.get("generation") == ge.get("generation")]
        if match and ge["builds"] > match[-1].get("builds", 0):
            unexpected.append({"by": ge.get("by"),
                               "generation": ge.get("generation"),
                               "extra": ge["builds"]
                               - match[-1].get("builds", 0)})
    samples = sorted(r["recovery_ms"] for r in recoveries)

    def pct(p):
        if not samples:
            return None
        return samples[min(int(round(p / 100 * (len(samples) - 1))),
                           len(samples) - 1)]

    merged = sorted(timeline + all_events, key=lambda e: e["ts"])
    meshes = [e for e in merged if e["event"] == "mesh"]
    # every checkpoint's steps per epoch: the rescale keeps the schedule
    from mx_rcnn_tpu_torch.ft.integrity import scan_candidates

    manifest_spe = sorted({ref.manifest.get("steps_per_epoch")
                           for ref in scan_candidates(prefix)})
    return {
        "metric": "elastic_storm",
        "measured": True,
        "smoke": smoke,
        "network": network, "dataset": dataset, "device": device,
        "rig": (f"gloo on {rig}, {base_devices} ranks on {cards} card(s)"
                if rig else ("nccl on distinct cards"
                             if device.startswith("cuda") else "gloo on "
                             "the CPU")),
        "base_devices": base_devices,
        "end_epoch": end_epoch, "steps_per_epoch": spe,
        "total_steps": total_steps, "final_step": final_step,
        "completed": final_step >= total_steps,
        "steps_left_at_grow": total_steps - drained_at,
        "worlds_launched": worlds,
        "kills": kills,
        "kills_total": kills["TERM"] + kills["KILL"],
        "peer_casualties": casualties,
        "shrinks": sum(1 for e in merged if e["event"] == "shrink"),
        "grows": sum(1 for e in merged if e["event"] == "grow"),
        "grad_accums": sorted({e["grad_accum"] for e in meshes}),
        "manifest_steps_per_epoch": manifest_spe,
        "restores": len(restores),
        "restores_bit_identical": all(e.get("bit_identical")
                                      for e in restores),
        "unexpected_recompiles": unexpected,
        # nonzero only when MXRCNN_THREAD_SANITIZER armed the children
        "locksan_dirty_workers": locksan_dirty_workers,
        "recovery_ms": {
            "samples": [r["recovery_ms"] for r in recoveries],
            "by_kind": {r["kind"]: r["recovery_ms"] for r in recoveries},
            "p50": pct(50), "p90": pct(90),
            "max": samples[-1] if samples else None,
        },
        "timeline": merged,
    }
