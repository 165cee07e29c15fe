"""Load generator for the serving engine and the serving fleet: closed
or open loop, one JSON record.

Counterpart of ``mx_rcnn_tpu/tools/loadgen.py``.  Replays synthetic
images against an in-process
:class:`~mx_rcnn_tpu_torch.serve.engine.ServingEngine` (no network in the
measured path; the HTTP front end has its own tests) and prints one JSON
line::

    {"metric": "serve_imgs_per_sec", "value": ..., "measured": true,
     "offline_imgs_per_sec": ..., "ratio_vs_offline": ...,
     "p50_ms"/"p90_ms"/"p99_ms": ..., "shed_rate": ..., "lost": 0, ...}

* ``--mode closed``: ``--concurrency`` workers, each with one request in
  flight (submit, wait, repeat): throughput and latency without
  overload.
* ``--mode open``: requests arrive on a fixed ``--qps`` schedule whatever
  the completions; past capacity, deadlines expire and the watermark
  sheds.  The port resizes on the caller's thread (tens of ms a request
  without cv2), so one submitting thread would cap arrivals at its own
  resize rate and quietly close the loop: the schedule's arrivals are
  dealt round-robin to ``2 * batch_size`` submitting threads, each
  keeping its arrivals' times.

The offline rate is the same forward and postprocess in a plain loop, no
queues or threads, at the same bucket and batch size:
``ratio_vs_offline`` is the serving machinery's cost.  ``--check`` makes
the exit code say: nothing lost, something served, ratio at least
``--min_ratio``.

The fleet: ``--fleet N`` runs the same loops through an N-replica
``serve/fleet.py — FleetRouter`` (trace-warm, or from ``--export_dir``);
``--fleet_bench`` / ``--fleet_smoke`` run the fleet protocol and print
one record: an export store; the cold join in fresh processes whose
package copy has an empty ``_build/``, by running the warm-up (builds
K1 and K2) and from the store (builds none); the real model at 1 and 2
export-warmed replicas with the kernel builds after the join (0); the
router's scaling at ``--fleet_sweep`` replicas over a stand-in device
that sleeps ``--stub_ms`` a batch; the shed curve; and one replica
killed mid-burst (0 lost, rerouted, relaunched, rejoined).  With one
card every replica shares it, so real-model scaling measures the
router's overhead, not the silicon; the stub legs measure the router.

The cross-host tier: ``--crosshost_bench`` / ``--crosshost_smoke`` run
``tools/crosshost.py`` (agent processes on loopback: the store pull and
join, the binary against the JSON wire, host scaling, a host killed
under the live scheduler, bulk over 2 hosts), ``--wire_bench`` /
``--wire_smoke`` run ``tools/wire_bench.py`` (the v1-fp32, v2-u8,
coalesced and adaptive arms, bit-equal detections, a host killed mid
envelope); each prints one record, and ``--check`` holds it to the
``--min_crosshost_scaling``, ``--min_wire_ratio``,
``--max_wire_bytes_ratio`` and ``--min_wire_speedup`` gates.  The
agents run on ``--device``.

The record has the JAX package's keys but ``recompiles_after_warmup``
(the port compiles no program, so there is nothing to count), and adds
``preprocess_ms_p50`` (resize and pad of one request on the caller's
thread), ``resize_backend`` (cv2 or numpy) and ``device``.  With
``--set obs__enabled=true`` the run writes a ``runs/<id>/`` record
(``obs/runrec.py — cli_obs``) whose summary is this record's metric;
``MXRCNN_THREAD_SANITIZER`` arms the lock sanitizer before the package
is imported, and ``--check`` fails on what it found.

    python -m mx_rcnn_tpu_torch.tools.loadgen --network resnet101 \\
        --dataset PascalVOC --duration 8                        # card
    python -m mx_rcnn_tpu_torch.tools.loadgen --smoke --device cpu --check
    python -m mx_rcnn_tpu_torch.tools.loadgen --fleet_smoke --device cpu \
        --check
    python -m mx_rcnn_tpu_torch.tools.loadgen --crosshost_smoke \
        --device cpu --check
    python -m mx_rcnn_tpu_torch.tools.loadgen --wire_smoke --device cpu \
        --check
"""

from __future__ import annotations

# the lock sanitizer first: the locks the package allocates at import
# are born wrapped only if it is armed before
from mx_rcnn_tpu_torch.analysis import sanitizer  # isort: skip

sanitizer.maybe_install_from_env()

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mx_rcnn_tpu_torch import kernels  # noqa: E402
from mx_rcnn_tpu_torch.config import (NETWORKS, Config,  # noqa: E402
                                      generate_config, parse_set_overrides)
from mx_rcnn_tpu_torch.core.tester import (Predictor,  # noqa: E402
                                           quant_predictor)
from mx_rcnn_tpu_torch.data.image import RESIZE_BACKEND  # noqa: E402
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model  # noqa: E402
from mx_rcnn_tpu_torch.obs.runrec import cli_obs  # noqa: E402
from mx_rcnn_tpu_torch.serve.engine import ServingEngine  # noqa: E402
from mx_rcnn_tpu_torch.serve.queue import (DeadlineExceeded,  # noqa: E402
                                           RequestFailed, ShedError)
from mx_rcnn_tpu_torch.utils.checkpoint import (load_model,  # noqa: E402
                                                load_state_dict)
from mx_rcnn_tpu_torch.utils.device import resolve_device  # noqa: E402

logger = logging.getLogger("mx_rcnn_tpu_torch")


def synthetic_images(cfg: Config, n: int, seed: int = 0
                     ) -> List[np.ndarray]:
    """``n`` random uint8 RGB images alternating between the bucket
    canvases' sizes, so the traffic uses every bucket."""
    rng = np.random.RandomState(seed)
    buckets = [tuple(b) for b in cfg.bucket.shapes]
    return [rng.randint(0, 256, size=buckets[i % len(buckets)] + (3,),
                        dtype=np.uint8)
            for i in range(n)]


def init_predictor(cfg: Config, prefix: str = None, epoch: int = 0,
                   seed: int = 0, device="cuda") -> Predictor:
    """A predictor on ``device`` (CUDA unless the caller asks for the
    CPU) from checkpoint ``prefix``@``epoch``, else from random weights
    made from ``seed``: serving throughput does not depend on them.  With
    ``cfg.quant.enabled`` it is the quantized predictor (a calibration
    sweep over held-out training batches first, ``quant_predictor``), so
    every serving CLI gains the quant mode through one ``--set``."""
    dev = resolve_device(device)
    if cfg.quant.enabled:
        state = (load_state_dict(prefix, epoch) if prefix else build_model(
            cfg.replace_in("quant", enabled=False), "cpu", seed,
            train=True).state_dict())
        return quant_predictor(cfg, state, dev)
    model = (load_model(cfg, prefix, epoch, dev) if prefix
             else build_model(cfg, dev, seed))
    return Predictor(model, cfg, dev)


def offline_rate(engine: ServingEngine, reps: int = 12) -> float:
    """The bar: full batches of forward and postprocess in a plain loop,
    no serving machinery, buckets alternating as the traffic does."""
    b = engine.cfg.serve.batch_size
    batches = [engine._compose(bucket, []) for bucket in engine.buckets]
    engine._run(*batches[0])  # warm before timing
    t0 = time.perf_counter()
    for i in range(reps):
        engine._run(*batches[i % len(batches)])
    return reps * b / (time.perf_counter() - t0)


def _outcome(fn) -> str:
    try:
        fn()
        return "ok"
    except ShedError:
        return "shed"
    except DeadlineExceeded:
        return "expired"
    except (RequestFailed, TimeoutError):
        return "failed"


def run_closed_loop(engine: ServingEngine, images, duration_s: float,
                    concurrency: int, timeout_ms: float) -> dict:
    """``concurrency`` workers, one request in flight each."""
    stop = time.monotonic() + duration_s
    outcomes = {"ok": 0, "shed": 0, "expired": 0, "failed": 0}
    lock = threading.Lock()

    def worker(wid: int):
        i = wid
        while time.monotonic() < stop:
            img = images[i % len(images)]
            i += concurrency
            key = _outcome(lambda: engine.detect(img, timeout_ms=timeout_ms))
            with lock:
                outcomes[key] += 1

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"wall_s": time.perf_counter() - t0, "client": outcomes}


def run_open_loop(engine: ServingEngine, images, duration_s: float,
                  qps: float, timeout_ms: float) -> dict:
    """Arrival k at ``start + k / qps`` for ``duration_s``, whatever the
    completions; arrivals dealt round-robin to ``2 * batch_size``
    submitting threads (a thread behind its schedule submits at once).
    Every handle is collected, so no outcome is dropped."""
    period = 1.0 / qps
    n = max(int(np.ceil(duration_s * qps)), 1)
    submitters = min(2 * engine.cfg.serve.batch_size, n)
    handles = [None] * n
    start = time.monotonic()

    def submitter(first: int):
        for k in range(first, n, submitters):
            delay = start + k * period - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            handles[k] = engine.submit(images[k % len(images)],
                                       timeout_ms=timeout_ms)

    threads = [threading.Thread(target=submitter, args=(i,), daemon=True)
               for i in range(submitters)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    outcomes = {"ok": 0, "shed": 0, "expired": 0, "failed": 0}
    for h in handles:
        outcomes[_outcome(lambda: h.wait(timeout=30.0))] += 1
    return {"wall_s": time.perf_counter() - t0, "client": outcomes,
            "submitted": n}


def make_stub_run_fn(cfg: Config, model_ms: float, seed: int = 0):
    """A stand-in for the device: sleeps ``model_ms`` per batch (the GIL
    released, as a host thread waiting on the card is) and returns
    canned postprocess-shaped outputs, so everything around the model
    (preprocess, queues, batching, demultiplex, accounting) runs for
    real at a rate that does not depend on this machine."""
    n = cfg.serve.batch_size
    r = cfg.test.rpn_post_nms_top_n
    c = cfg.num_classes
    rng = np.random.RandomState(seed)
    boxes = (rng.rand(n, r, 4 * c) * 100.0).astype(np.float32)
    scores = rng.rand(n, r, c).astype(np.float32)
    keep = np.zeros((n, c, r), bool)
    keep[:, 1:, :3] = True  # a few detections per class: real demux work

    def run_fn(images, im_info):
        time.sleep(model_ms / 1000.0)
        return boxes, scores, keep

    return run_fn


def make_content_stub_run_fn(cfg: Config, model_ms: float = 0.0):
    """A stand-in device whose every output row is a function of that
    row's pixels alone: an image scores the same in any batch and on any
    replica, and two images score differently, so byte-equal bulk sinks
    mean the same images in the same slots (the JAX package's stub)."""
    r = cfg.test.rpn_post_nms_top_n
    c = cfg.num_classes

    def run_fn(images, im_info):
        if model_ms:
            time.sleep(model_ms / 1000.0)
        n = images.shape[0]
        boxes = np.zeros((n, r, 4 * c), np.float32)
        scores = np.zeros((n, r, c), np.float32)
        keep = np.zeros((n, c, r), bool)
        for j in range(n):
            m = np.float32(np.abs(images[j]).sum())
            x = np.float32(m % np.float32(37.0))
            boxes[j, 0, 4:8] = [x, x + 1.0, x + 5.0, x + 7.0]
            scores[j, 0, 1] = np.float32(0.5) + x / np.float32(100.0)
            keep[j, 1, 0] = True
        return boxes, scores, keep

    return run_fn


# ---- the fleet ----------------------------------------------------------------


class KernelBuildCounter:
    """The kernel libraries built inside a ``with`` block
    (``kernels.load_events()``), the port's stand-in for the JAX
    package's ``LoweringCounter``: a steady state after a join builds
    none."""

    def __enter__(self) -> "KernelBuildCounter":
        self._start = kernels.load_events()["builds"]
        self.n = 0
        return self

    def __exit__(self, *exc) -> bool:
        self.n = kernels.load_events()["builds"] - self._start
        return False


def _build_fleet(cfg: Config, replicas: int, variables, *,
                 export_root: str = None, stub_ms: float = None,
                 record=None, device="cuda"):
    from mx_rcnn_tpu_torch.serve.fleet import build_fleet

    fcfg = cfg.replace_in("fleet", replicas=replicas)
    factory = (None if stub_ms is None
               else (lambda rid: make_stub_run_fn(fcfg, stub_ms)))
    return build_fleet(fcfg, None if factory else variables,
                       export_root=export_root, run_fn_factory=factory,
                       record=record, device=device)


def _drain(target, timeout_s: float = 30.0) -> None:
    """Wait until every admitted request of ``target`` is terminal."""
    deadline = time.monotonic() + timeout_s
    while (target.metrics.snapshot()["in_flight"] > 0
           and time.monotonic() < deadline):
        time.sleep(0.05)


def _fleet_leg_record(run: dict, snap: dict) -> dict:
    c = snap["counters"]
    return {
        "imgs_per_sec": round(c["served"] / run["wall_s"], 2),
        "duration_s": round(run["wall_s"], 2),
        "p50_ms": snap["total_ms"]["p50"],
        "p99_ms": snap["total_ms"]["p99"],
        "served": c["served"], "shed": c["shed"],
        "expired": c["expired"], "failed": c["failed"],
        "submitted": c["submitted"],
        "shed_rate": round(c["shed"] / max(c["submitted"], 1), 4),
        "lost": c["submitted"] - snap["terminated"],
    }


def fresh_package(root: str) -> Path:
    """A copy of this package under ``root`` with an empty ``_build/``
    (and no bytecode): a process that imports it from there builds or
    installs every kernel library it uses."""
    src = Path(kernels.__file__).resolve().parent
    dst = Path(root) / src.name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    (dst / "_build").mkdir()
    return Path(root)


def _run_join_bench(mode: str, network: str, dataset: str,
                    overrides: dict, export_dir: str = None,
                    timeout_s: float = 900.0, device: str = "cuda",
                    workdir: str = None) -> dict:
    """One cold join in a fresh process, over a copy of the package whose
    ``_build/`` is empty (``fresh_package``): ``trace`` runs the warm-up
    and builds the kernels it launches, ``export`` joins from the store
    and builds none."""
    root = fresh_package(os.path.join(
        workdir or tempfile.mkdtemp(prefix="join_"), f"join_{mode}"))
    cmd = [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.fleet",
           "join_bench", "--mode", mode, "--network", network,
           "--dataset", dataset, "--device", device]
    for k, v in overrides.items():
        cmd += ["--set", f"{k}={v!r}" if isinstance(v, str) else
                f"{k}={v}"]
    if export_dir:
        cmd += ["--export_dir", os.path.abspath(export_dir)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout_s, env=env, cwd=str(root))
    if out.returncode != 0:
        raise RuntimeError(f"join_bench {mode} failed rc={out.returncode}:"
                           f"\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    last = [ln for ln in out.stdout.strip().splitlines()
            if ln.startswith("{")][-1]
    doc = json.loads(last)
    if Path(doc["package"]).resolve() != (root / "mx_rcnn_tpu_torch"
                                          ).resolve():
        raise RuntimeError(f"join_bench {mode} imported {doc['package']}, "
                           f"not the fresh copy under {root}")
    return doc


def _kill_mid_burst_leg(cfg: Config, variables, export_root: str,
                        duration_s: float, timeout_ms: float, images, *,
                        device="cuda", watch=None) -> dict:
    """A 2-replica export-warmed fleet under a closed-loop burst,
    replica 0 killed a third of the way in: 0 lost fleet-wide, its
    stranded work rerouted, the replica relaunched and rejoined.
    ``watch(router, phase)``, when given, runs at ``"killed"`` (right
    after the kill) and ``"rejoined"``, and its returns go into the
    record under ``watch``."""
    kcfg = cfg.replace_in("fleet", health_interval_s=0.2)
    router = _build_fleet(kcfg, 2, variables, export_root=export_root,
                          device=device)
    watched = {}
    try:
        concurrency = 2 * cfg.serve.batch_size * 2
        stop = time.monotonic() + duration_s
        kill_at = time.monotonic() + duration_s / 3.0
        outcomes = {"ok": 0, "shed": 0, "expired": 0, "failed": 0}
        lock = threading.Lock()

        def worker(wid: int):
            i = wid
            while time.monotonic() < stop:
                img = images[i % len(images)]
                key = _outcome(lambda: router.detect(img,
                                                     timeout_ms=timeout_ms))
                i += concurrency
                with lock:
                    outcomes[key] += 1

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(concurrency)]
        for t in threads:
            t.start()
        while time.monotonic() < kill_at:
            time.sleep(0.02)
        victim = router.manager.replicas[0]
        served_before_kill = router.metrics.snapshot()["counters"]["served"]
        victim.engine.kill()
        kill_t = time.monotonic()
        if watch is not None:
            watched["killed"] = watch(router, "killed")
        for t in threads:
            t.join()
        _drain(router)
        # the relaunch rejoins about one health tick plus a join later
        rejoin_s = None
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if victim.ready() and victim.generation >= 2:
                # from the replica's own ready transition
                rejoin_s = round(victim.joins[-1]["ready_t"] - kill_t, 2)
                break
            time.sleep(0.05)
        if watch is not None:
            watched["rejoined"] = watch(router, "rejoined")
        snap = router.metrics.snapshot()
        c = snap["counters"]
        rec = {
            "submitted": c["submitted"], "served": c["served"],
            "shed": c["shed"], "expired": c["expired"],
            "failed": c["failed"],
            "lost": c["submitted"] - snap["terminated"],
            "served_after_kill": c["served"] - served_before_kill,
            "rerouted": router.rerouted(),
            "ejects": router.manager.ejects,
            "relaunched": victim.generation >= 2,
            "rejoin_s": rejoin_s,
            "rejoin": victim.joins[-1] if victim.generation >= 2 else None,
            "client_outcomes": outcomes,
        }
        if watch is not None:
            rec["watch"] = watched
        return rec
    finally:
        router.close()


def run_fleet_bench(args) -> int:
    """The fleet protocol (module docstring): one record, and under
    ``--check`` its invariants as the exit code."""
    from mx_rcnn_tpu_torch.serve.export import (export_serve_programs,
                                                predictor_variables)

    smoke = args.fleet_smoke
    overrides = dict(_smoke_overrides()) if smoke else {}
    overrides.update(parse_set_overrides(args.set))
    cfg = generate_config(args.network, args.dataset, **overrides)
    workdir = args.workdir or tempfile.mkdtemp(prefix="fleet_bench_")
    os.makedirs(workdir, exist_ok=True)
    store_root = os.path.join(workdir, "store")
    # None: a bounded 20 s for the bench; an explicit 0 keeps no deadline
    timeout_ms = 20_000.0 if args.timeout_ms is None else args.timeout_ms
    dur = min(args.duration, 6.0) if smoke else args.duration
    rec: dict = {
        "metric": "fleet_scaling_x_at_2_replicas",
        "unit": "x",
        "measured": True,
        "smoke": smoke,
        "network": args.network,
        "bucket_shapes": [list(b) for b in cfg.bucket.shapes],
        "batch_size": cfg.serve.batch_size,
        "host": {"physical_cores": os.cpu_count()},
        "device": args.device,
    }
    problems: List[str] = []

    # 1. the export store, every program held to a second run's bits
    logger.info("[fleet] exporting serving programs -> %s", store_root)
    predictor = init_predictor(cfg, args.prefix, args.epoch, args.seed,
                               args.device)
    t0 = time.perf_counter()
    report = export_serve_programs(predictor, cfg, store_root,
                                   bundle_variables=True)
    rec["export"] = {"bit_equal": report["bit_equal"],
                     "programs": len(report["programs"]),
                     "kernels": report["kernels"],
                     "bytes": report["bytes"],
                     "export_s": round(time.perf_counter() - t0, 2)}
    if not report["bit_equal"]:
        problems.append("exported programs not bit-equal to a second run")

    # 2. the cold join, by running against from the store, each in a
    # fresh process over a package copy with an empty _build/
    join_net = args.join_network if not smoke else args.network
    join_overrides = dict(overrides)
    join_store = store_root
    if join_net != args.network:
        join_overrides = {"serve__batch_size": cfg.serve.batch_size}
        join_store = os.path.join(workdir, f"store_{join_net}")
        logger.info("[fleet] exporting the %s join store -> %s", join_net,
                    join_store)
        cmd = [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.fleet",
               "export", "--network", join_net, "--dataset", args.dataset,
               "--device", args.device, "--out", join_store]
        for k, v in join_overrides.items():
            cmd += ["--set", f"{k}={v}"]
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=1800)
        if out.returncode != 0:
            raise RuntimeError(f"join-store export failed:\n"
                               f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    joins = {}
    for mode in ("trace", "export"):
        logger.info("[fleet] cold join, %s-warm, in a fresh process ...",
                    mode)
        joins[mode] = _run_join_bench(
            mode, join_net, args.dataset, join_overrides,
            export_dir=join_store if mode == "export" else None,
            device=args.device, workdir=workdir)
    trace_join, export_join = joins["trace"], joins["export"]
    # overhead_s = the first warm-up less a second one, bucket by bucket,
    # plus the store's load: what the join pays beyond running the model
    ratio = (export_join["overhead_s"] / trace_join["overhead_s"]
             if trace_join.get("overhead_s") else None)
    rec["cold_join"] = {
        "network": join_net,
        **{f"{m}_{k}": joins[m][k] for m in ("trace", "export")
           for k in ("warm_s", "exec_s", "overhead_s", "total_s",
                     "kernel_builds")},
        "ratio": round(ratio, 4) if ratio is not None else None,
        "note": "overhead_s = warm_s - exec_s: the kernel builds and first "
                "calls (trace) or the store's checks and library installs "
                "(export); exec_s is a second warm-up, the model alone; "
                "total_s adds the model's build",
    }
    if not export_join["kernel_builds"] == 0:
        problems.append(f"the export-warm join built "
                        f"{export_join['kernel_builds']} kernel(s)")
    if trace_join["kernel_builds"]:
        if ratio is None or ratio > args.max_join_ratio:
            problems.append(f"export-warm/trace-warm join-overhead ratio "
                            f"{ratio} > {args.max_join_ratio}")
    else:
        # on the CPU no kernel is built either way: both overheads are a
        # first call's noise, and their ratio judges nothing
        rec["cold_join"]["ratio_gate"] = "skipped: the trace join built " \
                                         "no kernel"

    variables = predictor_variables(predictor)
    del predictor
    images = synthetic_images(cfg, args.images, args.seed)

    # 3. the real model at 1 and 2 export-warmed replicas: no kernel
    # built after the join
    real: dict = {}
    for n_rep in ([1, 2] if not smoke else [2]):
        router = _build_fleet(cfg, n_rep, variables, export_root=store_root,
                              device=args.device)
        try:
            with KernelBuildCounter() as kb:
                run = run_closed_loop(
                    router, images, dur,
                    concurrency=4 * cfg.serve.batch_size * n_rep,
                    timeout_ms=timeout_ms)
                _drain(router)
            leg = _fleet_leg_record(run, router.metrics.snapshot())
            leg["kernel_builds_after_join"] = kb.n
            real[str(n_rep)] = leg
            if leg["lost"]:
                problems.append(f"real {n_rep}-replica leg lost "
                                f"{leg['lost']} requests")
            if kb.n:
                problems.append(f"real {n_rep}-replica leg built {kb.n} "
                                "kernel(s) after the join")
        finally:
            router.close()
    if "1" in real and "2" in real and real["1"]["imgs_per_sec"]:
        real["scaling_2r"] = round(real["2"]["imgs_per_sec"]
                                   / real["1"]["imgs_per_sec"], 3)
    real["note"] = ("every replica shares this machine's device(s) and "
                    f"{os.cpu_count()} CPU core(s): real-model scaling "
                    "here is the fleet's overhead, not more silicon; the "
                    "stub legs measure the router")
    rec["real_model"] = real

    # 4. the router's scaling over the stand-in device
    stub: dict = {"mode": "stub-device-compute",
                  "stub_model_ms": args.stub_ms,
                  "note": "a batch's device time is a sleep that releases "
                          "the GIL, so replicas run concurrently as cards "
                          "would; the rest (preprocess, routing, queues, "
                          "batching, demux, accounting) is the real path"}
    sweep = [int(x) for x in args.fleet_sweep.split(",")]
    thr: dict = {}
    for n_rep in sweep:
        router = _build_fleet(cfg, n_rep, None, stub_ms=args.stub_ms,
                              device=args.device)
        try:
            # 4x batch per replica keeps every lane a spare batch deep
            run = run_closed_loop(
                router, images, dur,
                concurrency=4 * cfg.serve.batch_size * n_rep,
                timeout_ms=timeout_ms)
            _drain(router)
            leg = _fleet_leg_record(run, router.metrics.snapshot())
            thr[str(n_rep)] = leg
            if leg["lost"]:
                problems.append(f"stub {n_rep}-replica leg lost "
                                f"{leg['lost']} requests")
        finally:
            router.close()
    stub["replicas"] = thr
    base = thr[str(sweep[0])]["imgs_per_sec"]
    for n_rep in sweep[1:]:
        if base:
            stub[f"scaling_{n_rep}r"] = round(
                thr[str(n_rep)]["imgs_per_sec"] / base, 3)
    rec["router_scaling"] = stub
    scalings = [k for k in stub if k.startswith("scaling_")]
    rec["value"] = stub.get("scaling_2r") or (
        stub[scalings[0]] if scalings else None)
    if "scaling_2r" in stub:
        if stub["scaling_2r"] < args.min_scaling:
            problems.append(f"router scaling at 2 replicas "
                            f"{stub['scaling_2r']} < {args.min_scaling}")
    else:
        logger.warning("--fleet_sweep %s has no 1->2 pair: the "
                       "min-scaling gate is skipped", args.fleet_sweep)

    # 5. the shed curve: an open loop over a 2-replica stub fleet; each
    # bucket's dispatcher runs its own batches
    capacity = (2 * len(cfg.bucket.shapes) * cfg.serve.batch_size
                / (args.stub_ms / 1000.0))
    curve = []
    for factor in ([0.6, 2.5] if smoke else [0.6, 1.0, 1.5, 2.5]):
        router = _build_fleet(cfg, 2, None, stub_ms=args.stub_ms,
                              device=args.device)
        try:
            run = run_open_loop(router, images, max(dur / 2, 2.0),
                                qps=capacity * factor,
                                timeout_ms=timeout_ms)
            _drain(router)
            leg = _fleet_leg_record(run, router.metrics.snapshot())
            curve.append({"qps_target": round(capacity * factor, 1),
                          "load_factor": factor, **leg})
            if leg["lost"]:
                problems.append(f"shed-curve leg x{factor} lost "
                                f"{leg['lost']} requests")
        finally:
            router.close()
    rec["shed_curve"] = {"stub_capacity_imgs_per_sec": round(capacity, 1),
                         "legs": curve}
    over = [leg for leg in curve if leg["load_factor"] > 1.0]
    if over and all(leg["shed_rate"] == 0 for leg in over):
        problems.append("overdriven legs shed nothing: the watermark "
                        "does not compose at the fleet")

    # 6. one replica killed mid-burst
    logger.info("[fleet] kill-mid-burst leg ...")
    kill = _kill_mid_burst_leg(cfg, variables, store_root,
                               duration_s=max(dur, 4.0),
                               timeout_ms=timeout_ms, images=images,
                               device=args.device)
    rec["kill_mid_burst"] = kill
    if kill["lost"]:
        problems.append(f"kill leg lost {kill['lost']} requests")
    if not kill["relaunched"]:
        problems.append("the killed replica did not relaunch and rejoin")
    if kill["served_after_kill"] <= 0:
        problems.append("no requests served after the kill")

    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    if args.check:
        problems += sanitizer.check_problems()
        for msg in problems:
            logger.error("CHECK FAILED: %s", msg)
        return 1 if problems else 0
    return 0


def _smoke_overrides() -> dict:
    """The smoke canvas: the tiny network on 128x160 buckets with the
    eval's ROI counts cut, so a run takes seconds on a CPU."""
    return {
        "bucket__scale": 128, "bucket__max_size": 160,
        "bucket__shapes": ((128, 160), (160, 128)),
        "test__rpn_pre_nms_top_n": 512, "test__rpn_post_nms_top_n": 64,
        "serve__batch_size": 2, "serve__max_delay_ms": 20.0,
    }


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--network", default="tiny", choices=NETWORKS)
    p.add_argument("--dataset", default="synthetic",
                   choices=["PascalVOC", "coco", "synthetic",
                            "synthetic_hard"])
    p.add_argument("--prefix", default=None,
                   help="checkpoint prefix (default: random weights)")
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--mode", default="closed", choices=["closed", "open"])
    p.add_argument("--duration", type=float, default=20.0,
                   help="measurement window, seconds")
    p.add_argument("--concurrency", type=int, default=None,
                   help="closed-loop workers (default 2 x batch_size)")
    p.add_argument("--qps", type=float, default=20.0,
                   help="open-loop arrival rate")
    p.add_argument("--timeout_ms", type=float, default=None,
                   help="per-request deadline (default "
                        "serve.default_timeout_ms)")
    p.add_argument("--images", type=int, default=16,
                   help="distinct synthetic images to cycle through")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="also write the JSON record to this path")
    p.add_argument("--check", action="store_true",
                   help="exit 1 unless nothing is lost, something is "
                        "served and ratio_vs_offline >= --min_ratio")
    p.add_argument("--min_ratio", type=float, default=0.5)
    p.add_argument("--smoke", action="store_true",
                   help="tiny network on 128x160 buckets, at most 12 s")
    # the fleet (serve/fleet.py)
    p.add_argument("--fleet", type=int, default=0,
                   help="run the loop through an N-replica FleetRouter "
                        "instead of one engine")
    p.add_argument("--export_dir", default=None,
                   help="--fleet: join the replicas from this export "
                        "store (default: by running the warm-up)")
    p.add_argument("--fleet_bench", action="store_true",
                   help="the fleet protocol (cold join, real model, "
                        "router scaling, shed curve, kill mid-burst): "
                        "one record")
    p.add_argument("--fleet_smoke", action="store_true",
                   help="--fleet_bench at the smoke canvas, short windows "
                        "and a lenient join ratio")
    p.add_argument("--fleet_sweep", default="1,2,4",
                   help="replica counts of the router-scaling legs")
    p.add_argument("--stub_ms", type=float, default=150.0,
                   help="the stand-in device's ms a batch in the "
                        "router-scaling legs (a sleep that releases the "
                        "GIL), sized so that it dominates the host's "
                        "work a request")
    p.add_argument("--join_network", default="resnet50",
                   help="backbone of the full bench's cold-join legs (the "
                        "smoke keeps --network)")
    p.add_argument("--max_join_ratio", type=float, default=None,
                   help="--check ceiling of the export-warm over the "
                        "trace-warm join overhead (default 0.10 bench, "
                        "0.50 smoke); judged when the trace join built "
                        "a kernel")
    p.add_argument("--min_scaling", type=float, default=1.8,
                   help="--check floor of the router legs' scaling at 2 "
                        "replicas")
    p.add_argument("--workdir", default=None,
                   help="the fleet bench's directory (stores, package "
                        "copies; default: a new temporary one)")
    # the cross-host tier (tools/crosshost.py, tools/wire_bench.py)
    p.add_argument("--crosshost_bench", action="store_true",
                   help="the cross-host battery (agent processes, the "
                        "binary wire, the store pull, the live "
                        "scheduler): one record")
    p.add_argument("--crosshost_smoke", action="store_true",
                   help="--crosshost_bench at gate scale (2 hosts, short "
                        "bursts)")
    p.add_argument("--crosshost_sweep", default="1,2,4",
                   help="host counts of the cross-host scaling legs")
    p.add_argument("--min_wire_ratio", type=float, default=1.05,
                   help="--check floor of the binary over the JSON "
                        "prepared wire's throughput")
    p.add_argument("--min_crosshost_scaling", type=float, default=1.9,
                   help="--check floor of the 2-host stand-in scaling "
                        "(4 hosts: twice this)")
    p.add_argument("--wire_bench", action="store_true",
                   help="the wire data-plane battery (v1-fp32, v2-u8, "
                        "coalesced and adaptive arms, SIGKILL mid "
                        "envelope): one record")
    p.add_argument("--wire_smoke", action="store_true",
                   help="--wire_bench at gate scale (short windows, the "
                        "same arms and kill leg)")
    p.add_argument("--max_wire_bytes_ratio", type=float, default=0.30,
                   help="--check ceiling of v2-u8 over v1-fp32 bytes an "
                        "image (the counters and the production bucket's "
                        "codec arithmetic)")
    p.add_argument("--min_wire_speedup", type=float, default=1.8,
                   help="--check floor of the coalesced over the v1 "
                        "arm's throughput")
    p.add_argument("--set", action="append", metavar="SEC__FIELD=VAL",
                   help="override a config field (repeatable)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = parse_args(argv)
    if args.wire_bench or args.wire_smoke:
        from mx_rcnn_tpu_torch.tools.wire_bench import run_wire_bench

        return run_wire_bench(args)
    if args.crosshost_bench or args.crosshost_smoke:
        from mx_rcnn_tpu_torch.tools.crosshost import run_crosshost_bench

        return run_crosshost_bench(args)
    if args.fleet_bench or args.fleet_smoke:
        if args.max_join_ratio is None:
            args.max_join_ratio = 0.5 if args.fleet_smoke else 0.10
        if args.fleet_smoke and args.fleet_sweep == "1,2,4":
            args.fleet_sweep = "1,2"
        return run_fleet_bench(args)
    overrides = {}
    if args.smoke:
        overrides.update(_smoke_overrides())
        args.duration = min(args.duration, 12.0)
    overrides.update(parse_set_overrides(args.set))
    cfg = generate_config(args.network, args.dataset, **overrides)
    concurrency = args.concurrency or 2 * cfg.serve.batch_size
    timeout_ms = (cfg.serve.default_timeout_ms if args.timeout_ms is None
                  else args.timeout_ms)

    obs_sess = cli_obs(cfg, "loadgen")
    rec = None
    try:
        rec = _run(args, cfg, concurrency, timeout_ms,
                   record=obs_sess.record if obs_sess else None)
    finally:
        if obs_sess is not None:
            obs_sess.close(metric="serve_imgs_per_sec",
                           value=None if rec is None else rec["value"],
                           unit="imgs/s")
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    if args.check:
        problems = []
        if rec["lost"] != 0:
            problems.append(f"{rec['lost']} requests lost (no terminal "
                            f"state)")
        if rec["ratio_vs_offline"] is not None \
                and rec["ratio_vs_offline"] < args.min_ratio:
            problems.append(f"serving/offline ratio "
                            f"{rec['ratio_vs_offline']} < {args.min_ratio}")
        if rec["served"] == 0:
            problems.append("zero requests served")
        problems += sanitizer.check_problems()
        for msg in problems:
            logger.error("CHECK FAILED: %s", msg)
        return 1 if problems else 0
    return 0


def _run(args, cfg: Config, concurrency: int, timeout_ms: float,
         record=None) -> dict:
    """Warm-up, the offline rate, the measured loop and its drain: the
    record."""
    predictor = init_predictor(cfg, args.prefix, args.epoch, args.seed,
                               args.device)
    dev = predictor.device
    images = synthetic_images(cfg, args.images, args.seed)
    pre = None
    if args.fleet:
        from mx_rcnn_tpu_torch.serve.export import predictor_variables

        logger.info("building a %d-replica fleet (%s) ...", args.fleet,
                    f"export-warm from {args.export_dir}"
                    if args.export_dir else "trace-warm")
        variables = predictor_variables(predictor)
        del predictor
        engine = _build_fleet(cfg, args.fleet, variables,
                              export_root=args.export_dir,
                              record=record, device=args.device)
        off = None  # the offline rate is one engine's
    else:
        engine = ServingEngine(predictor, cfg)
        t0 = time.perf_counter()
        engine.warmup()
        logger.info("warmup: %d bucket(s) at batch %d in %.1f s",
                    len(engine.buckets), cfg.serve.batch_size,
                    time.perf_counter() - t0)
        off = offline_rate(engine)
        logger.info("offline: %.2f imgs/s at batch %d", off,
                    cfg.serve.batch_size)

    engine.metrics.reset()   # the measured window excludes the warm-up
    logger.info("load: mode=%s duration=%.0fs %s", args.mode, args.duration,
                f"concurrency={concurrency}" if args.mode == "closed"
                else f"qps={args.qps}")
    if args.mode == "closed":
        run = run_closed_loop(engine, images, args.duration, concurrency,
                              timeout_ms)
    else:
        run = run_open_loop(engine, images, args.duration, args.qps,
                            timeout_ms)
    # drain: every submitted request must reach a terminal state
    deadline = time.monotonic() + 30.0
    while (engine.metrics.snapshot()["in_flight"] > 0
           and time.monotonic() < deadline):
        time.sleep(0.05)
    snap = engine.metrics.snapshot()
    if not args.fleet:
        pre = engine.metrics.summary("preprocess_ms")["p50"]
    engine.close()

    c = snap["counters"]
    lost = c["submitted"] - snap["terminated"]
    served_rate = c["served"] / run["wall_s"]
    rec = {
        "metric": "serve_imgs_per_sec",
        "value": round(served_rate, 2),
        "unit": "imgs/s",
        "measured": True,
        "mode": args.mode,
        "network": args.network,
        "bucket_shapes": [list(b) for b in cfg.bucket.shapes],
        "batch_size": cfg.serve.batch_size,
        "max_delay_ms": cfg.serve.max_delay_ms,
        "duration_s": round(run["wall_s"], 2),
        "concurrency": concurrency if args.mode == "closed" else None,
        "qps_target": args.qps if args.mode == "open" else None,
        "fleet_replicas": args.fleet or None,
        "offline_imgs_per_sec": round(off, 2) if off else None,
        "ratio_vs_offline": round(served_rate / off, 3) if off else None,
        "p50_ms": snap["total_ms"]["p50"],
        "p90_ms": snap["total_ms"]["p90"],
        "p99_ms": snap["total_ms"]["p99"],
        "queue_wait_p99_ms": snap["queue_wait_ms"]["p99"],
        "model_ms_p50": snap["model_ms"]["p50"],
        "batch_occupancy_mean": snap["batch_occupancy"]["mean_rows"],
        "served": c["served"], "shed": c["shed"],
        "expired": c["expired"], "failed": c["failed"],
        "submitted": c["submitted"],
        "shed_rate": round(c["shed"] / max(c["submitted"], 1), 4),
        "expired_rate": round(c["expired"] / max(c["submitted"], 1), 4),
        "lost": lost,
        "client_outcomes": run["client"],
        "preprocess_ms_p50": pre,
        "resize_backend": RESIZE_BACKEND,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    return rec


if __name__ == "__main__":
    raise SystemExit(main())
