"""The observability plane end to end: an observed training run and a
serving burst in one process, with ``--check``.

Counterpart of ``mx_rcnn_tpu/tools/obs_smoke.py``, at its ``_TINY``
recipe: two epochs of the tiny network on synthetic images with
``cfg.obs`` on (spans, the profiler window at global step 3 for 2
steps, the time-series sampler), then a serving burst over the trained
checkpoint whose ``ServeMetrics`` record into the same process
registry.  The checks:

* one real-HTTP ``/metrics`` scrape (the stdlib exporter) shows
  ``train.*``, ``loader.*``, ``snapshot.*`` and ``serve.*`` together,
  with the ``timeseries`` section of the active store;
* ``runs/<id>/events.jsonl`` parses line by line, in the ``{ts, event}``
  schema, and holds the expected event kinds;
* the profiler window's rollup (``obs/profiler.py — rollup``) is not
  empty;
* host spans and the window's device events merge into one chrome
  trace;
* no kernel library is built or loaded in the final epoch
  (``kernels.py — load_events``; the JAX smoke's "zero new lowerings").

``--check`` makes the exit code say.  ``--overhead_out`` also measures
ms/step with the plane on (spans, registry, sampler, health rules)
against off, one epoch each in turns (off, on, off, on), and writes the
record there.  It runs on the card unless ``--device cpu``.

    python -m mx_rcnn_tpu_torch.tools.obs_smoke --device cpu --check
    python -m mx_rcnn_tpu_torch.tools.obs_smoke --check      # the card
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import statistics
import tempfile
import time
import urllib.request
from typing import Callable, Dict, List

from mx_rcnn_tpu_torch.netio import read_limited

logger = logging.getLogger("mx_rcnn_tpu_torch")

# the JAX smoke's recipe: the tiny network, 128x160 buckets, serving
# shrunk as tools/loadgen.py --smoke shrinks it
_TINY = {
    "train__rpn_pre_nms_top_n": 1024, "train__rpn_post_nms_top_n": 300,
    "train__max_gt_boxes": 8, "train__flip": False,
    "test__rpn_pre_nms_top_n": 512, "test__rpn_post_nms_top_n": 64,
    "bucket__scale": 128, "bucket__max_size": 160,
    "bucket__shapes": ((128, 160), (160, 128)),
    "serve__batch_size": 2, "serve__max_delay_ms": 20.0,
    "default__frequent": 2,
}

# the metrics one scrape must show
SCRAPE_NAMES = ("train.steps", "train.step_ms", "train.data_wait_ms",
                "train.samples_per_sec", "loader.decode_ms",
                "loader.assemble_ms", "loader.queue_depth",
                "snapshot.commits", "snapshot.stall_ms", "snapshot.commit_ms",
                "serve.submitted", "serve.served", "serve.model_ms")

EVENT_KINDS = ("run_start", "epoch_start", "log", "epoch_end", "snapshot",
               "run_finish")


def _cfg(workdir: str, **obs_kw):
    from mx_rcnn_tpu_torch.config import generate_config

    over = dict(_TINY)
    over["dataset__root_path"] = os.path.join(workdir, "data")
    over.update({f"obs__{k}": v for k, v in obs_kw.items()})
    return generate_config("tiny", "synthetic", **over)


def _scrape(port: int) -> dict:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
        return json.loads(read_limited(resp))


def run_smoke(workdir: str, num_images: int, epochs: int,
              device: str = "cuda") -> dict:
    """The observed run and the serve burst; returns the evidence the
    checks read."""
    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.obs import timeseries as obs_ts
    from mx_rcnn_tpu_torch.obs import trace as obs_trace
    from mx_rcnn_tpu_torch.obs.metrics import (ServeMetrics, registry,
                                               start_metrics_server)
    from mx_rcnn_tpu_torch.obs.runrec import RunRecord
    from mx_rcnn_tpu_torch.serve.engine import ServingEngine
    from mx_rcnn_tpu_torch.tools.loadgen import (init_predictor,
                                                 synthetic_images)
    from mx_rcnn_tpu_torch.tools.train import train_net

    cfg = _cfg(workdir, enabled=True, trace=True, profile_at_step=3,
               profile_steps=2, run_dir=os.path.join(workdir, "runs"),
               timeseries=True, sample_interval_s=0.25)
    registry().reset()
    obs_trace.enable(cfg.obs.trace_cap)
    obs_trace.reset()
    run_rec = RunRecord("train", base_dir=cfg.obs.run_dir)
    # the kernel libraries built and loaded by each epoch's start and end
    loads: List[dict] = []
    run_rec.add_listener(lambda e: loads.append(
        {"event": e["event"], **kernels.load_events()})
        if e["event"] in ("epoch_start", "epoch_end") else None)
    srv = start_metrics_server(port=0)
    port = srv.server_address[1]
    store = obs_ts.TimeSeriesStore(cfg.obs.ts_capacity)
    obs_ts.set_active(store)
    sampler = obs_ts.Sampler(store, interval_s=cfg.obs.sample_interval_s)
    sampler.start()
    prefix = os.path.join(workdir, "model", "e2e")
    profile_dir = os.path.join(run_rec.dir, "profile")
    try:
        train_net(cfg, prefix=prefix, end_epoch=epochs, seed=0,
                  synthetic=num_images, device=device, run_record=run_rec,
                  log=lambda line: None)
        # a serving burst over the trained weights, into the same registry
        engine = ServingEngine(
            init_predictor(cfg, prefix, epochs, device=device), cfg,
            metrics=ServeMetrics(registry=registry()))
        try:
            engine.warmup()
            for img in synthetic_images(cfg, 4):
                engine.detect(img, timeout_ms=0)
        finally:
            engine.close()
        scrape = _scrape(port)
        trace_path = obs_trace.merge_device_trace(
            os.path.join(run_rec.dir, "trace.json"), profile_dir)
        run_rec.finish(metric="obs_smoke_steps",
                       value=registry().counter("train.steps"), unit="steps")
    finally:
        sampler.stop(final_sample=True)
        obs_ts.set_active(None)
        run_rec.close()
        srv.shutdown()
        srv.server_close()
        obs_trace.disable()

    rollup = {}
    rollup_path = os.path.join(profile_dir, "rollup.json")
    if os.path.exists(rollup_path):
        with open(rollup_path) as f:
            rollup = json.load(f)
    with open(run_rec.events_path) as f:
        events = [json.loads(line) for line in f if line.strip()]
    with open(trace_path) as f:
        trace = json.load(f)
    return {"scrape": scrape, "events": events,
            "events_path": run_rec.events_path, "rollup": rollup,
            "trace_events": trace.get("traceEvents", []),
            "final_epoch_loads": _final_epoch_loads(loads),
            "run_dir": run_rec.dir}


def _final_epoch_loads(marks: List[dict]) -> Dict[str, int]:
    """Libraries built and loaded between the last epoch's start and
    end marks (None when the run had no epoch)."""
    starts = [m for m in marks if m["event"] == "epoch_start"]
    ends = [m for m in marks if m["event"] == "epoch_end"]
    if not starts or not ends:
        return None
    return {k: ends[-1][k] - starts[-1][k] for k in ("builds", "loads")}


def check(ev: dict) -> List[str]:
    """The acceptance checks; a list of problems (empty: all hold)."""
    problems = []
    snap = ev["scrape"]
    have = (set(snap.get("counters", {})) | set(snap.get("gauges", {}))
            | set(snap.get("hists", {})))
    for name in SCRAPE_NAMES:
        if name not in have:
            problems.append(f"/metrics scrape missing {name}")
    if snap.get("counters", {}).get("serve.served", 0) < 1:
        problems.append("serve burst served nothing")
    ts = snap.get("timeseries")
    if not isinstance(ts, dict):
        problems.append("/metrics scrape has no timeseries section while "
                        "a store is active")
    elif ts.get("samples", 0) < 2:
        problems.append(f"timeseries store sampled {ts.get('samples')} "
                        f"times over the whole observed run")
    if not ev["events"]:
        problems.append("events.jsonl empty")
    for i, e in enumerate(ev["events"]):
        if not (isinstance(e, dict) and isinstance(e.get("ts"), float)
                and isinstance(e.get("event"), str)):
            problems.append(f"events.jsonl line {i + 1} breaks the "
                            f"{{ts, event}} schema: {e}")
            break
    kinds = {e.get("event") for e in ev["events"]}
    for want in EVENT_KINDS:
        if want not in kinds:
            problems.append(f"events.jsonl has no {want!r} event")
    if not ev["rollup"].get("by_op_class"):
        problems.append("profiler rollup empty (no device-time groups)")
    names = {e.get("name") for e in ev["trace_events"]}
    if "train.dispatch" not in names:
        problems.append("chrome trace has no train.dispatch host span")
    if not any(str(e.get("pid", "")).startswith("device:")
               for e in ev["trace_events"]):
        problems.append("chrome trace has no merged device events")
    if "X" not in {e.get("ph") for e in ev["trace_events"]}:
        problems.append("chrome trace has no duration events")
    steady = ev["final_epoch_loads"]
    if steady is None or any(steady.values()):
        problems.append(f"the final epoch built or loaded kernel libraries: "
                        f"{steady}")
    return problems


def overhead_turns(run_arm: Callable[[bool], List[float]], turns: int = 2
                   ) -> dict:
    """``run_arm(enabled)`` → per-step (or per-item) ms, called off, on,
    off, on ... ``turns`` times each; the medians of each arm's pooled
    values and their turn-by-turn medians."""
    arms: Dict[bool, List[List[float]]] = {False: [], True: []}
    for _ in range(turns):
        for enabled in (False, True):
            arms[enabled].append(run_arm(enabled))
    off = statistics.median(v for run in arms[False] for v in run)
    on = statistics.median(v for run in arms[True] for v in run)
    return {"disabled_ms_p50": off, "enabled_ms_p50": on,
            "overhead_pct": (on - off) / off * 100.0,
            "disabled_turns_ms_p50": [statistics.median(r)
                                      for r in arms[False]],
            "enabled_turns_ms_p50": [statistics.median(r)
                                     for r in arms[True]]}


class ObsPlane:
    """The plane as ``CliObs`` arms it for a measurement, without a run
    record: spans, the registry (through ``cfg.obs.enabled``), the
    sampler and the health engine on its samples.  A context manager;
    entered with ``enabled=False`` it does nothing."""

    def __init__(self, cfg, enabled: bool):
        self.cfg, self.enabled = cfg, enabled
        self.sampler = None

    def __enter__(self):
        if not self.enabled:
            return self
        from mx_rcnn_tpu_torch.obs import health as obs_health
        from mx_rcnn_tpu_torch.obs import timeseries as obs_ts
        from mx_rcnn_tpu_torch.obs import trace as obs_trace
        from mx_rcnn_tpu_torch.obs.metrics import registry

        obs_trace.enable(self.cfg.obs.trace_cap)
        obs_trace.reset()
        registry().reset()
        store = obs_ts.TimeSeriesStore(self.cfg.obs.ts_capacity)
        obs_ts.set_active(store)
        engine = obs_health.HealthEngine(obs_health.default_rules(self.cfg),
                                         store, registry=registry())
        self.sampler = obs_ts.Sampler(
            store, interval_s=self.cfg.obs.sample_interval_s,
            after_sample=engine.evaluate_sample).start()
        return self

    def __exit__(self, *exc):
        if self.sampler is not None:
            from mx_rcnn_tpu_torch.obs import timeseries as obs_ts
            from mx_rcnn_tpu_torch.obs import trace as obs_trace

            self.sampler.stop(final_sample=False)
            obs_ts.set_active(None)
            obs_trace.disable()
            obs_trace.reset()
        return False


def step_ms_of(cfg, device: str, skip: int = 4, **train_kw) -> List[float]:
    """Per-step wall ms of one ``train_net`` run of ``cfg`` without
    checkpoints (the first ``skip`` steps, warm-up, left out), from the
    fit loop's step callback."""
    from mx_rcnn_tpu_torch.tools.train import train_net

    ticks: List[float] = []
    train_net(cfg, device=device, seed=0, log=lambda line: None,
              step_callback=lambda step: ticks.append(time.perf_counter()),
              **train_kw)
    return [(b - a) * 1e3 for a, b in zip(ticks, ticks[1:])][skip:]


def measure_overhead(workdir: str, num_images: int, device: str) -> dict:
    """ms/step with the plane on against off, one epoch an arm, in turns
    (off, on, off, on)."""
    def arm(enabled: bool) -> List[float]:
        cfg = _cfg(workdir, enabled=enabled, trace=enabled,
                   timeseries=enabled, sample_interval_s=0.25,
                   health=enabled, run_dir=os.path.join(workdir, "runs"))
        with ObsPlane(cfg, enabled):
            return step_ms_of(cfg, device, end_epoch=1, synthetic=num_images)

    rec = overhead_turns(arm)
    return {"metric": "obs_enabled_step_overhead_pct",
            "value": rec["overhead_pct"], "unit": "%", "measured": True,
            "disabled_step_ms_p50": rec["disabled_ms_p50"],
            "enabled_step_ms_p50": rec["enabled_ms_p50"],
            "disabled_turns_ms_p50": rec["disabled_turns_ms_p50"],
            "enabled_turns_ms_p50": rec["enabled_turns_ms_p50"],
            "network": "tiny", "canvas": "128x160", "device": device,
            "steps_per_arm": num_images - 4,
            "sampling": "spans + registry + timeseries @ 0.25 s + health "
                        "rules (enabled arm)",
            "note": "median per-step wall over one epoch per arm, two "
                    "turns an arm (off, on, off, on), the first 4 steps "
                    "left out"}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=2,
                   help="2: the final epoch's build/load check needs a "
                        "first one")
    p.add_argument("--num_images", type=int, default=16)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--workdir", default=None,
                   help="default: a temporary directory, removed at exit")
    p.add_argument("--check", action="store_true",
                   help="exit 1 unless every check holds")
    p.add_argument("--overhead_out", default=None,
                   help="also measure obs-on against obs-off ms/step in "
                        "turns and write the record here")
    args = p.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="obs_smoke_")
    keep = args.workdir is not None
    try:
        ev = run_smoke(workdir, args.num_images, args.epochs, args.device)
        problems = check(ev)
        rec = {"metric": "obs_smoke", "value": 0 if problems else 1,
               "measured": True, "device": args.device,
               "metrics_scraped": sorted(
                   set(ev["scrape"].get("counters", {}))
                   | set(ev["scrape"].get("gauges", {}))
                   | set(ev["scrape"].get("hists", {}))),
               "events": len(ev["events"]),
               "final_epoch_loads": ev["final_epoch_loads"],
               "rollup_by_op_class": ev["rollup"].get("by_op_class"),
               "trace_events": len(ev["trace_events"]),
               "problems": problems}
        if args.overhead_out:
            overhead = measure_overhead(workdir, max(args.num_images, 32),
                                        args.device)
            with open(args.overhead_out, "w") as f:
                json.dump(overhead, f, indent=1)
            rec["overhead"] = overhead
        print(json.dumps(rec), flush=True)
        for msg in problems:
            logger.error("CHECK FAILED: %s", msg)
        return 1 if args.check and problems else 0
    finally:
        if not keep:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
