"""The wire data-plane bench.

Counterpart of ``mx_rcnn_tpu/tools/wire_bench.py``, driven through
``tools/loadgen.py --wire_bench`` (the full battery) and ``--wire_smoke``
(gate scale).  The rig of ``tools/crosshost.py``: every "host" is a
``tools/agent.py`` process on a port it binds itself, so every arm
crosses a real process boundary, and the processes share this machine,
so ratios check the data plane (codec, syscalls, pipeline), not
several machines.

Arms: one u8 burst, one content-stub agent; the arms differ only at the
head:

1. **v1-fp32**: the head runs pad and normalize
   (``data/image.py — pad_normalize``) and ships the fp32 canvas
   (4 bytes a pixel) through ``submit_prepared``, inside the measured
   window, as the v1 path does;
2. **v2-u8**: ``submit_source`` ships the source's u8 pixels (1 byte a
   pixel, no padding); the agent runs the same ``pad_normalize`` before
   it enqueues, so the canvases and the content-stub's detections are
   bit-equal;
3. **v2-u8 + coalesce**: ``crosshost.frames_per_send`` packs queued
   frames into count-prefixed envelopes shipped with a vectored
   ``sendmsg``;
4. **+ adaptive**: ``crosshost.pipeline_depth_max`` lets each
   connection's depth tune itself from the windowed wire RTT.

Checks (``--check``): v2-u8 at most ``--max_wire_bytes_ratio`` (0.30) of
v1-fp32's bytes an image, from the engine's ``wire_tx_bytes`` counters
and from the codec's arithmetic at the production bucket; the coalesced
arm at least ``--min_wire_speedup`` (1.8) times the v1 arm's throughput;
detections bit-equal across the arms; 0 lost in every leg; no kernel
built after the agent's warm; and the SIGKILL-mid-envelope leg ends
every frame exactly once, rerouted within its original deadline.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from typing import Dict, List, Tuple

import numpy as np

from mx_rcnn_tpu_torch.config import (Config, generate_config,
                                      parse_set_overrides)
from mx_rcnn_tpu_torch.data.image import pad_normalize
from mx_rcnn_tpu_torch.serve.queue import (DeadlineExceeded, RequestFailed,
                                           ShedError)
from mx_rcnn_tpu_torch.serve.remote import (_REQ_HEAD, _REQ_HEAD2,
                                            RemoteEngine,
                                            build_crosshost_router)
from mx_rcnn_tpu_torch.tools.crosshost import AgentProc, _scrape
from mx_rcnn_tpu_torch.tools.loadgen import _drain, _smoke_overrides

logger = logging.getLogger("mx_rcnn_tpu_torch")

# wire counters RemoteEngine maintains beyond the pinned serve set —
# read straight off the registry (ServeMetrics.snapshot keeps the
# pre-registry counter list bit-for-bit, so these never appear there)
_WIRE_KEYS = ("wire_tx_bytes", "wire_rx_bytes", "wire_frames",
              "wire_sends", "envelopes")


def _wire_counters(eng: RemoteEngine) -> Dict[str, int]:
    return {k: eng.metrics.registry.counter("serve." + k)
            for k in _WIRE_KEYS}


def _source_set(cfg: Config, n: int, seed: int = 0) -> List[Tuple]:
    """n (u8 image, im_info, bucket) triples alternating over the shape
    buckets; every third image is SMALLER than its bucket so the v2
    pad-on-agent path (h<bh, w<bw) is measured, not just full
    canvases."""
    rng = np.random.RandomState(seed)
    buckets = [tuple(b) for b in cfg.bucket.shapes]
    out = []
    for i in range(n):
        bh, bw = buckets[i % len(buckets)]
        h, w = (bh, bw) if i % 3 else (max(bh - 16, 8), max(bw - 24, 8))
        img = rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
        out.append((img, np.array([h, w, 1.0], np.float32), (bh, bw)))
    return out


def _det_key(dets) -> bytes:
    """Canonical byte key over a detections dict — bit-equality across
    arms is the whole claim (same idiom as the fleet bench)."""
    return b"".join(np.ascontiguousarray(dets[c]).tobytes()
                    for c in sorted(dets))


def _submit(target, item, mode: str, means, timeout_ms: float):
    img, im_info, bucket = item
    if mode == "v1":
        # deployed v1 path: the head materializes the fp32 canvas
        return target.submit_prepared(pad_normalize(img, means, bucket),
                                      im_info, bucket,
                                      timeout_ms=timeout_ms)
    return target.submit_source(img, im_info, bucket,
                                timeout_ms=timeout_ms)


def _equality_pass(target, items, mode: str, means,
                   timeout_ms: float) -> List[bytes]:
    """One sequential pass over the corpus → per-image detection keys
    (sequential so shed/backpressure can never skew the comparison)."""
    keys = []
    for item in items:
        dets = _submit(target, item, mode, means,
                       timeout_ms).wait(timeout_ms / 1000.0 + 30.0)
        keys.append(_det_key(dets) if dets else b"<empty>")
    return keys


def _run_wire_closed(target, items, mode: str, means,
                     duration_s: float, concurrency: int,
                     timeout_ms: float) -> dict:
    """Closed loop over the arm's submit path — ``target`` is a bare
    RemoteEngine or the cross-host router."""
    stop = time.monotonic() + duration_s
    outcomes = {"ok": 0, "shed": 0, "expired": 0, "failed": 0}
    lock = threading.Lock()

    def worker(wid: int):
        i = wid
        while time.monotonic() < stop:
            item = items[i % len(items)]
            i += concurrency
            try:
                req = _submit(target, item, mode, means, timeout_ms)
                req.wait(timeout=timeout_ms / 1000.0 + 30.0)
                key = "ok"
            except ShedError:
                key = "shed"
                time.sleep(0.005)  # real clients back off; a tight
                # resubmit spin would just burn the shared core
            except DeadlineExceeded:
                key = "expired"
            except (RequestFailed, TimeoutError):
                key = "failed"
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


def _run_arm(name: str, url: str, acfg: Config, items, mode: str,
             means, dur: float, concurrency: int, timeout_ms: float,
             problems: List[str]) -> dict:
    eng = RemoteEngine(f"wire-{name}", url, acfg, wire="binary")
    try:
        keys = _equality_pass(eng, items, mode, means, timeout_ms)
        _drain(eng)
        # warm the whole path (connections, codec, agent lanes) before
        # the measured window, then zero the serve counters AND take a
        # wire-counter baseline (the registry keeps wire_* across
        # ServeMetrics.reset — deltas keep warm traffic out)
        _run_wire_closed(eng, items, mode, means, 0.5, concurrency,
                         timeout_ms)
        _drain(eng)
        eng.metrics.reset()
        base = _wire_counters(eng)
        run = _run_wire_closed(eng, items, mode, means, dur,
                               concurrency, timeout_ms)
        _drain(eng)
        snap = eng.metrics.snapshot()
        wire = {k: v - base[k] for k, v in _wire_counters(eng).items()}
        frames = max(wire["wire_frames"], 1)
        leg = {
            "mode": mode,
            "imgs_per_sec": round(run["client"]["ok"] / run["wall_s"],
                                  2),
            "p50_ms": snap["total_ms"]["p50"],
            "p99_ms": snap["total_ms"]["p99"],
            "client": run["client"],
            "lost": snap["counters"]["submitted"] - snap["terminated"],
            "wire": wire,
            "tx_bytes_per_image": round(wire["wire_tx_bytes"] / frames,
                                        1),
            "frames_per_send": round(frames
                                     / max(wire["wire_sends"], 1), 2),
        }
        pipe = getattr(eng, "_pipe", None)
        if pipe is not None:
            leg["pipeline_depth_initial"] = acfg.crosshost.pipeline_depth
            leg["pipeline_depth_final"] = pipe.current()
            leg["pipeline_depth_peak"] = pipe.depth_peak
            leg["pipeline_retunes"] = pipe.retunes
        if leg["lost"]:
            problems.append(f"arm {name} lost {leg['lost']} requests")
        if run["client"]["ok"] == 0:
            problems.append(f"arm {name} served nothing")
        if run["client"]["failed"] or run["client"]["expired"]:
            problems.append(f"arm {name} had client failures/expiries: "
                            f"{run['client']}")
        return leg, keys
    finally:
        eng.close()


def _codec_math(network: str, dataset: str) -> dict:
    """Pure codec arithmetic at the PRODUCTION bucket (no overrides):
    header + payload bytes per image for a full-canvas frame on each
    wire version.  The rig measures tiny buckets on a shared core; this
    is the bytes-per-image claim at deployment scale, where payload
    dwarfs every fixed cost."""
    pcfg = generate_config(network, dataset)
    bh, bw = max((tuple(b) for b in pcfg.bucket.shapes),
                 key=lambda b: b[0] * b[1])
    v1 = _REQ_HEAD.size + bh * bw * 3 * 4
    v2 = _REQ_HEAD2.size + bh * bw * 3
    return {
        "bucket": [bh, bw],
        "v1_fp32_bytes_per_image": v1,
        "v2_u8_bytes_per_image": v2,
        "ratio": round(v2 / v1, 4),
    }


def _kill_leg(cfg: Config, agent_overrides: Dict, args, workdir: str,
              items, means, timeout_ms: float,
              concurrency: int, problems: List[str]) -> dict:
    """SIGKILL one of two agents mid-burst while the head is shipping
    coalesced v2 envelopes: every admitted frame must reach EXACTLY ONE
    terminal, and every non-shed frame must serve within its ORIGINAL
    deadline (reroute never extends it)."""
    kcfg = cfg.replace_in("crosshost", dead_after_failures=2,
                          for_samples=2, cooldown_s=1.0,
                          interval_s=0.2, window_s=5.0)
    kcfg = kcfg.replace_in("fleet", reroute_retries=2,
                           health_interval_s=0.2)
    agents = [AgentProc(workdir, f"wirekill-{i}", agent_overrides,
                        network=args.network, dataset=args.dataset,
                        replicas=1, stub_ms=0.0, stub="content",
                        device=args.device)
              for i in range(2)]
    try:
        for a in agents:
            a.wait_ready()
        router, feed = build_crosshost_router(kcfg,
                                              [a.url for a in agents])
        try:
            kdur = max(min(args.duration, 6.0)
                       if args.wire_smoke else args.duration, 6.0)
            box = {}

            def burst():
                box["run"] = _run_wire_closed(router, items, "v2",
                                              means, kdur, concurrency,
                                              timeout_ms)

            bt = threading.Thread(target=burst, daemon=True)
            bt.start()
            time.sleep(kdur / 3.0)
            served_before = router.metrics.snapshot()["counters"][
                "served"]
            agents[1].sigkill()
            bt.join()
            _drain(router)
            run = box["run"]
            snap = router.metrics.snapshot()
            c = snap["counters"]
            envelopes = sum(
                r.engine.metrics.registry.counter("serve.envelopes")
                for r in router.manager.replicas
                if r.engine is not None)
            leg = {
                "submitted": c["submitted"], "served": c["served"],
                "shed": c["shed"], "expired": c["expired"],
                "failed": c["failed"],
                "lost": c["submitted"] - snap["terminated"],
                "served_after_kill": c["served"] - served_before,
                "rerouted": router.rerouted(),
                "envelopes": envelopes,
                "client": run["client"],
            }
            if leg["lost"]:
                problems.append(f"kill leg lost {leg['lost']} frames — "
                                "exactly-once accounting broken")
            if run["client"]["failed"] or run["client"]["expired"]:
                problems.append(
                    "kill leg had client failures/expiries — reroute "
                    "did not complete within the original deadline: "
                    f"{run['client']}")
            if leg["served_after_kill"] <= 0:
                problems.append("nothing served after the agent kill")
            if leg["rerouted"] <= 0:
                problems.append("kill leg recorded no reroutes")
            if envelopes <= 0:
                problems.append("kill leg shipped no envelopes — the "
                                "coalescing path was not exercised")
            return leg
        finally:
            feed.close()
            router.close()
    finally:
        for a in agents:
            a.kill()


def run_wire_bench(args) -> int:
    from mx_rcnn_tpu_torch.analysis import sanitizer

    from mx_rcnn_tpu_torch.serve.fleet import default_devices

    # the agents' device is resolved (and refused) before anything runs
    default_devices(args.device)
    smoke = args.wire_smoke
    overrides = dict(_smoke_overrides())  # both tiers use the tiny
    # rig: every "host" shares one box, so the production canvas would
    # only measure core contention; --check's bytes claim at production
    # scale comes from the codec-math block
    overrides.update(parse_set_overrides(args.set))
    cfg = generate_config(args.network, args.dataset, **overrides)
    agent_overrides = dict(overrides, serve__max_delay_ms=2.0)
    workdir = args.workdir or tempfile.mkdtemp(prefix="wire_bench_")
    os.makedirs(workdir, exist_ok=True)
    timeout_ms = (20_000.0 if args.timeout_ms is None
                  else args.timeout_ms)
    dur = min(args.duration, 2.5) if smoke else max(args.duration / 2,
                                                    4.0)
    batch = cfg.serve.batch_size
    # per-engine capacity (connections x pipeline depth) must cover the
    # closed-loop concurrency or the head's own gate sheds the burst
    concurrency = 4 * batch
    ch_over = {"connections": 2, "pipeline_depth": 2 * batch,
               "scrape_interval_s": 0.2, "io_timeout_s": 30.0}
    items = _source_set(cfg, max(args.images, 6), args.seed)
    means = cfg.network.pixel_means
    rec: dict = {
        "metric": "wire_tx_bytes_per_image_v2_over_v1",
        "unit": "x",
        "measured": True,
        "smoke": smoke,
        "network": args.network,
        "bucket_shapes": [list(b) for b in cfg.bucket.shapes],
        "batch_size": batch,
        "host": {"physical_cores": os.cpu_count()},
        "note": "all four arms share one box and one content-stub "
                "agent process; the arms differ ONLY head-side, so "
                "ratios isolate the wire codec + send path.  The v1 "
                "arm pays head-side pad+normalize per request — that "
                "IS the deployed v1 data path (the head owned "
                "preprocess); v2 moves it behind the wire.",
    }
    problems: List[str] = []

    # -- 1. four-arm A/B against one content-stub agent -----------------
    logger.info("[wire] arm agent boot ...")
    aw = AgentProc(workdir, "wire-arms", agent_overrides,
                   network=args.network, dataset=args.dataset,
                   replicas=1, stub_ms=0.0, stub="content",
                   device=args.device)
    arms: dict = {}
    keys: Dict[str, List[bytes]] = {}
    try:
        aw.wait_ready()
        base = cfg.replace_in("crosshost", **ch_over)
        plans = [
            ("v1-fp32", "v1", base),
            ("v2-u8", "v2", base),
            ("v2-u8-coalesce", "v2",
             base.replace_in("crosshost", frames_per_send=4)),
            ("v2-u8-adaptive", "v2",
             base.replace_in("crosshost", frames_per_send=4,
                             pipeline_depth_max=4 * batch)),
        ]
        for name, mode, acfg in plans:
            logger.info("[wire] arm %s ...", name)
            arms[name], keys[name] = _run_arm(
                name, aw.url, acfg, items, mode, means, dur,
                concurrency, timeout_ms, problems)
        snap = _scrape(aw.url)
        builds = snap.get("gauges", {}).get(
            "agent.kernel_builds_after_warm")
        rec["kernel_builds_after_warm"] = builds
        if builds:
            problems.append(f"agent built {builds} kernel librar(ies) "
                            "after its warm")
    finally:
        aw.kill()
    rec["arms"] = arms

    # detections must be bit-equal across every arm — the v2 claim is
    # "same canvas, fewer bytes", not "close enough"
    ref = keys["v1-fp32"]
    for name, ks in keys.items():
        if ks != ref:
            diff = sum(1 for a, b in zip(ref, ks) if a != b)
            problems.append(f"arm {name} detections differ from "
                            f"v1-fp32 on {diff}/{len(ref)} images — "
                            "wire v2 changed results")
    rec["bit_equal_arms"] = all(ks == ref for ks in keys.values())

    bytes_ratio = (arms["v2-u8"]["tx_bytes_per_image"]
                   / max(arms["v1-fp32"]["tx_bytes_per_image"], 1e-9))
    rec["measured_bytes_ratio"] = round(bytes_ratio, 4)
    rec["value"] = rec["measured_bytes_ratio"]
    rec["codec_math_production"] = _codec_math(args.network,
                                               args.dataset)
    speed = (arms["v2-u8-coalesce"]["imgs_per_sec"]
             / max(arms["v1-fp32"]["imgs_per_sec"], 1e-9))
    rec["coalesce_speedup_over_v1"] = round(speed, 3)
    if bytes_ratio > args.max_wire_bytes_ratio:
        problems.append(f"measured v2/v1 bytes ratio {bytes_ratio:.3f}"
                        f" > {args.max_wire_bytes_ratio}")
    if rec["codec_math_production"]["ratio"] > args.max_wire_bytes_ratio:
        problems.append("production-bucket codec ratio "
                        f"{rec['codec_math_production']['ratio']} > "
                        f"{args.max_wire_bytes_ratio}")
    if speed < args.min_wire_speedup:
        problems.append(f"coalesced arm {speed:.3f}x v1-fp32 < "
                        f"{args.min_wire_speedup}")
    # the GROWTH/DECREASE directions are pinned deterministically with
    # synthetic RTTs in the tests; on this shared-core rig
    # the converged depth is load-dependent, so the bench asserts the
    # controller ran and actually moved the depth, not where it landed
    ad = arms["v2-u8-adaptive"]
    if ad.get("pipeline_retunes", 0) <= 0:
        problems.append("adaptive arm's controller never retuned")
    if (ad.get("pipeline_depth_final") == ad.get("pipeline_depth_initial")
            and ad.get("pipeline_depth_peak")
            == ad.get("pipeline_depth_initial")):
        problems.append("adaptive arm's depth never moved off "
                        f"{ad.get('pipeline_depth_initial')} under a "
                        "saturating closed loop")

    # -- 2. SIGKILL mid-envelope over 2 hosts ----------------------------
    logger.info("[wire] kill-mid-envelope leg ...")
    kill_cfg = cfg.replace_in("crosshost", **dict(ch_over,
                                                  frames_per_send=4))
    rec["kill_mid_envelope"] = _kill_leg(
        kill_cfg, agent_overrides, args, workdir, items,
        means, timeout_ms, concurrency=2 * concurrency,
        problems=problems)

    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    if args.check:
        problems += sanitizer.check_problems()
        for msg in problems:
            logger.error("CHECK FAILED: %s", msg)
        return 1 if problems else 0
    return 0
