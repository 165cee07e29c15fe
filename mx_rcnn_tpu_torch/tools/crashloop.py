"""Crash-loop certification CLI: kill training M times, prove bit-exact
resume, emit the JSON record.

Counterpart of ``mx_rcnn_tpu/tools/crashloop.py``.  The claim it drives:
after SIGTERM and SIGKILL kills at planned and random steps and on-disk
faults (a torn write, bit rot, a stale interrupt checkpoint), the resume
through the integrity scanner recovers every time, no work is lost past
the last committed snapshot, and the survivor's final train state is
byte-identical to an uninterrupted control run's
(``ft/supervisor.py — run_crashloop``).  ``--smoke`` runs the two-kill
variant (one SIGTERM, one torn write and SIGKILL); ``--check`` exits 1
unless every invariant holds, the snapshot stall under
``--max_overhead_pct`` included.

``--elastic`` runs the preemption storm instead (``run_elastic_storm``):
a two-process world loses a member to SIGTERM (and, in the full drill,
SIGKILL), shrinks onto the survivor with ``grad_accum`` rescaled, grows
back and completes, every restore proven bit-identical to its checkpoint
and recovery timed from detection to the first step.

The children train on ``--device`` (the card unless ``--device cpu``).

    python -m mx_rcnn_tpu_torch.tools.crashloop --smoke --check
    python -m mx_rcnn_tpu_torch.tools.crashloop --elastic --smoke --check
    python -m mx_rcnn_tpu_torch.tools.crashloop --device cpu --smoke \\
        --check --num_images 16
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
import sys
import tempfile

from mx_rcnn_tpu_torch.ft.supervisor import (DEFAULT_EVENTS, SMOKE_EVENTS,
                                             measure_snapshot_overhead,
                                             run_crashloop, run_elastic_storm)

logger = logging.getLogger("mx_rcnn_tpu_torch")

# --check's ceiling on the async snapshot's stall, % of an epoch's time
MAX_OVERHEAD_PCT = 5.0


def _check_elastic(rec: dict, smoke: bool) -> list:
    """The storm's invariants: the preemptions injected (mixed in the full
    drill), a shrink and a grow, every restore bit-identical, no kernel
    built after a generation's first step, every checkpoint at the
    recipe's steps per epoch and steps left when the grow drained the
    shrunk world (port additions), the run completed, no sanitizer
    report."""
    problems = []
    want_kills = 1 if smoke else 4
    if rec["kills_total"] < want_kills:
        problems.append(f"only {rec['kills_total']} preemptions injected "
                        f"(need >= {want_kills})")
    if not smoke and (rec["kills"]["TERM"] < 1 or rec["kills"]["KILL"] < 1):
        problems.append(f"preemptions not mixed: {rec['kills']}")
    if rec["shrinks"] < 1:
        problems.append("no mesh shrink in the timeline")
    if rec["grows"] < 1:
        problems.append("no grow-back in the timeline")
    if rec["restores"] < 1:
        problems.append("no restore events (the storm never exercised "
                        "the state-surgery path)")
    if not rec["restores_bit_identical"]:
        problems.append("a restore was NOT bit-identical to its "
                        "checkpoint")
    if rec["unexpected_recompiles"]:
        problems.append(f"kernel builds after a generation's first step: "
                        f"{rec['unexpected_recompiles']}")
    if rec["manifest_steps_per_epoch"] != [rec["steps_per_epoch"]]:
        problems.append(f"checkpoints record steps per epoch "
                        f"{rec['manifest_steps_per_epoch']}, the recipe "
                        f"{rec['steps_per_epoch']}: the schedule moved")
    if rec["steps_left_at_grow"] < 1:
        problems.append(f"the grow landed with "
                        f"{rec['steps_left_at_grow']} steps left")
    if not rec["completed"]:
        problems.append(f"run did not complete ({rec['final_step']} < "
                        f"{rec['total_steps']} steps)")
    if rec.get("locksan_dirty_workers"):
        problems.append(
            f"{rec['locksan_dirty_workers']} sanitizer-armed worker(s) "
            "reported lock-order inversions or watchdog trips "
            "(LOCKSAN_DIRTY)")
    return problems


def _emit(rec: dict, out) -> None:
    print(json.dumps(rec, indent=1), flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
        logger.info("record written to %s", out)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--network", default="tiny")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--end_epoch", type=int, default=None,
                   help="default: 5 (smoke: 3)")
    p.add_argument("--num_images", type=int, default=None,
                   help="synthetic images (default: 32 for the crash loop, "
                        "24 for --elastic)")
    p.add_argument("--image_size", default="128x160",
                   help="HxW of the synthetic images and the bucket")
    p.add_argument("--seed", type=int, default=0,
                   help="training seed (both arms)")
    p.add_argument("--rng_seed", type=int, default=0,
                   help="kill-step scheduling seed (the 'random steps')")
    p.add_argument("--workdir", default=None,
                   help="default: a fresh temp dir (kept on failure)")
    p.add_argument("--out", default=None, help="write the JSON record here")
    p.add_argument("--smoke", action="store_true",
                   help="the 2-kill fast variant")
    p.add_argument("--check", action="store_true",
                   help="exit 1 unless all invariants hold")
    p.add_argument("--skip_overhead", action="store_true",
                   help="skip the in-process snapshot-overhead measurement")
    p.add_argument("--max_overhead_pct", type=float,
                   default=MAX_OVERHEAD_PCT,
                   help="--check: async snapshot stall ceiling")
    p.add_argument("--elastic", action="store_true",
                   help="run the elastic preemption storm instead of the "
                        "crash loop")
    p.add_argument("--device", default="cuda",
                   help="the children's device: cuda (default) or cpu")
    args = p.parse_args(argv)
    # training children inherit MXRCNN_THREAD_SANITIZER and arm themselves
    from mx_rcnn_tpu_torch.analysis import sanitizer

    sanitizer.maybe_install_from_env()
    h, w = (int(v) for v in args.image_size.split("x"))
    auto_workdir = args.workdir is None

    if args.elastic:
        workdir = args.workdir or tempfile.mkdtemp(prefix="elastic_storm_")
        logger.info("elastic storm workdir: %s", workdir)
        rec = run_elastic_storm(
            workdir, smoke=args.smoke, network=args.network,
            dataset=args.dataset, end_epoch=args.end_epoch,
            num_images=args.num_images or 24, image_size=(h, w),
            seed=args.seed, device=args.device)
        _emit(rec, args.out)
        if args.check:
            problems = _check_elastic(rec, args.smoke) \
                + sanitizer.check_problems()
            for msg in problems:
                logger.error("CHECK FAILED: %s", msg)
            if problems:
                logger.error("storm tree kept for triage: %s", workdir)
                sys.exit(1)
            logger.info(
                "all elastic invariants hold (%d preemptions, %d shrinks, "
                "%d grows, %d bit-identical restores, recovery p50 "
                "%.0f ms)", rec["kills_total"], rec["shrinks"],
                rec["grows"], rec["restores"], rec["recovery_ms"]["p50"])
        if auto_workdir:
            shutil.rmtree(workdir, ignore_errors=True)
        return rec

    events = SMOKE_EVENTS if args.smoke else DEFAULT_EVENTS
    end_epoch = args.end_epoch or (3 if args.smoke else 5)
    workdir = args.workdir or tempfile.mkdtemp(prefix="ft_crashloop_")
    logger.info("crashloop workdir: %s", workdir)
    rec = run_crashloop(
        workdir, events=events, network=args.network, dataset=args.dataset,
        end_epoch=end_epoch, num_images=args.num_images or 32,
        image_size=(h, w), seed=args.seed, rng_seed=args.rng_seed,
        device=args.device)
    rec = {"metric": "ft_crashloop", "measured": True,
           "network": args.network, "dataset": args.dataset,
           "smoke": args.smoke, **rec}
    if not args.skip_overhead:
        rec["snapshot_overhead"] = measure_snapshot_overhead(
            network=args.network, device=args.device)
    _emit(rec, args.out)

    if args.check:
        problems = sanitizer.check_problems()
        if not rec["bit_identical"]:
            problems.append("survivor final TrainState is NOT bit-identical "
                            "to the control run")
        if rec["kills_survived"] < len(events):
            problems.append(f"only {rec['kills_survived']} of {len(events)} "
                            f"planned kills fired and were survived")
        ov = rec.get("snapshot_overhead")
        if ov and ov["async_stall_overhead_pct"] > args.max_overhead_pct:
            problems.append(
                f"async snapshot step-pipeline stall "
                f"{ov['async_stall_overhead_pct']}% > "
                f"{args.max_overhead_pct}% ceiling")
        for msg in problems:
            logger.error("CHECK FAILED: %s", msg)
        if problems:
            logger.error("checkpoint trees kept for triage: %s", workdir)
            sys.exit(1)
        logger.info("all crash-loop invariants hold (%d kills, "
                    "bit-identical survivor)", rec["kills_survived"])
    if auto_workdir:
        # success: drop the two training trees (a failure above keeps them)
        shutil.rmtree(workdir, ignore_errors=True)
    return rec


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    main()
