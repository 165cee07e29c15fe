"""Accuracy gauntlet: seed-stable mAP measurement on the hard synthetic set.

Counterpart of ``mx_rcnn_tpu/tools/gauntlet.py``: the same modes, recipe,
records, summaries, paired comparison, markdown and CLI, over the port's
``train_net``, ``alternate_train`` and ``test_rcnn``.  No download: it
trains from scratch on ``synthetic_hard`` (8 fg classes, scale /
occlusion / crowding + distractors, 400 train / 100 test, generated) over
several seeds and reports per-seed mAP and the spread.

Modes:
* ``e2e``       — end-to-end training (the default recipe),
* ``alternate`` — the 4-stage alternate schedule (ablation: alt ≈ e2e),
* ``prenms``    — e2e with TRAIN pre-NMS ``--prenms_n`` (ablation:
  mAP-neutral),
* ``redteam``   — e2e trained normally but evaluated with a DELIBERATELY
  damaged per-class NMS threshold (0.9: duplicate detections survive and
  flood the AP sweep with false positives).  It proves that the
  ``--compare`` gate's FAIL direction fires on a real training pair:
  training is bit-identical to ``e2e`` at a common seed, so the per-seed
  deltas isolate pure eval damage.  Never a recipe; a gate self-test.
* ``quant``     — e2e trained normally (bit-identical to ``e2e`` at a
  common seed) but EVALUATED through the quantized forward (``cfg.quant``,
  int8 native by default: K4 and K5 on the card).  ``--compare e2e
  quant`` is the quantization accuracy gate: the paired mAP delta must
  stay within ``--budget``.
* ``quant_redteam`` — the over-aggressive-quantization arm (weight_bits
  2: weights collapse to ±1 step) proving the quant gate's FAIL direction
  fires; never a recipe.

Each run appends a record to ``--out`` (JSON) keyed by (mode, network,
seed); ``--markdown`` re-renders every record into a table.  Runs are
resumable: existing (mode, network, seed) records are skipped unless
``--force``; a record of another recipe is refused up front.

``--compare MODE_A MODE_B``: paired-seed A/B inference.  Both arms share
seeds (common random numbers); the tool reports per-seed deltas, the
mean delta with a 95% t-CI and a sign test, and exits 1 unless the CI
lies inside ±``--budget`` (0.02 default).  The statistics are
``serve/rollout.py — paired_stats``, the online canary gate's.

What the port adds: ``--device`` (``cuda`` by default, which raises
without a card; ``cpu`` only when asked).  The paired deltas rest on
bit-identical training across modes at one seed, and the card's default
algorithms do not repeat (``tools/repro_probe.py``), so every cell
trains and evaluates under ``tools/quant_smoke.py — reproducible``
(deterministic algorithms, cuDNN benchmark off, TF32 off), and the
caller's settings come back afterwards.

    python -m mx_rcnn_tpu_torch.tools.gauntlet --seeds 0 1 2 3 4
    python -m mx_rcnn_tpu_torch.tools.gauntlet --compare e2e quant \\
        --seeds 0 1 2
    python -m mx_rcnn_tpu_torch.tools.gauntlet --device cpu --epochs 1 \\
        --seeds 0 --root /tmp/g --workdir /tmp/g/w --out /tmp/g/r.json
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, List

import numpy as np

from mx_rcnn_tpu_torch.serve.rollout import paired_stats

logger = logging.getLogger("mx_rcnn_tpu_torch")

_MODES = ("e2e", "alternate", "prenms", "redteam", "quant",
          "quant_redteam")

# the red-team arms' damage, in one place so the record, the docstring
# and the tests pin the same thing
_REDTEAM_NMS = 0.9
_QUANT_REDTEAM_BITS = 2


def _quant_tag(cfg) -> str:
    """Compact quant-recipe tag recorded with every quant-mode record so
    mixed quant recipes surface in summaries (see ``_recipe_str``)."""
    return (f"{cfg.quant.dtype}/{cfg.quant.mode}/{cfg.quant.estimator}/"
            f"b{cfg.quant.weight_bits}")


def _base_cfg(args):
    from mx_rcnn_tpu_torch.config import generate_config

    overrides = {
        "dataset__root_path": args.root,
        "dataset__dataset_path": os.path.join(args.root, "synthetic_hard"),
    }
    if args.batch_images:
        overrides["train__batch_images"] = args.batch_images
    return generate_config(args.network, "synthetic_hard", **overrides)


def run_one(args, mode: str, seed: int) -> Dict:
    """Train + eval one (mode, seed) cell on ``args.device`` under the
    reproducible pins; returns the result record."""
    from mx_rcnn_tpu_torch.tools.quant_smoke import reproducible
    from mx_rcnn_tpu_torch.tools.test import test_rcnn as eval_rcnn
    from mx_rcnn_tpu_torch.tools.train import train_net
    from mx_rcnn_tpu_torch.tools.train_alternate import alternate_train

    cfg = _base_cfg(args)
    eval_cfg = cfg
    if mode == "prenms":
        # at this canvas (2700 anchors) every cap >= 2700 is vacuous, so
        # the ablation uses --prenms_n (default: the ~27% analog of the
        # production 12000->6000) to bite
        cfg = eval_cfg = cfg.replace_in("train",
                                        rpn_pre_nms_top_n=args.prenms_n)
    elif mode == "redteam":
        # the damaged EVAL arm; training stays bit-identical to e2e
        eval_cfg = cfg.replace_in("test", nms=_REDTEAM_NMS)
    elif mode == "quant":
        # the quantized EVAL arm; test_rcnn calibrates and evaluates the
        # quantized forward when it sees quant.enabled
        eval_cfg = cfg.replace_in("quant", enabled=True)
    elif mode == "quant_redteam":
        eval_cfg = cfg.replace_in("quant", enabled=True,
                                  weight_bits=_QUANT_REDTEAM_BITS)
    prefix = os.path.join(args.workdir, f"{mode}-{args.network}-s{seed}")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    with reproducible():
        if mode == "alternate":
            half = max(1, args.epochs // 2)
            final = alternate_train(
                cfg, prefix=prefix, rpn_epoch=args.epochs,
                rcnn_epoch=args.epochs, rpn_lr=args.lr, rcnn_lr=args.lr,
                rpn_lr_step=str(args.epochs - half // 2),
                rcnn_lr_step=str(args.epochs - half // 2),
                frequent=10_000, seed=seed, device=args.device,
                log=logger.info)
            eval_prefix, eval_epoch = final, 1
        else:
            # decay late but not too late: slow-starting seeds need the
            # full high-lr phase, and only the settled post-decay plateau
            # is seed-stable
            train_net(cfg, prefix=prefix, end_epoch=args.epochs, lr=args.lr,
                      lr_step=args.lr_step or str(max(1, args.epochs - 6)),
                      frequent=10_000, seed=seed, device=args.device,
                      log=logger.info)
            eval_prefix, eval_epoch = prefix, args.epochs
        results = eval_rcnn(eval_cfg, prefix=eval_prefix, epoch=eval_epoch,
                            verbose=False, device=args.device)
    rec = {
        "mode": mode, "network": args.network, "seed": seed,
        "epochs": args.epochs, "lr": args.lr, "lr_step": args.lr_step,
        "batch_images": args.batch_images,
        "mAP": round(float(results["mAP"]), 4),
        "per_class": {k: round(float(v), 4) for k, v in results.items()
                      if k != "mAP"},
    }
    if mode == "prenms":
        rec["prenms_n"] = args.prenms_n
    elif mode == "redteam":
        rec["damage"] = f"test__nms={_REDTEAM_NMS}"
    elif mode == "quant":
        rec["quant"] = _quant_tag(eval_cfg)
    elif mode == "quant_redteam":
        rec["damage"] = f"quant__weight_bits={_QUANT_REDTEAM_BITS}"
        rec["quant"] = _quant_tag(eval_cfg)
    return rec


def _load(out: str) -> List[Dict]:
    if os.path.exists(out):
        with open(out) as f:
            return json.load(f)
    return []


def _key(r: Dict):
    return (r["mode"], r["network"], r["seed"])


def _recipe_str(r: Dict) -> str:
    """Compact recipe tag for a record — shown in summaries so
    mixed-recipe result files are visible instead of silently
    aggregated."""
    s = (f"ep{r.get('epochs', '?')}/lr{r.get('lr', '?')}"
         f"/step{r.get('lr_step') or 'auto'}/bi{r.get('batch_images', '?')}")
    if r.get("mode") == "prenms":
        s += f"/pre{r.get('prenms_n', '?')}"
    if "quant" in r:
        s += f"/q:{r['quant']}"
    return s


def summarize(records: List[Dict]) -> Dict[str, Dict]:
    """Per (mode, network): seed mAPs, mean, spread (max-min), recipes.

    ``recipes`` lists every distinct recipe contributing to the group —
    more than one entry means the stats mix training recipes and should
    not be compared point-for-point.
    """
    groups: Dict[str, List[Dict]] = {}
    for r in records:
        groups.setdefault(f"{r['mode']}/{r['network']}", []).append(r)
    out = {}
    for g, rs in sorted(groups.items()):
        maps = [r["mAP"] for r in sorted(rs, key=lambda r: r["seed"])]
        out[g] = {
            "seeds": [r["seed"] for r in sorted(rs, key=lambda r: r["seed"])],
            "mAPs": maps,
            "mean": round(float(np.mean(maps)), 4),
            "spread": round(float(max(maps) - min(maps)), 4),
            "recipes": sorted({_recipe_str(r) for r in rs}),
        }
    return out


def paired_compare(records: List[Dict], mode_a: str, mode_b: str,
                   network: str, budget: float = 0.02,
                   seeds: List[int] = None) -> Dict:
    """Paired-seed A/B inference over existing gauntlet records.

    Both arms train with COMMON random numbers (``run_one`` threads the
    seed into init and data order), so per-seed mAP deltas cancel the
    seed-to-seed variance that makes the absolute spread gate blunt.
    Reports, over the seeds present in BOTH arms:

    * per-seed deltas (mode_b − mode_a),
    * mean delta with a 95% Student-t CI (df = n−1),
    * a two-sided sign test p-value (zeros dropped),
    * ``within_budget``: whether the CI lies inside ±``budget`` — the
      equivalence gate (CI-inside-bounds, TOST-style, NOT a mere
      failure-to-reject).
    """
    a = {r["seed"]: r["mAP"] for r in records
         if r["mode"] == mode_a and r["network"] == network}
    b = {r["seed"]: r["mAP"] for r in records
         if r["mode"] == mode_b and r["network"] == network}
    common = set(a) & set(b)
    if seeds is not None:
        common &= set(seeds)
    seeds = sorted(common)
    if not seeds:
        raise ValueError(
            f"no common seeds between {mode_a!r} and {mode_b!r} "
            f"for network {network!r}")
    deltas = [round(b[s] - a[s], 4) for s in seeds]
    st = paired_stats(deltas, budget)
    return {
        "compare": f"{mode_b}-vs-{mode_a}", "network": network,
        "seeds": seeds, "deltas": deltas,
        "mean_delta": st["mean_delta"],
        "ci95": st["ci95"],
        "sign_test_p": st["sign_test_p"],
        "budget": budget,
        "within_budget": st["within_budget"],
    }


def render_markdown(records: List[Dict], path: str) -> None:
    """The records as the JAX tool's markdown table, byte for byte (its
    notes included: they describe how the recipe was calibrated)."""
    s = summarize(records)
    lines = [
        "# Accuracy gauntlet (`synthetic_hard`)",
        "",
        "Generated by `tools/gauntlet.py` — seed-stable mAP on the hard",
        "synthetic benchmark (8 fg classes, scale/occlusion/crowding,",
        "400 train / 100 test, VOC 07-metric AP@0.5).  The spread column",
        "(max−min over seeds) is the regression budget for any pinned",
        "end-metric expectations in the test suite.",
        "",
        "| mode/network | seeds | mAP per seed | mean | spread | recipe |",
        "|---|---|---|---|---|---|",
    ]
    for g, v in s.items():
        lines.append(
            f"| {g} | {v['seeds']} | "
            f"{', '.join(f'{m:.4f}' for m in v['mAPs'])} | "
            f"{v['mean']:.4f} | {v['spread']:.4f} | "
            f"{'; '.join(v['recipes'])} |")
    lines += [
        "",
        "Calibration history (round 4, in the open): the first recipe",
        "(20 epochs, decay at 15) measured spread 0.018 over seeds 0-2 —",
        "then seed 3 scored 0.6249, because it was still CLIMBING when",
        "the decay froze it (0.41→0.62 over epochs 10-20, rising).  The",
        "recipe was lengthened to 30 epochs / decay at 24, which rescued",
        "seed 3 to 0.7332; the table above is the full 5-seed",
        "measurement.  The honest seed spread of tiny-on-hard is ~0.035,",
        "and the spread budget in `tests/test_gauntlet.py` is set to",
        "match the measurement, not the round-3 aspiration.",
        "",
        "Environment sensitivity (measured, round 4): the same seed-0",
        "recipe (20-epoch variant) scores 0.7632 on a plain",
        "single-CPU-device JAX but 0.7094 under the test harness's",
        "8-virtual-device `xla_force_host_platform_device_count` flag —",
        "XLA CPU thread partitioning changes reduction numerics, and",
        "thousands of training steps amplify the drift to ~0.05 mAP.",
        "Within ONE environment runs are deterministic.  Pinned",
        "expectations therefore use a one-sided floor per environment",
        "(`tests/test_gauntlet.py — GATE_FLOOR`), and this table records",
        "the plain-JAX environment.",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description="Run the accuracy gauntlet")
    p.add_argument("--network", default="tiny",
                   choices=["vgg", "resnet50", "resnet101", "tiny"])
    p.add_argument("--mode", default=["e2e"], nargs="+",
                   choices=_MODES)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--lr_step", default=None)
    p.add_argument("--batch_images", type=int, default=2)
    p.add_argument("--prenms_n", type=int, default=750,
                   help="TRAIN pre-NMS cap for --mode prenms (default: the "
                        "~27%% proportional analog of 12000->6000 at this "
                        "canvas's 2700 anchors)")
    p.add_argument("--root", default="data")
    p.add_argument("--workdir", default="data/gauntlet")
    p.add_argument("--out", default="data/gauntlet/results.json")
    p.add_argument("--markdown", default=None,
                   help="also render all records into this markdown table")
    p.add_argument("--force", action="store_true",
                   help="re-run cells that already have records")
    p.add_argument("--compare", nargs=2, metavar=("MODE_A", "MODE_B"),
                   default=None,
                   help="paired-seed A/B: run any missing cells for both "
                        "modes over --seeds, then report per-seed deltas, "
                        "95%% CI and sign test; exits 1 if the CI is not "
                        "inside ±--budget")
    p.add_argument("--budget", type=float, default=0.02,
                   help="equivalence budget for --compare (CI must lie "
                        "inside ±budget)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    if args.compare:
        # argparse can't put choices= on a 2-tuple arg; validate here — an
        # unknown mode would silently train the default e2e recipe under
        # the wrong label and the A/B would "pass" comparing e2e to itself
        for m in args.compare:
            if m not in _MODES:
                p.error(f"--compare mode {m!r} not one of {_MODES}")

    # a compare run IS a run of its two arms (resumable like any other);
    # --mode is ignored in that case
    modes = list(args.compare) if args.compare else list(args.mode)

    def recipe_match(r: Dict) -> bool:
        # a record only satisfies this invocation if it was produced by
        # the SAME recipe — otherwise a stale 30-epoch record would pair
        # against a fresh 20-epoch arm and the deltas would measure the
        # recipe difference, not the mode difference.  Missing keys (old
        # records) count as matching.
        return (r.get("epochs", args.epochs) == args.epochs
                and r.get("lr", args.lr) == args.lr
                and r.get("lr_step", args.lr_step) == args.lr_step
                and r.get("batch_images",
                          args.batch_images) == args.batch_images
                and (r["mode"] != "prenms"
                     or r.get("prenms_n", args.prenms_n) == args.prenms_n))

    records = _load(args.out)
    have = {_key(r) for r in records if recipe_match(r)}
    have_other_recipe = {_key(r) for r in records
                         if not recipe_match(r)} - have
    # refuse rather than silently retrain-and-replace, and validate EVERY
    # requested cell up front, before the first training run
    if not args.force:
        stale = [k for mode in modes for seed in args.seeds
                 if (k := (mode, args.network, seed)) in have_other_recipe
                 and k not in have]
        if stale:
            p.error(
                f"{stale} exist in {args.out} under a DIFFERENT recipe "
                "(epochs/lr/lr_step/batch_images/prenms_n mismatch); "
                "use a fresh --out for this recipe, or --force to "
                "overwrite")
    if args.force or any((mode, args.network, seed) not in have
                         for mode in modes for seed in args.seeds):
        # a cell will train: no CUDA card raises here, before any cell
        from mx_rcnn_tpu_torch.utils.device import resolve_device

        resolve_device(args.device)
    for mode in modes:
        for seed in args.seeds:
            k = (mode, args.network, seed)
            if k in have and not args.force:
                logger.info("skip existing %s", k)
                continue
            logger.info("=== gauntlet %s seed %d ===", mode, seed)
            rec = run_one(args, mode, seed)
            records = [r for r in records if _key(r) != k] + [rec]
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(records, f, indent=1)
            logger.info("%s -> mAP %.4f", k, rec["mAP"])
    for g, v in summarize(records).items():
        print(json.dumps({"group": g, **v}))
    if args.markdown:
        render_markdown(records, args.markdown)
    if args.compare:
        cmp = paired_compare([r for r in records if recipe_match(r)],
                             args.compare[0], args.compare[1],
                             args.network, budget=args.budget,
                             seeds=args.seeds)
        print(json.dumps(cmp))
        if not cmp["within_budget"]:
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
