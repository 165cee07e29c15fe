"""Prove the quantized inference path end to end on the tiny network.

Counterpart of ``mx_rcnn_tpu/tools/quant_smoke.py``: train the tiny
network briefly on synthetic data, then check

* **fp bit-identity with quant off**: the Predictor's outputs are
  bit-equal to the model's own forward, and the quantized model's
  parameters (names and shapes) are the fp model's, so fp32 checkpoints
  load into it unchanged;
* **the accuracy gate passes on int8**: the quantized eval (calibration
  sweep → int8 forward) stays within ``quant.map_delta_budget`` mAP of
  the fp eval of the same checkpoint;
* **the red-team arm fires the gate**: ``weight_bits=2`` loses more
  than the budget, so the gate has teeth;
* **the quantized export round-trips**: ``export_serve_programs`` over
  the int8 predictor (each program's bits verified), then a fresh engine
  over a fresh calibration joins from the store (its calibration
  fingerprint admitted) and serves an 8-image burst, every request
  SERVED, with no kernel library built after the join
  (``post_join_builds``, from ``kernels.load_events()``; the JAX tool
  counts lowerings);
* **admission refuses mismatches**: an fp config and a quant config
  calibrated by another estimator are both refused by the store.

``--check`` turns the checks into the exit code.  Runs on the card by
default; ``--device cpu`` on the CPU.

The run uses PyTorch's deterministic algorithms in full fp32
(:func:`reproducible`), so it reads the same mAPs every time and from
every caller, as the JAX tool does on the TPU: with the card's default
algorithms two fp32 trainings from one seed can end at different
weights, and the gate would judge a different checkpoint on every run.

    python -m mx_rcnn_tpu_torch.tools.quant_smoke --check
    python -m mx_rcnn_tpu_torch.tools.quant_smoke --device cpu --check
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.tester import Predictor, quant_predictor
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.serve.engine import ServingEngine
from mx_rcnn_tpu_torch.serve.export import (ExportMismatch, ExportStore,
                                            export_serve_programs)
from mx_rcnn_tpu_torch.tools.loadgen import synthetic_images
from mx_rcnn_tpu_torch.tools.test import test_rcnn
from mx_rcnn_tpu_torch.tools.train import train_net
from mx_rcnn_tpu_torch.utils.checkpoint import load_model, load_state_dict
from mx_rcnn_tpu_torch.utils.device import resolve_device

# the JAX smoke's miniature recipe (tools/obs_smoke.py — _TINY): a
# 128x160 canvas, short proposal lists, no flips
_TINY = {
    "train__rpn_pre_nms_top_n": 1024, "train__rpn_post_nms_top_n": 300,
    "train__max_gt_boxes": 8, "train__flip": False,
    "test__rpn_pre_nms_top_n": 512, "test__rpn_post_nms_top_n": 64,
    "bucket__scale": 128, "bucket__max_size": 160,
    "bucket__shapes": ((128, 160), (160, 128)),
    "default__frequent": 10_000,
}


def _cfg(workdir: str, **kw):
    over = dict(_TINY)
    over.update({
        "dataset__root_path": os.path.join(workdir, "data"),
        "dataset__dataset_path": os.path.join(workdir, "data", "synthetic"),
    })
    over.update(kw)
    return generate_config("tiny", "synthetic", **over)


@contextlib.contextmanager
def reproducible():
    """Run the body with ``torch.use_deterministic_algorithms(True)``,
    cuDNN's benchmark off and TF32 off in convolutions and matmuls (the
    result then hangs on no setting of the caller's), then restore the
    caller's settings.  An op with no deterministic version raises
    instead of running; cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG`` for it,
    set here where unset."""
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if env is None:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        torch.backends.cudnn.benchmark = was[2]
        torch.backends.cudnn.allow_tf32 = was[3]
        torch.backends.cuda.matmul.allow_tf32 = was[4]
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]


def run_smoke(workdir: str, num_images: int, epochs: int,
              device="cuda") -> dict:
    """Train, then gather the checks' evidence, all under
    :func:`reproducible`; returns the record."""
    with reproducible():
        return _run_smoke(workdir, num_images, epochs, device)


def _run_smoke(workdir: str, num_images: int, epochs: int,
               device) -> dict:
    dev = resolve_device(device)
    cfg = _cfg(workdir)
    dataset_kw = {"num_images": num_images}
    prefix = os.path.join(workdir, "model", "e2e")
    train_net(cfg, prefix=prefix, end_epoch=epochs, seed=0,
              dataset_kw=dataset_kw, device=dev, log=lambda line: None)
    ev: dict = {"epochs": epochs, "num_images": num_images,
                "device": str(dev)}

    # ---- fp bit-identity with quant off -------------------------------
    model = load_model(cfg, prefix, epochs, dev)
    rng = np.random.RandomState(0)
    images = (rng.rand(2, 128, 160, 3) * 255.0).astype(np.float32)
    im_info = np.tile(np.array([128, 160, 1.0], np.float32), (2, 1))
    via_pred = Predictor(model, cfg, dev)(images, im_info)
    with torch.inference_mode():
        direct = [t.cpu().numpy() for t in model(
            torch.from_numpy(images).to(dev),
            torch.from_numpy(im_info).to(dev))]
    ev["fp_bit_identical"] = all(
        a.dtype == b.dtype and a.shape == b.shape and (a == b).all()
        for a, b in zip(via_pred, direct))
    qcfg = cfg.replace_in("quant", enabled=True)
    fp_params = {k: tuple(v.shape) for k, v in
                 build_model(cfg, "cpu", None).state_dict().items()}
    q_params = {k: tuple(v.shape) for k, v in
                build_model(qcfg, "cpu", None).state_dict().items()}
    ev["param_tree_unchanged"] = fp_params == q_params

    # ---- accuracy gate: fp, int8, red team ----------------------------
    def m_ap(c) -> float:
        return float(test_rcnn(c, prefix=prefix, epoch=epochs, verbose=False,
                               dataset_kw=dataset_kw, device=dev)["mAP"])

    res_fp = m_ap(cfg)
    res_q = m_ap(qcfg)
    res_rt = m_ap(cfg.replace_in("quant", enabled=True, weight_bits=2))
    budget = cfg.quant.map_delta_budget
    ev.update({
        "mAP_fp": round(res_fp, 4),
        "mAP_int8": round(res_q, 4),
        "mAP_redteam_2bit": round(res_rt, 4),
        "budget": budget,
        "quant_delta": round(res_q - res_fp, 4),
        "redteam_delta": round(res_rt - res_fp, 4),
    })
    ev["accuracy_gate_pass"] = abs(ev["quant_delta"]) <= budget
    ev["redteam_gate_fires"] = ev["redteam_delta"] < -budget

    # ---- the quantized export round trip ------------------------------
    sd = load_state_dict(prefix, epochs)
    qpred = quant_predictor(qcfg, sd, dev, dataset_kw=dataset_kw)
    ev["calibration_fingerprint"] = qpred.quant_fingerprint
    store_dir = os.path.join(workdir, "export")
    report = export_serve_programs(qpred, qcfg, store_dir)
    ev["export_bit_equal"] = bool(report["bit_equal"])
    ev["export_programs"] = len(report["programs"])
    # a fresh engine over a fresh calibration: the join's admission
    # compares its fingerprint with the manifest's
    engine = ServingEngine(quant_predictor(qcfg, sd, dev,
                                           dataset_kw=dataset_kw), qcfg)
    served = lost = 0
    try:
        ev["join"] = engine.warm_from_export(ExportStore(store_dir))
        builds = kernels.load_events()["builds"]
        handles = [engine.submit(img, timeout_ms=0)
                   for img in synthetic_images(qcfg, 8)]
        for h in handles:
            try:
                h.wait(timeout=120)
                served += 1
            except Exception:  # noqa: BLE001 — counted, then checked
                lost += 1
    finally:
        engine.close()
    ev.update({"burst_served": served, "burst_lost": lost,
               "post_join_builds": kernels.load_events()["builds"] - builds})

    # ---- admission refusals -------------------------------------------
    store = ExportStore(store_dir)
    try:
        store.check(cfg, device=dev)   # fp config, quantized store
        ev["refuses_fp_config"] = False
    except ExportMismatch:
        ev["refuses_fp_config"] = True
    est_cfg = qcfg.replace_in("quant", estimator="percentile")
    ppred = quant_predictor(est_cfg, sd, dev, dataset_kw=dataset_kw)
    try:
        store.check(est_cfg, quant_fingerprint=ppred.quant_fingerprint,
                    device=dev)
        ev["refuses_estimator_mismatch"] = False
    except ExportMismatch:
        ev["refuses_estimator_mismatch"] = True
    return ev


def check(ev: dict) -> list:
    """The checks; returns a list of problems."""
    problems = [f"{flag} is false" for flag in
                ("fp_bit_identical", "param_tree_unchanged",
                 "accuracy_gate_pass", "redteam_gate_fires",
                 "export_bit_equal", "refuses_fp_config",
                 "refuses_estimator_mismatch")
                if not ev.get(flag)]
    if ev.get("burst_lost"):
        problems.append(f"{ev['burst_lost']} burst request(s) lost")
    if ev.get("burst_served", 0) < 8:
        problems.append(f"only {ev.get('burst_served')} of 8 served")
    if ev.get("post_join_builds"):
        problems.append(f"{ev['post_join_builds']} kernel librar(ies) built "
                        "after the join from the store")
    return problems


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", default=None,
                   help="default: a fresh temp dir, removed on success")
    p.add_argument("--num_images", type=int, default=64)
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--check", action="store_true",
                   help="exit non-zero unless every check holds")
    args = p.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="quant_smoke_")
    ev = run_smoke(workdir, args.num_images, args.epochs, args.device)
    problems = check(ev)
    ev["problems"] = problems
    print(json.dumps({"metric": "quant_smoke", "ok": not problems, **ev}),
          flush=True)
    if problems:
        for pr in problems:
            print(f"CHECK FAIL: {pr}")
        return 1 if args.check else 0
    if not args.workdir:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"CHECK OK: fp bit-identical, |quant delta| "
          f"{abs(ev['quant_delta']):.4f} <= {ev['budget']}, red-team delta "
          f"{ev['redteam_delta']:.4f} fired the gate, export round trip "
          f"bit-equal with {ev['post_join_builds']} builds after the join")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
