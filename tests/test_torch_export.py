"""The port's export store (``serve/export.py``) on the CPU.

A store of the tiny model round-trips: its manifest carries the JAX
manifest's keys that carry over and the port's own (torch and CUDA
versions, the device, each program's input spec and output digest), and
a CPU store bundles no kernel library.  ``check`` refuses each mismatch
the store guards (config fingerprint, buckets, a serving knob, the quant
block either way, torch or CUDA version, device kind, a kernel library
today's sources do not build), lineage behaves as the JAX
``check_lineage`` does on the same manifests, the bundled weights'
``variables_fingerprint`` is the JAX one of the same (bridged) weights
and the JAX store reads them back, ``warm_from_export`` in a spawned
process reproduces every digest and serves what the exporter serves, and
one changed byte in the weights or a digest is refused.  The join's
library install takes the kernel's lock and places a file once.
"""

import json
import multiprocessing
import os
import threading

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.serve import export as jexport
from mx_rcnn_tpu.utils.checkpoint import load_param as j_load_param
from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.core.tester import Predictor, quant_predictor
from mx_rcnn_tpu_torch.serve import export
from mx_rcnn_tpu_torch.serve.engine import ServingEngine
from mx_rcnn_tpu_torch.serve.export import (SERVE_POST, ExportMismatch,
                                            ExportStore,
                                            export_serve_programs,
                                            predictor_variables,
                                            serve_fwd_name)
from mx_rcnn_tpu_torch.tools.loadgen import synthetic_images
from mx_rcnn_tpu_torch.utils.checkpoint import load_model, save_checkpoint
from tests import torch_bulk_workers as w

torch.set_num_threads(1)

_TOY = dict(dataset__num_classes=4, bucket__scale=128, bucket__max_size=160,
            bucket__shapes=((128, 160), (160, 128)),
            test__rpn_pre_nms_top_n=256, test__rpn_post_nms_top_n=32,
            serve__batch_size=2, serve__score_thresh=0.0)


def _cfg(**kw):
    return generate_config("tiny", "synthetic", **dict(_TOY, **kw))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A port checkpoint (the JAX layout) of the tiny model, seeded."""
    tmp = tmp_path_factory.mktemp("export_ckpt")
    prefix = str(tmp / "e2e")
    save_checkpoint(prefix, 1, ttrain.setup_training(_cfg(), "cpu", seed=4))
    return prefix


@pytest.fixture(scope="module")
def store(tmp_path_factory, ckpt):
    """(root, predictor, report) of a committed store with weights."""
    root = str(tmp_path_factory.mktemp("store") / "v1")
    cfg = _cfg()
    pred = Predictor(load_model(cfg, ckpt, 1, "cpu"), cfg, "cpu")
    report = export_serve_programs(pred, cfg, root, bundle_variables=True)
    return root, pred, report


def _edited(tmp_path, root, edit):
    """A copy of the store whose manifest ``edit`` changed."""
    import shutil

    dst = str(tmp_path / "edited")
    shutil.copytree(root, dst)
    path = os.path.join(dst, "manifest.json")
    m = json.load(open(path))
    edit(m)
    with open(path, "w") as f:
        json.dump(m, f)
    return ExportStore(dst)


def test_round_trip_manifest(store):
    root, pred, report = store
    assert report["bit_equal"] is True and report["kernels"] == []
    m = ExportStore(root).manifest()
    for key in ("config_fingerprint", "bucket_shapes", "serve_batch_size",
                "nms_thresh", "serve_score_thresh",
                "num_classes", "quant", "torch_version", "cuda_version",
                "device", "entries", "kernels", "variables",
                "train_fingerprint"):
        assert key in m, key
    assert m["quant"] is None and m["kernels"] == {}
    assert m["device"] == {"type": "cpu", "name": "cpu", "capability": None}
    assert m["torch_version"] == torch.__version__
    assert m["serve_batch_size"] == 2
    assert ExportStore(root).names() == tuple(sorted(
        ["serve_fwd_128x160_b2", "serve_fwd_160x128_b2", SERVE_POST]))
    e = m["entries"][serve_fwd_name((160, 128), 2)]
    assert e["args"] == [[[2, 160, 128, 3], "float32"], [[2, 3], "float32"]]
    assert len(e["outputs_sha256"]) == 64
    assert m["entries"][SERVE_POST]["static"] == {"nms_thresh": 0.3,
                                                  "score_thresh": 0.0}
    assert not os.path.exists(ExportStore(root).cache_dir())
    # the store's forward is the predictor's, and checks its input spec
    fwd = ExportStore(root).load(serve_fwd_name((128, 160), 2), pred)
    images, info = export._dummy_batch((128, 160), 2)
    ExportStore(root).require_digest(serve_fwd_name((128, 160), 2),
                                     fwd(images, info))
    with pytest.raises(ValueError, match="takes"):
        fwd(images[:1], info[:1])
    with pytest.raises(ExportMismatch, match="no program"):
        ExportStore(root).load("serve_fwd_1x1_b2", pred)


@pytest.mark.parametrize("case", [
    "fingerprint", "buckets", "score_thresh", "batch", "nms",
    "quant_store_fp_run", "fp_store_quant_run", "torch", "cuda", "device",
    "kernel_name", "kernel_unknown"])
def test_check_refuses(tmp_path, store, case):
    root, _, _ = store
    cfg, fp, dev = _cfg(), None, "cpu"
    st = ExportStore(root)
    if case == "fingerprint":
        cfg, match = _cfg(train__rpn_batch_size=128), "fingerprint"
    elif case == "buckets":
        cfg, match = _cfg(bucket__shapes=((128, 160),)), "bucket shapes"
    elif case == "score_thresh":
        cfg, match = _cfg(serve__score_thresh=0.05), "serve_score_thresh"
    elif case == "batch":
        cfg, match = _cfg(serve__batch_size=4), "serve_batch_size"
    elif case == "nms":
        cfg, match = _cfg(test__nms=0.5), "nms_thresh"
    elif case == "quant_store_fp_run":
        st = _edited(tmp_path, root, lambda m: m.update(quant={
            "dtype": "int8", "mode": "native", "estimator": "absmax",
            "percentile": 99.9, "weight_bits": 8,
            "calibration_fingerprint": "0" * 16}))
        match = "quant knobs"
    elif case == "fp_store_quant_run":
        cfg, fp, match = _cfg(quant__enabled=True), "0" * 16, "quant knobs"
    elif case == "torch":
        st = _edited(tmp_path, root,
                     lambda m: m.update(torch_version="1.0.0"))
        match = "torch_version"
    elif case == "cuda":
        st = _edited(tmp_path, root, lambda m: m.update(cuda_version="11.8"))
        match = "cuda_version"
    elif case == "device":
        st = _edited(tmp_path, root, lambda m: m.update(device={
            "type": "cuda", "name": "NVIDIA H100 80GB HBM3",
            "capability": [9, 0]}))
        match = "device"
    elif case == "kernel_name":
        st = _edited(tmp_path, root, lambda m: m["kernels"].update(
            nms_sweep={"file": "kernels/libnms_sweep-0123456789abcdef.so",
                       "bytes": 1, "sha256": "0" * 64}))
        match = "not what today's sources build"
    else:
        st = _edited(tmp_path, root, lambda m: m["kernels"].update(
            gone={"file": "kernels/libgone-0.so", "bytes": 1,
                  "sha256": "0" * 64}))
        match = "libgone"
    with pytest.raises(ExportMismatch, match=match):
        st.check(cfg, quant_fingerprint=fp, device=dev)
    ExportStore(root).check(_cfg(), device="cpu")


def test_quantized_store_refuses_fp_and_other_estimators(tmp_path, ckpt):
    """A real quantized store (int8 sim on the CPU: a calibration sweep
    over 4 synthetic images): its own process's check passes; an fp
    config and a percentile-calibrated quant config are refused."""
    cfg = _cfg(quant__enabled=True, quant__calibration_batches=1,
               dataset__root_path=str(tmp_path / "data"),
               dataset__dataset_path=str(tmp_path / "data" / "synthetic"))
    sd = load_model(cfg.replace_in("quant", enabled=False), ckpt, 1,
                    "cpu").state_dict()
    qpred = quant_predictor(cfg, sd, "cpu", synthetic=4)
    root = str(tmp_path / "q")
    report = export_serve_programs(qpred, cfg, root, bundle_variables=True)
    assert report["bit_equal"]
    st = ExportStore(root)
    assert st.manifest()["quant"]["calibration_fingerprint"] == \
        qpred.quant_fingerprint
    assert "quant" in st.load_variables()
    st.check(cfg, quant_fingerprint=qpred.quant_fingerprint, device="cpu")
    with pytest.raises(ExportMismatch, match="quant knobs"):
        st.check(cfg.replace_in("quant", enabled=False), device="cpu")
    pcfg = cfg.replace_in("quant", estimator="percentile")
    ppred = quant_predictor(pcfg, sd, "cpu", synthetic=4)
    with pytest.raises(ExportMismatch, match="quant knobs"):
        st.check(pcfg, quant_fingerprint=ppred.quant_fingerprint,
                 device="cpu")
    # the store's weights rebuild the same quantized predictor
    again = export.predictor_from_variables(st.load_variables(), cfg, "cpu")
    assert again.quant_fingerprint == qpred.quant_fingerprint
    engine = ServingEngine(again, cfg, start=False)
    assert len(engine.warm_from_export(st)["programs"]) == 3


def test_variables_fingerprint_equals_jax_for_bridged_weights(store, ckpt):
    root, pred, _ = store
    params, stats = j_load_param(ckpt, 1)
    jvars = {"params": params, "batch_stats": stats}
    ours = predictor_variables(pred)
    assert sorted(export._flatten_variables(ours)) == sorted(
        jexport._flatten_variables(jvars))
    fp = jexport.variables_fingerprint(jvars)
    assert export.variables_fingerprint(ours) == fp
    assert ExportStore(root).manifest()["train_fingerprint"] == fp
    # the JAX store reads the port's bundled weights to the same identity
    assert jexport.variables_fingerprint(
        jexport.ExportStore(root).load_variables()) == fp
    assert export.variables_fingerprint(
        ExportStore(root).load_variables()) == fp


@pytest.mark.parametrize("known,expect", [
    (None, None), (["p"], None), (["p", "q"], None), (["q"], None),
    (None, "tf"), ([], None)])
@pytest.mark.parametrize("meta", [
    {}, {"version": "v2"}, {"version": "v2", "parent_sha": "p"},
    {"version": "v3", "parent_sha": "p", "train_fingerprint": "tf"}])
def test_lineage_equals_jax(tmp_path, store, meta, known, expect):
    root, _, _ = store

    def edit(m):
        for k in ("version", "parent_sha", "train_fingerprint"):
            m.pop(k, None)
        m.update(meta)

    st = _edited(tmp_path, root, edit)
    js = jexport.ExportStore(st.root)

    def outcome(s, exc):
        try:
            return s.check_lineage(known, expect)
        except exc as e:
            return ("refused", type(e).__name__)

    assert outcome(st, ExportMismatch) == outcome(js, jexport.ExportMismatch)
    assert st.version == js.version and st.parent_sha == js.parent_sha
    assert export.manifest_sha(st.root) == jexport.manifest_sha(st.root)


def test_version_and_parent_record_lineage(tmp_path, store):
    root, pred, _ = store
    child = str(tmp_path / "v2")
    # the store directory from fleet.export_dir
    export_serve_programs(pred, _cfg(fleet__export_dir=child),
                          version="v2", parent=root)
    with pytest.raises(ValueError, match="export_dir"):
        export_serve_programs(pred, _cfg())
    st = ExportStore(child)
    assert st.version == "v2" and st.parent_sha == export.manifest_sha(root)
    assert st.check_lineage([export.manifest_sha(root)])["legacy"] is False
    with pytest.raises(ExportMismatch, match="unknown parent"):
        st.check_lineage(["0" * 64])
    assert ExportStore(root).check_lineage(["x"])["legacy"] is True


def test_warm_from_export_in_a_spawned_process(store):
    root, pred, _ = store
    cfg = _cfg()
    img = synthetic_images(cfg, 1, seed=2)[0]
    engine = ServingEngine(pred, cfg)
    try:
        join = engine.warm_from_export(ExportStore(root))
        want = engine.detect(img, timeout_ms=0)
    finally:
        engine.close()
    assert join["programs"] == [serve_fwd_name((128, 160), 2), SERVE_POST,
                                serve_fwd_name((160, 128), 2)]
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe()
    p = ctx.Process(target=w.warm_child, args=(root, _TOY, img, child))
    p.start()
    got_join, got = parent.recv()
    p.join(120)
    assert p.exitcode == 0, got
    assert got_join["programs"] == join["programs"]
    assert got_join["load_events_after"] == {"builds": 0, "loads": 0}
    assert got_join["export_root"] == root
    assert sorted(got) == sorted(want) and want
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])


def test_changed_weights_or_digest_are_refused(tmp_path, store):
    import shutil

    root, pred, _ = store
    cfg = _cfg()
    bad = str(tmp_path / "bad_weights")
    shutil.copytree(root, bad)
    path = os.path.join(bad, export.VARIABLES_NAME)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 1
    open(path, "wb").write(bytes(blob))
    with pytest.raises(ExportMismatch, match="corrupt"):
        ExportStore(bad).load_variables()
    os.unlink(path)
    with pytest.raises(ExportMismatch, match="missing"):
        ExportStore(bad).load_variables()

    name = serve_fwd_name((160, 128), 2)

    def flip(m):
        d = m["entries"][name]["outputs_sha256"]
        m["entries"][name]["outputs_sha256"] = ("0" if d[0] != "0"
                                                else "1") + d[1:]

    engine = ServingEngine(pred, cfg, start=False)
    with pytest.raises(ExportMismatch, match="does not compute"):
        engine.warm_from_export(_edited(tmp_path, root, flip))
    # a kernel library whose bytes changed never reaches _build/
    lib = kernels.NMS_SWEEP.library_path()

    def bundle(m):
        m["kernels"]["nms_sweep"] = {"file": f"kernels/{lib.name}",
                                     "bytes": 3, "sha256": "0" * 64}

    os.makedirs(tmp_path / "k", exist_ok=True)
    st = _edited(tmp_path / "k", root, bundle)
    os.makedirs(os.path.join(st.root, "kernels"), exist_ok=True)
    open(os.path.join(st.root, "kernels", lib.name), "wb").write(b"abc")
    st.check(cfg, device="cpu")
    with pytest.raises(ExportMismatch, match="corrupt"):
        st.install_kernels()
    assert not lib.exists()


def test_a_store_that_runs_two_ways_is_never_committed(tmp_path, store):
    _, pred, _ = store
    calls = []
    raw = pred.raw

    def drifting(images, im_info):
        out = raw(images, im_info)
        calls.append(1)
        if len(calls) == 2:   # the verify run of the first program
            out = (out[0] + 1,) + tuple(out[1:])
        return out

    pred.raw = drifting
    try:
        with pytest.raises(ExportMismatch, match="refusing to commit"):
            export_serve_programs(pred, _cfg(), str(tmp_path / "s"))
    finally:
        del pred.raw
    assert not os.path.exists(tmp_path / "s" / "manifest.json")


def test_install_takes_the_kernel_lock_and_places_once(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    k = kernels.CudaKernel("probe", "nms_sweep.cu", "x", [], replaces="-")
    loads = []
    monkeypatch.setattr(k, "_load", lambda: loads.append(1) or "fn")
    placed = []
    barrier = threading.Barrier(4)

    def go():
        barrier.wait()
        placed.append(k.install(b"library bytes"))

    threads = [threading.Thread(target=go) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(placed) == [False, False, False, True]
    assert loads == [1] and k.fn() == "fn"
    assert k.library_path().read_bytes() == b"library bytes"
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [
        k.library_path().name]
