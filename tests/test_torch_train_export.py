"""The train-step half of the port's export store (``serve/export.py —
export_train_step``, ``load_train_step``) and ``tools/train.py
--export_train_step``, on the CPU in fp32 on the tiny network.

The export verifies the live and the loaded step bit-equal from two
copies of one start state and restores the caller's algorithm settings;
a step through ``load_train_step`` from :func:`train_step_inputs` gives
the recorded digest and the live step's bits, and it matches the JAX
step on the same weights, batch and draws within the train-parity
tolerance ``tests/test_torch_train.py — test_three_train_steps_match_jax``
states (metrics rtol 1e-5, each parameter's change 1e-4 relative L2);
the synthetic batch is the JAX export's; the store refuses another
config, other algorithm settings, a wrong leaf count or spec, a store
without a train step, and more than one device.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.core import train as jtrain
from mx_rcnn_tpu.core.optim import make_optimizer as j_make_optimizer
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.serve import export as jexport
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.train import make_train_step
from mx_rcnn_tpu_torch.serve import export
from mx_rcnn_tpu_torch.serve.export import (TRAIN_STEP, ExportMismatch,
                                            ExportStore, load_train_step,
                                            pinned_algorithms,
                                            train_step_inputs,
                                            train_step_outputs)
from mx_rcnn_tpu_torch.utils.bridge import to_flax

torch.set_num_threads(1)

# the tiny network on the synthetic set's 320x416 bucket, batch 2
# (tests/test_torch_train.py's small recipe)
_SMALL = dict(train__rpn_pre_nms_top_n=600, train__rpn_post_nms_top_n=100,
              train__batch_rois=32, train__batch_images=2)


def _cfg(**kw):
    return generate_config("tiny", "synthetic", **dict(_SMALL, **kw))


def _jax_draws(key, n, step=None):
    """The JAX step's uniforms for the port's ``draws`` (as
    ``tests/test_torch_train.py — _jax_draws`` derives them)."""
    if step is not None:
        key = jax.random.fold_in(key, step)
    k_anchor, k_rcnn = jax.random.split(key)
    anchor_keys = jax.random.split(k_anchor, n)
    k_prop, _ = jax.random.split(k_rcnn)
    prop_keys = jax.random.split(k_prop, n)

    def draws(site, image, shape):
        base = (anchor_keys if site.startswith("anchor") else prop_keys)[image]
        kf, kb = jax.random.split(base)
        u = jax.random.uniform(kf if site.endswith("fg") else kb, shape)
        return torch.from_numpy(np.array(u))

    return draws


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """(root, report) of the tiny recipe's exported train step."""
    root = str(tmp_path_factory.mktemp("train_step") / "store")
    report = export.export_train_step(_cfg(), out_dir=root, device="cpu")
    return root, report


def test_export_verifies_bit_equal_and_records_the_jax_keys(store):
    root, report = store
    assert report["bit_equal"] is True and report["verified"] is True
    assert report["programs"] == [{"name": TRAIN_STEP, "bit_equal": True}]
    m = json.load(open(os.path.join(root, "manifest.json")))
    for key, want in (("train_step", True), ("num_devices", 1),
                      ("grad_accum", 1), ("batch_images", 2),
                      ("algorithms", export.PINNED_ALGORITHMS)):
        assert m[key] == want, key
    entry = m["entries"][TRAIN_STEP]
    assert entry["outputs_sha256"] == report["outputs_sha256"]
    assert entry["static"]["metrics"] == sorted(report["metrics"])
    n_state = entry["static"]["state_leaves"]
    assert len(entry["args"]) == n_state + 5      # the Batch's 5 tensors
    assert entry["args"][n_state][1] == "uint8"   # raw images
    assert m["kernels"] == {} and report["kernels"] == {}   # the CPU's
    assert m["device"]["type"] == "cpu"


def test_export_restores_the_callers_settings(tmp_path):
    mine = {"cudnn_deterministic": False, "cudnn_benchmark": True,
            "cudnn_tf32": True, "matmul_tf32": True}
    was = export.live_algorithms()
    export._set_algorithms(mine)
    try:
        report = export.export_train_step(_cfg(), out_dir=str(tmp_path / "s"),
                                          device="cpu", verify=False)
        assert export.live_algorithms() == mine
    finally:
        export._set_algorithms(was)
    assert report["bit_equal"] is None and "loaded" not in \
        report["launches"]


def test_loaded_step_equals_the_live_step_bit_for_bit(store):
    root, report = store
    cfg = _cfg()
    with pinned_algorithms():
        fn = load_train_step(ExportStore(root), cfg, "cpu")
        state, batch = train_step_inputs(cfg, 0, "cpu")
        state, metrics = fn(state, batch)
        got = train_step_outputs(state, metrics)
        ExportStore(root).require_digest(TRAIN_STEP, got)
        live_state, live_batch = train_step_inputs(cfg, 0, "cpu")
        live_metrics = make_train_step(cfg)(live_state, live_batch)
        assert export._bit_equal(got, train_step_outputs(live_state,
                                                         live_metrics))
    assert state.step == 1
    # a second step from the moved state is not the recorded one
    with pinned_algorithms():
        state, metrics = fn(state, batch)
        with pytest.raises(ExportMismatch, match="sha256"):
            ExportStore(root).require_digest(
                TRAIN_STEP, train_step_outputs(state, metrics))


def test_loaded_step_matches_the_jax_step(store):
    """The loaded step from the exported start state against the JAX step
    from the same (bridged) weights, batch and uniforms."""
    root, _ = store
    cfg = _cfg()
    jcfg = j_generate_config("tiny", "synthetic", **_SMALL)
    key = jax.random.PRNGKey(5)
    with pinned_algorithms():
        fn = load_train_step(ExportStore(root), cfg, "cpu")
        state, batch = train_step_inputs(cfg, 0, "cpu")
        variables = to_flax(state.model.state_dict())
        jmodel = j_build_model(jcfg)
        tx = j_make_optimizer(jcfg, variables["params"],
                              export.TRAIN_STEPS_PER_EPOCH)
        jstate = jtrain.TrainState(jnp.zeros((), jnp.int32),
                                   variables["params"],
                                   variables["batch_stats"],
                                   tx.init(variables["params"]))
        jbatch = jtrain.Batch(*(jnp.asarray(t.numpy()) for t in batch))
        jstate, want = jax.jit(jtrain.make_train_step(jmodel, jcfg, tx))(
            jstate, jbatch, key)
        state, got = fn(state, batch,
                        draws=_jax_draws(key, batch.images.shape[0], step=0))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-5, err_msg=name)
    assert float(got["num_fg"]) > 0
    tparams = to_flax(state.model.state_dict())["params"]
    for path, want_p in jax.tree_util.tree_leaves_with_path(jstate.params):
        start, mine = variables["params"], tparams
        for k in path:
            start, mine = start[k.key], mine[k.key]
        moved = np.asarray(want_p) - start
        err = np.linalg.norm(mine - np.asarray(want_p))
        assert err <= 1e-4 * max(np.linalg.norm(moved), 1e-12), path


def test_synthetic_train_batch_equals_jax():
    jcfg = j_generate_config("tiny", "synthetic", **_SMALL)
    want = jexport._synthetic_train_batch(jcfg, 0)
    got = export._synthetic_train_batch(_cfg(), 0, "cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _refusal(root, case):
    """Run the store's step under one wrong condition."""
    cfg = _cfg()
    if case == "config":
        load_train_step(ExportStore(root), _cfg(train__batch_rois=16), "cpu")
    elif case == "settings":
        load_train_step(ExportStore(root), cfg, "cpu")
    with pinned_algorithms():
        fn = load_train_step(ExportStore(root), cfg, "cpu")
        state, batch = train_step_inputs(cfg, 0, "cpu")
        if case == "leaf_count":
            fn(state, batch[:4])
        elif case == "spec":
            fn(state, batch._replace(images=batch.images[:, :-32]))
        elif case == "settings_at_call":
            torch.backends.cudnn.deterministic = False
            fn(state, batch)


@pytest.mark.parametrize("case,match", [
    ("config", "config fingerprint"),
    ("settings", "exported under"),
    ("settings_at_call", "exported under"),
    ("leaf_count", "leaves"),
    ("spec", "arg"),
])
def test_store_refuses(store, case, match):
    root, _ = store
    was = export.live_algorithms()
    try:
        with pytest.raises(ExportMismatch, match=match):
            _refusal(root, case)
    finally:
        export._set_algorithms(was)


def test_a_store_without_a_train_step_and_other_device_counts(tmp_path):
    cfg = _cfg()
    s = ExportStore.create(str(tmp_path / "serve"), cfg, device="cpu")
    s.finish()
    with pinned_algorithms(), pytest.raises(ExportMismatch, match="no train"):
        load_train_step(ExportStore(str(tmp_path / "serve")), cfg, "cpu")
    with pytest.raises(NotImplementedError):
        export.export_train_step(cfg, out_dir=str(tmp_path / "dp"),
                                 num_devices=2, device="cpu")
    assert not (tmp_path / "dp").exists()


def test_grad_accum_export_round_trips(tmp_path):
    cfg = _cfg()
    root = str(tmp_path / "acc")
    report = export.export_train_step(cfg, out_dir=root, grad_accum=2,
                                      device="cpu")
    assert report["bit_equal"] is True
    with pinned_algorithms():
        fn = load_train_step(ExportStore(root), cfg, "cpu")
        state, batches = train_step_inputs(cfg, 0, "cpu", grad_accum=2)
        assert len(batches) == 2
        state, metrics = fn(state, batches)
        ExportStore(root).require_digest(TRAIN_STEP,
                                         train_step_outputs(state, metrics))


def test_train_cli_exports_and_prints_one_json_line(tmp_path, capsys):
    from mx_rcnn_tpu_torch.tools import train as train_cli

    root = str(tmp_path / "cli")
    report = train_cli.main([
        "--device", "cpu", "--network", "tiny", "--dataset", "synthetic",
        "--batch_images", "2", "--set", "train__rpn_pre_nms_top_n=600",
        "--set", "train__rpn_post_nms_top_n=100", "--set",
        "train__batch_rois=32", "--export_train_step", root])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(
        json.dumps(report))
    assert report["bit_equal"] is True
    # the CLI's recipe is the one the store admits
    with pinned_algorithms():
        load_train_step(ExportStore(root), _cfg(), "cpu")


def test_a_step_that_does_not_repeat_is_never_committed(tmp_path,
                                                         monkeypatch):
    """A loaded step whose bits differ from the live one's (here one
    weight nudged after it) raises and leaves no manifest."""
    real = export._train_step_fn

    def nudged(m, cfg):
        fn = real(m, cfg)

        def run(state, batch, draws=None):
            state, metrics = fn(state, batch, draws)
            with torch.no_grad():
                p = next(state.model.parameters())
                p.copy_(p + 1e-3)
            return state, metrics

        return run

    monkeypatch.setattr(export, "_train_step_fn", nudged)
    root = tmp_path / "bad"
    with pytest.raises(ExportMismatch, match="NOT bit-equal"):
        export.export_train_step(_cfg(), out_dir=str(root), device="cpu")
    assert not (root / "manifest.json").exists()
