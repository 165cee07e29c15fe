"""The port's step profiler (``tools/profile_step.py``) and the one-image
K1 forms it runs, held against the JAX package on the CPU.

``make_batch`` gives the JAX tool's arrays; ``nms``, ``nms_mask`` and
``propose`` give the JAX package's keep sets and proposals (indices,
masks, scores and validity exact; rois within 1e-3 px, and each image
bit-equal to its row of the port's batched form); a padded
stem gives the JAX padded model's features (fp32, atol 1e-5) and the
unpadded port model's bit for bit; ``--check`` on the tiny network
passes with the JAX tool's stage names and gauges, in both NMS modes,
with ``--quant`` and with a trace summary; the XLA-only levers raise.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as jgenerate_config
from mx_rcnn_tpu.models import build_model as jbuild_model
from mx_rcnn_tpu.ops.proposal import propose as j_propose
from mx_rcnn_tpu.tools import profile_step as jprofile
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.obs.metrics import registry
from mx_rcnn_tpu_torch.ops import nms as tnms
from mx_rcnn_tpu_torch.ops.proposal import propose, propose_batch
from mx_rcnn_tpu_torch.tools import profile_step
from mx_rcnn_tpu_torch.utils.bridge import from_flax
from tests.test_torch_ops import _nms_case, _proposal_inputs

jnms = importlib.import_module("mx_rcnn_tpu.ops.nms")
torch.set_num_threads(1)
T = torch.from_numpy

# the JAX tool's stage labels (mx_rcnn_tpu/tools/profile_step.py), the
# gauges' slugs follow from them
JAX_STAGES = ("backbone fwd", "backbone fwd+bwd (dummy loss)",
              "proposal (decode+topk+NMS)", "anchor_target",
              "proposal_target", "roi_align",
              "roi head fwd+bwd (dummy loss)", "full loss fwd (no bwd)",
              "full loss fwd+bwd (no update)", "optimizer update",
              "FULL train step (donated)", "sum of pieces (approx)")


@pytest.mark.parametrize("n,h,w,seed,raw", [(2, 64, 96, 0, False),
                                            (1, 80, 48, 3, True),
                                            (3, 32, 32, 7, False)])
def test_make_batch_gives_the_jax_tools_arrays(n, h, w, seed, raw):
    want = jprofile.make_batch(jgenerate_config("tiny", "synthetic"), n, h,
                               w, seed=seed, raw=raw)
    got = profile_step.make_batch(generate_config("tiny", "synthetic"), n,
                                  h, w, seed=seed, raw=raw, device="cpu")
    assert got._fields == want._fields
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt)
        assert g.numpy().dtype == wnt.dtype
        np.testing.assert_array_equal(g.numpy(), wnt)


@pytest.mark.parametrize("name,k,thr", [("random", 256, 0.7),
                                        ("random", 384, 0.5),
                                        ("dense_cluster", 256, 0.3)])
def test_nms_and_nms_mask_match_the_jax_packages(name, k, thr):
    boxes, scores, valid = _nms_case(name, k, seed=k)
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else T(valid)
    want_i, want_v = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), thr,
                              50, valid=jv, tile_size=128, backend="jnp")
    got_i, got_v = tnms.nms(T(boxes), T(scores), thr, 50, valid=tv,
                            tile_size=128)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    want_m = jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), thr,
                           valid=jv, tile_size=128, backend="jnp")
    got_m = tnms.nms_mask(T(boxes), T(scores), thr, valid=tv, tile_size=128)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert np.asarray(want_m).sum() > 3


def test_one_image_forms_of_empty_inputs():
    idx, ok = tnms.nms(torch.zeros((0, 4)), torch.zeros((0,)), 0.7, 5)
    assert idx.shape == (5,) and (idx == -1).all() and not ok.any()
    assert tnms.nms_mask(torch.zeros((0, 4)), torch.zeros((0,)),
                         0.7).shape == (0,)


@pytest.mark.parametrize("seed,exp_free", [(0, False), (1, False),
                                            (2, True)])
def test_propose_matches_the_jax_packages(seed, exp_free):
    """The kept sets and scores exact; rois within 1e-3 px, even without
    ``exp``: XLA compiles the one-image program's decode with other
    roundings than the batched one (1 ulp here), which
    ``tests/test_torch_ops.py`` holds bit for bit.  Each image equals its
    row of the port's batched form bit for bit."""
    scores, deltas, anchors, im_info = _proposal_inputs(seed)
    if exp_free:
        deltas[..., 2:] = 0.0
    kw = dict(pre_nms_top_n=400, post_nms_top_n=60, nms_thresh=0.7,
              min_size=16)
    batched = [x.numpy() for x in propose_batch(
        T(scores), T(deltas), T(anchors), T(im_info), **kw)]
    for i in range(scores.shape[0]):
        want = [np.asarray(x) for x in j_propose(
            jnp.asarray(scores[i]), jnp.asarray(deltas[i]),
            jnp.asarray(anchors), jnp.asarray(im_info[i]), **kw)]
        got = [x.numpy() for x in propose(
            T(scores[i]), T(deltas[i]), T(anchors), T(im_info[i]), **kw)]
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)
        for g, b in zip(got, batched):
            np.testing.assert_array_equal(g, b[i])
        assert want[2].sum() > 10


def test_a_padded_stem_gives_the_jax_models_features():
    jcfg = jgenerate_config("tiny", "synthetic").replace_in(
        "network", stem_channel_pad=4)
    rng = np.random.RandomState(0)
    images = rng.randn(2, 64, 96, 3).astype(np.float32)
    im_info = np.array([[64, 96, 1.0]] * 2, np.float32)
    jmodel = jbuild_model(jcfg)
    variables = jax.device_get(jmodel.init(
        jax.random.PRNGKey(3), jnp.asarray(images[:1]),
        jnp.asarray(im_info[:1])))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(images),
                                   jnp.asarray(im_info),
                                   method=jmodel.features))
    cfg = generate_config("tiny", "synthetic", network__stem_channel_pad=4)
    model = build_model(cfg, "cpu", seed=None)
    model.load_state_dict(from_flax(variables))
    assert model.backbone.conv1.weight.shape[1] == 4
    with torch.no_grad():
        got = model.features(T(images), T(im_info)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the zero channel adds exactly 0: the unpadded model with the first
    # three kernel channels gives the same bits
    plain = build_model(generate_config("tiny", "synthetic"), "cpu",
                        seed=None)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd["backbone.conv1.weight"] = sd["backbone.conv1.weight"][:, :3]
    plain.load_state_dict(sd)
    with torch.no_grad():
        bits = plain.features(T(images), T(im_info)).numpy()
    np.testing.assert_array_equal(got, bits)


def test_a_set_stem_pad_lands_in_the_fingerprint_its_default_does_not():
    from mx_rcnn_tpu_torch.utils.checkpoint import (_fingerprint_repr,
                                                    config_fingerprint)

    cfg = generate_config("tiny", "PascalVOC")
    assert "stem_channel_pad" not in _fingerprint_repr(cfg.network)
    assert _fingerprint_repr(cfg.network) == repr(cfg.network).replace(
        ", stem_channel_pad=0", "")
    padded = cfg.replace_in("network", stem_channel_pad=4)
    assert "stem_channel_pad=4" in _fingerprint_repr(padded.network)
    assert config_fingerprint(cfg) != config_fingerprint(padded)


_TINY = ["--device", "cpu", "--network", "tiny", "--dataset", "synthetic",
         "--shape", "128x160", "--iters", "2"]


@pytest.mark.parametrize("mode,n", [("batched", 2), ("per_image", 2),
                                    ("batched", 1)])
def test_check_on_the_tiny_network_with_the_jax_stage_names(capsys, mode, n):
    registry().reset("profile/")
    rec = profile_step.main(_TINY + ["--batch_images", str(n), "--check",
                                     "--nms_mode", mode])
    out = capsys.readouterr().out
    assert "CHECK OK" in out, out
    assert f"nms={mode}/auto" in out
    assert tuple(rec["stage_ms"]) == JAX_STAGES
    assert all(v == 0 for v in rec["builds"].values())
    # no kernel on the CPU: every launch count is 0
    assert all(not any(c.values()) for c in rec["launches"].values())
    gauges = registry().snapshot()["gauges"]
    for key in ("profile/stage_ms/backbone_fwd",
                "profile/stage_ms/roi_align",
                "profile/stage_ms/proposal_decode_topk_nms",
                "profile/stage_ms/full_train_step_donated",
                "profile/self_check_ratio"):
        assert key in gauges and gauges[key] == gauges[key]


def test_quant_arms_stem_pad_and_trace_summary(tmp_path, capsys):
    rec = profile_step.main(_TINY + ["--batch_images", "1", "--iters", "1",
                                     "--quant", "--pad_stem", "4",
                                     "--prenms", "512",
                                     "--trace_dir", str(tmp_path),
                                     "--trace_summary"])
    out = capsys.readouterr().out
    assert "pre=512" in out
    assert {"inference fwd (fp)", "inference fwd (int8/native)"} <= \
        set(rec["stage_ms"])
    assert rec["trace"]["by_op_class"]
    assert "by stage" in out or "by op class" in out


@pytest.mark.parametrize("flags", [["--roi_backend", "blocked"],
                                   ["--roi_backend", "jnp"],
                                   ["--roi_chunk", "64"],
                                   ["--nms_backend", "pallas"]])
def test_the_xla_only_levers_raise(flags):
    with pytest.raises(SystemExit, match="XLA"):
        profile_step.parse_args(_TINY + flags)
