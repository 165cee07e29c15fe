"""The port's quantized inference held against the JAX package.

The same numpy-seeded inputs go through ``mx_rcnn_tpu/ops/quant.py`` and
``mx_rcnn_tpu_torch/ops/quant.py`` (the plain versions: on the CPU the
wrappers never reach K4-K6), then through both packages' quantized
models with the same weights and the same calibrated scales, carried by
``utils/bridge.py``.

Tolerances:

* quantizers: bytes equal (int8 and e4m3), units equal;
* int8 ``qconv``/``qdot``: bit-equal to JAX ``native`` (an exact integer
  sum either way) and to ``sim`` at tile-level sizes (every fp32 partial
  sum of integers below 2^24 is exact in any order);
* fp8: the JAX CPU program sums the e4m3 products in fp32 in its own
  order, the port in float64 rounded once, so each output may differ by
  K * 2^-24 of the sum of the |products| (K the contraction depth),
  scaled by the units;
* whole models in fp32: the int8 backbone features are bit-equal
  (integer convolutions, the same elementwise fp32 steps), the fp8 ones
  within 1e-3 of their largest magnitude (the fp8 bound, compounded
  through the layers, moves a few activations a step); the head on
  the same pooled features differs only through the fp32 ``cls_score``
  / ``bbox_pred`` dense layers and the spatial mean (summation order,
  atol = rtol = 1e-5).  The full forward adds the RPN's fp32
  convolution, whose summation order differs as in
  ``test_torch_model.py``; the rois then move by ~1e-2 px, and the
  head's input quantization may round a few values to the neighbouring
  step, each moving an output by one step times a weight: rois are held
  at atol 0.1 px, ``cls_prob`` at atol 5e-3, the deltas at atol 0.2
  (observed: 0.025 px, 1e-3, 0.055 on the shallow ResNet);
* calibrated scales: rtol 1e-5 (the fp32 forwards' summation order
  moves an absmax by an ulp or two).
"""

import contextlib
import dataclasses
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mx_rcnn_tpu.models.resnet as j_resnet
import mx_rcnn_tpu_torch.models.resnet as t_resnet
from mx_rcnn_tpu.config import QuantConfig as JQuantConfig
from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.core import tester as jtester
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.ops import quant as jq
from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.config import QuantConfig, generate_config
from mx_rcnn_tpu_torch.core import tester as ttester
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.models.layers import (Conv2dSame, Dense,
                                             QuantConv2dSame, QuantDense,
                                             conv, dense)
from mx_rcnn_tpu_torch.ops import quant as tq
from mx_rcnn_tpu_torch.utils.bridge import (from_flax, load_quant,
                                            load_quant_stats, quant_to_flax,
                                            quant_stats_to_flax, to_flax)
from mx_rcnn_tpu_torch.utils.checkpoint import save_params

torch.set_num_threads(1)

T = torch.from_numpy

SPECS = [("int8", 8), ("int8", 4), ("int8", 2), ("fp8", 8)]


def _bytes(q):
    """A quantized array or tensor as comparable numpy values."""
    if torch.is_tensor(q):
        return (q.view(torch.uint8) if q.dtype == torch.float8_e4m3fn
                else q).numpy()
    q = np.asarray(q)
    return q.view(np.uint8) if q.dtype.itemsize == 1 and \
        q.dtype != np.int8 else q


def _act_input(rng, spec_j, est):
    """Activations with exact ties (quotients k + 0.5) and values beyond
    +-qmax * unit, the unit a power of two."""
    unit = np.float32(est) / np.float32(spec_j.qmax)
    x = (rng.randn(3, 5, 7, 16) * est * 0.5).astype(np.float32)
    flat = x.reshape(-1)
    ties = (np.arange(-12, 12) + 0.5).astype(np.float32) * unit
    flat[:ties.size] = ties
    flat[ties.size:ties.size + 6] = np.array(
        [-3, -2, -1.01, 1.01, 2, 3], np.float32) * est
    return x


# ---- quantizers -------------------------------------------------------------

@pytest.mark.parametrize("mode", ["native", "sim"])
@pytest.mark.parametrize("dtype,bits", SPECS)
def test_quantize_act_and_fake_quant_equal_jax(dtype, bits, mode):
    rng = np.random.RandomState(bits)
    js = jq.QuantSpec(dtype=dtype, weight_bits=bits, mode=mode)
    ts = tq.QuantSpec(dtype=dtype, weight_bits=bits, mode=mode)
    est = np.float32(js.qmax * 2.0 ** -4)
    x = _act_input(rng, js, est)
    qj, uj = jq.quantize_act(jnp.asarray(x), jnp.asarray(est), js)
    qt, ut = tq.quantize_act(T(x), torch.tensor(est), ts)
    assert str(qt.dtype).split(".")[-1].startswith(
        {"int8": "int8" if mode == "native" else "float32",
         "fp8": "float8_e4m3fn"}[dtype])
    np.testing.assert_array_equal(_bytes(qt), _bytes(qj))
    assert np.float32(ut) == np.float32(uj)
    np.testing.assert_array_equal(
        tq.fake_quant(T(x), torch.tensor(est), ts).numpy(),
        np.asarray(jq.fake_quant(jnp.asarray(x), jnp.asarray(est), js)))


@pytest.mark.parametrize("layout", ["conv", "dense"])
@pytest.mark.parametrize("dtype,bits", SPECS)
def test_quantize_weight_equals_jax(dtype, bits, layout):
    """Per output channel: torch's OIHW / (out, in) against flax's HWIO /
    (in, out); a zero channel takes the 1e-12 floor."""
    rng = np.random.RandomState(10 + bits)
    js = jq.QuantSpec(dtype=dtype, weight_bits=bits)
    ts = tq.QuantSpec(dtype=dtype, weight_bits=bits)
    shape = (12, 8, 3, 3) if layout == "conv" else (12, 40)
    w = (rng.randn(*shape) * np.linspace(0.1, 3, 12).reshape(
        (12,) + (1,) * (len(shape) - 1))).astype(np.float32)
    w[3] = 0.0
    to_flax_layout = ((2, 3, 1, 0) if layout == "conv" else (1, 0))
    qj, uj = jq.quantize_weight(jnp.asarray(w.transpose(to_flax_layout)), js)
    qt, ut = tq.quantize_weight(T(w), ts)
    np.testing.assert_array_equal(_bytes(qt).transpose(to_flax_layout),
                                  _bytes(qj))
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    assert (_bytes(qt)[3] == 0).all()


# ---- the contractions -------------------------------------------------------

# (kernel, stride, cin, h, w): 1/3/5/7 kernels, strides 1, 2 and 4, C_in 3
# (conv0's 147-deep contraction), odd extents with flax's asymmetric pads
CONV_CASES = [(7, 2, 3, 20, 26), (3, 1, 8, 9, 11), (1, 1, 16, 6, 5),
              (1, 2, 16, 10, 12), (3, 2, 16, 13, 14), (3, 2, 8, 12, 16),
              (5, 4, 3, 17, 21)]


def _conv_operands(case, seed):
    k, s, c, h, w = case
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, h, w, c) * 2).astype(np.float32)
    wt = rng.randn(12, c, k, k).astype(np.float32)
    return x, wt, np.float32(np.abs(x).max() * 0.8)


@pytest.mark.parametrize("mode", ["native", "sim"])
@pytest.mark.parametrize("case", CONV_CASES)
def test_int8_qconv_bit_equal_to_jax(case, mode):
    k, s = case[:2]
    x, wt, est = _conv_operands(case, sum(case))
    yj = np.asarray(jq.qconv(jnp.asarray(x),
                             jnp.asarray(wt.transpose(2, 3, 1, 0)),
                             jnp.asarray(est), jq.QuantSpec(mode=mode),
                             (s, s), "SAME"))
    yt = tq.qconv(T(x), T(wt), torch.tensor(est), tq.QuantSpec(mode=mode),
                  (s, s), "SAME").numpy()
    assert yt.dtype == np.float32 and yt.shape == yj.shape
    np.testing.assert_array_equal(yt, yj)


@pytest.mark.parametrize("mode", ["native", "sim"])
@pytest.mark.parametrize("k", [64, 147, 1568])
def test_int8_qdot_bit_equal_to_jax(k, mode):
    """K = 64 is the JAX package's tile-level pin; 147 and 1568 (the tiny
    head's fc) stay exact in fp32 for sim as well (sums < 2^24)."""
    rng = np.random.RandomState(k)
    x = (rng.randn(5, k) * 3).astype(np.float32)
    w = rng.randn(7, k).astype(np.float32)
    est = np.float32(np.abs(x).max())
    yj = np.asarray(jq.qdot(jnp.asarray(x), jnp.asarray(w.T),
                            jnp.asarray(est), jq.QuantSpec(mode=mode)))
    yt = tq.qdot(T(x), T(w), torch.tensor(est),
                 tq.QuantSpec(mode=mode)).numpy()
    np.testing.assert_array_equal(yt, yj)


def _fp8_bound(qx, qw, scale, conv=None):
    """K * 2^-24 of the sum of |products|, times the units' product."""
    ax, aw = qx.to(torch.float64).abs(), qw.to(torch.float64).abs()
    total = tq._conv_nhwc(ax, aw, *conv) if conv else ax @ aw.t()
    depth = qw[0].numel()
    return (depth * 2.0 ** -24 * total * scale.double().abs()).numpy()


@pytest.mark.parametrize("case", CONV_CASES)
def test_fp8_qconv_within_bound_of_jax(case):
    k, s = case[:2]
    x, wt, est = _conv_operands(case, 3 * sum(case))
    spec_t = tq.QuantSpec(dtype="fp8")
    yj = np.asarray(jq.qconv(jnp.asarray(x),
                             jnp.asarray(wt.transpose(2, 3, 1, 0)),
                             jnp.asarray(est), jq.QuantSpec(dtype="fp8"),
                             (s, s), "SAME"))
    yt = tq.qconv(T(x), T(wt), torch.tensor(est), spec_t, (s, s),
                  "SAME").numpy()
    qx, xu = tq.quantize_act(T(x), torch.tensor(est), spec_t)
    qw, wu = tq.quantize_weight(T(wt), spec_t)
    pads = tq._explicit_pads("SAME", x.shape[1], x.shape[2], k, k, (s, s))
    allow = _fp8_bound(qx, qw, xu * wu, ((s, s), pads))
    assert (np.abs(yt.astype(np.float64) - yj) <= allow + 1e-30).all()


def test_fp8_qdot_within_bound_of_jax():
    rng = np.random.RandomState(5)
    x = (rng.randn(6, 1568) * 3).astype(np.float32)
    w = rng.randn(9, 1568).astype(np.float32)
    est = np.float32(np.abs(x).max())
    spec_t = tq.QuantSpec(dtype="fp8")
    yj = np.asarray(jq.qdot(jnp.asarray(x), jnp.asarray(w.T),
                            jnp.asarray(est), jq.QuantSpec(dtype="fp8")))
    yt = tq.qdot(T(x), T(w), torch.tensor(est), spec_t).numpy()
    qx, xu = tq.quantize_act(T(x), torch.tensor(est), spec_t)
    qw, wu = tq.quantize_weight(T(w), spec_t)
    allow = _fp8_bound(qx, qw, xu * wu)
    assert (np.abs(yt.astype(np.float64) - yj) <= allow + 1e-30).all()


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_packed_rows_are_the_nhwc_taps_zero_padded(dtype):
    """K5/K6's weight rows: (kh, kw, cin) order, the tail past K zero."""
    rng = np.random.RandomState(0)
    spec = tq.QuantSpec(dtype=dtype)
    qw, _ = tq.quantize_weight(T(rng.randn(5, 3, 7, 7).astype(np.float32)),
                               spec)
    packed = tq.pack_weight(qw)
    assert packed.shape == (5, 160) and packed.dtype == qw.dtype
    rows = _bytes(packed)
    np.testing.assert_array_equal(
        rows[:, :147], _bytes(qw).transpose(0, 2, 3, 1).reshape(5, 147))
    assert (rows[:, 147:] == 0).all()


def test_cuda_wrappers_refuse_cpu_tensors_and_count_nothing():
    kernels.reset_launch_counts()
    x = torch.randn(1, 4, 4, 16)
    spec = tq.QuantSpec()
    tq.qconv(x, torch.randn(8, 16, 3, 3), x.abs().max(), spec, (1, 1),
             "SAME")
    assert kernels.launch_counts() == {k.name: 0 for k in kernels.KERNELS}
    with pytest.raises(ValueError, match="CUDA"):
        tq.quantize_act_cuda(x, x.abs().max(), spec)
    q, u = tq.quantize_act(x, x.abs().max(), spec)
    with pytest.raises(ValueError, match="CUDA"):
        tq.qconv_cuda(q, tq.pack_weight(q.new_zeros(8, 3, 3, 16)), u,
                      torch.ones(8), None, torch.float32, (3, 3), (1, 1),
                      ((1, 1), (1, 1)))
    assert kernels.QCONV_S8.replaces == "mx_rcnn_tpu/ops/quant.py:179"


# ---- the recipe and its refusals -------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(dtype="int4"), dict(mode="fake"), dict(estimator="minmax"),
    dict(weight_bits=1), dict(weight_bits=9), dict(phase="train"),
    dict(dtype="fp8", weight_bits=2)])
def test_quant_spec_refuses_like_jax(kw):
    with pytest.raises(ValueError) as jerr:
        jq.QuantSpec(**kw)
    with pytest.raises(ValueError) as terr:
        tq.QuantSpec(**kw)
    assert str(terr.value) == str(jerr.value)


def test_quant_config_and_spec_from_config_match_jax():
    ours = [(f.name, f.default) for f in dataclasses.fields(QuantConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JQuantConfig)]
    assert ours == theirs
    cfg = generate_config("resnet101", "PascalVOC", **{
        "quant__enabled": "true", "quant__dtype": "fp8",
        "quant__percentile": "99"})
    assert cfg.quant.enabled is True and cfg.quant.percentile == 99.0
    spec = tq.spec_from_config(cfg.quant, "calib")
    jspec = jq.spec_from_config(cfg.quant, "calib")
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert spec.qmax == jspec.qmax == 448.0
    # outside the config fingerprint, as in the JAX package
    from mx_rcnn_tpu_torch.utils.checkpoint import config_fingerprint
    assert config_fingerprint(cfg) == config_fingerprint(
        generate_config("resnet101", "PascalVOC"))
    assert tq.quant_program_tag(cfg.quant, "ab") == \
        jq.quant_program_tag(cfg.quant, "ab")
    assert tq.quant_manifest_meta(cfg.quant, "ab") == \
        jq.quant_manifest_meta(cfg.quant, "ab")


# ---- calibration ------------------------------------------------------------

def _jnp_percentile(x, q):
    """``jnp.percentile`` as the JAX calibration sweep runs it: inside a
    jit, with the percentile a constant, so its index arithmetic folds in
    order, (q / 100) * (n - 1) in fp32 (called eagerly, XLA rewrites it
    as q * ((n - 1) / 100), which rounds differently)."""
    return np.float32(jax.jit(lambda a: jnp.percentile(a, q))(
        jnp.asarray(x)))


@pytest.mark.parametrize("n,q", [(1, 99.9), (7, 50.0), (1000, 99.9),
                                 (1001, 0.0), (4097, 100.0), (65537, 99.0)])
def test_percentile_equals_jnp(n, q):
    x = np.abs(np.random.RandomState(n).randn(n)).astype(np.float32)
    assert np.float32(tq.percentile(T(x), q)) == _jnp_percentile(x, q)


def test_percentile_over_2_to_the_24_equals_jnp():
    """torch.quantile refuses this size; the sort does not."""
    n = 2 ** 24 + 3
    x = np.abs(np.random.RandomState(1).randn(n)).astype(np.float32)
    assert np.float32(tq.percentile(T(x), 99.9)) == _jnp_percentile(x, 99.9)


def test_record_act_stats_equals_jax():
    rng = np.random.RandomState(2)
    spec = tq.QuantSpec(percentile=97.5)
    stats = tq.new_act_stats("cpu")

    class Var:
            value = None

    @jax.jit
    def sweep(carry, x):   # jitted, as the JAX calibration sweep is
        amax, psum, pcnt = Var(), Var(), Var()
        amax.value, psum.value, pcnt.value = carry
        jq.record_act_stats(amax, psum, pcnt, x,
                            jq.QuantSpec(percentile=97.5))
        return amax.value, psum.value, pcnt.value

    carry = (jnp.zeros((), jnp.float32),) * 3
    for i in range(3):
        x = (rng.randn(2, 6, 7, 5) * (i + 1)).astype(np.float32)
        tq.record_act_stats(stats, T(x), spec)
        carry = sweep(carry, jnp.asarray(x))
    for key, val in zip(("amax", "psum", "pcnt"), carry):
        assert np.float32(stats[key]) == np.float32(val), key


def _stats_tree(seed):
    rng = np.random.RandomState(seed)
    node = lambda: {"amax": np.float32(rng.rand() * 9),
                    "psum": np.float32(rng.rand() * 20),
                    "pcnt": np.float32(rng.randint(1, 4))}
    return {"backbone": {"conv0": node(),
                         "stage1_unit1": {"conv1": node(), "sc": node()}},
            "head": {"fc6": node(), "fc7": node()}}


@pytest.mark.parametrize("estimator", ["absmax", "percentile"])
def test_finalize_and_fingerprint_equal_jax(estimator):
    stats = _stats_tree(3)
    qcfg = QuantConfig(enabled=True, estimator=estimator)
    ours = tq.finalize_calibration(stats, qcfg)
    theirs = jax.tree_util.tree_map(
        np.asarray, jq.finalize_calibration(
            jax.tree_util.tree_map(jnp.asarray, stats), qcfg))
    assert jax.tree_util.tree_structure(ours) == \
        jax.tree_util.tree_structure(theirs)
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(theirs)):
        assert np.asarray(a, np.float32).tobytes() == \
            np.asarray(b, np.float32).tobytes()
    fp = tq.calibration_fingerprint(ours, qcfg)
    assert re.fullmatch(r"[0-9a-f]{16}", fp)
    assert fp == jq.calibration_fingerprint(theirs, qcfg)
    assert tq.calibration_fingerprint(
        ours, dataclasses.replace(qcfg, weight_bits=4)) != fp


# ---- layers and the bridge --------------------------------------------------

def test_quant_none_is_the_unchanged_fp_layer():
    assert type(conv(3, 8, 3, quant=None)) is Conv2dSame
    assert type(dense(8, 4, quant=None)) is Dense
    model = build_model(generate_config("tiny", "synthetic"), "cpu", 0)
    assert not any(isinstance(m, (QuantConv2dSame, QuantDense))
                   for m in model.modules())
    assert model.backbone.conv1.weight.dtype == torch.float32
    rn = build_model(generate_config("resnet101", "PascalVOC"), "cpu", None)
    assert rn.backbone.conv0.weight.dtype == torch.bfloat16


@pytest.mark.parametrize("network", ["tiny", "resnet101", "vgg"])
def test_quantized_model_has_the_fp_parameters(network):
    """Names and shapes equal: an fp32 checkpoint loads unchanged; the
    quantized layers keep fp32 weights (they are quantized from fp32);
    104 quantized convolutions in ResNet-101, 13 convs and fc6/fc7 in
    VGG16, conv1/conv2/fc in tiny."""
    ds = "synthetic" if network == "tiny" else "PascalVOC"
    cfg = generate_config(network, ds)
    fp = build_model(cfg, "cpu", None).state_dict()
    qmodel = build_model(cfg.replace_in("quant", enabled=True), "cpu", None)
    q = qmodel.state_dict()
    assert {k: tuple(v.shape) for k, v in fp.items()} == \
        {k: tuple(v.shape) for k, v in q.items()}
    layers = [(n, m) for n, m in qmodel.named_modules()
              if isinstance(m, (QuantConv2dSame, QuantDense))]
    assert len(layers) == {"tiny": 3, "resnet101": 104, "vgg": 15}[network]
    assert all(m.weight.dtype == torch.float32 for _, m in layers)
    assert not any(n.startswith(("rpn", "cls_score", "bbox_pred"))
                   for n, _ in layers)


def test_build_model_refuses_a_quantized_training_model():
    cfg = generate_config("tiny", "synthetic", quant__enabled=True)
    with pytest.raises(ValueError, match="inference-only"):
        build_model(cfg, "cpu", 0, train=True)


def test_quant_collections_round_trip_through_the_bridge():
    cfg = generate_config("tiny", "synthetic", quant__enabled=True)
    model = build_model(cfg, "cpu", 0)
    col = {"backbone": {"conv1": {"act_scale": np.float32(3.5)},
                        "conv2": {"act_scale": np.float32(0.25)}},
           "head": {"fc": {"act_scale": np.float32(7.0)}}}
    load_quant(model, col)
    assert quant_to_flax(model) == col
    with pytest.raises(ValueError, match="does not cover"):
        load_quant(model, {"backbone": col["backbone"]})
    calib = build_model(cfg, "cpu", 0, quant_phase="calib")
    stats = _stats_tree(1)
    stats = {"backbone": {"conv1": stats["backbone"]["conv0"],
                          "conv2": stats["head"]["fc6"]},
             "head": {"fc": stats["head"]["fc7"]}}
    load_quant_stats(calib, stats)
    back = quant_stats_to_flax(calib)
    assert jax.tree_util.tree_map(np.float32, back) == \
        jax.tree_util.tree_map(np.float32, stats)


# ---- whole models -----------------------------------------------------------

_OVER = dict(test__rpn_pre_nms_top_n=256, test__rpn_post_nms_top_n=32,
             network__compute_dtype="float32")
_HW = (128, 160)


def _images(seed, n=2):
    rng = np.random.RandomState(seed)
    h, w = _HW
    return ((rng.rand(n, h, w, 3) * 255).astype(np.float32),
            np.tile(np.array([h, w, 1.0], np.float32), (n, 1)))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def shallow_resnet():
    """ResNet-101's layout with one unit per stage in both packages."""
    saved = (j_resnet.STAGE_UNITS[101], t_resnet.STAGE_UNITS[101])
    j_resnet.STAGE_UNITS[101] = t_resnet.STAGE_UNITS[101] = (1, 1, 1, 1)
    yield
    j_resnet.STAGE_UNITS[101], t_resnet.STAGE_UNITS[101] = saved


def _case(network, **quant):
    ds = "synthetic" if network == "tiny" else "PascalVOC"
    over = dict(_OVER, quant__enabled=True,
                **{f"quant__{k}": v for k, v in quant.items()})
    jcfg = j_generate_config(network, ds, **over)
    tcfg = generate_config(network, ds, **over)
    model = build_model(tcfg.replace_in("quant", enabled=False), "cpu", 0,
                        train=True)
    variables = to_flax(model.state_dict())
    # every quantized kernel non-zero: ResNet's conv3 starts at zero
    rng = np.random.RandomState(1)
    for path, arr in list(_leaves(variables["params"])):
        if path[-1] == "kernel" and "conv3" in path:
            node = variables["params"]
            for key in path[:-1]:
                node = node[key]
            node["kernel"] = (rng.standard_normal(arr.shape) * 0.5
                              / np.sqrt(arr.shape[2])).astype(np.float32)
    return jcfg, tcfg, variables


def _jax_quant(jcfg, variables, batches):
    return jax.tree_util.tree_map(np.asarray, jtester.calibrate_quant(
        jcfg, variables["params"], variables["batch_stats"],
        batches=batches))


def _port_model(tcfg, variables, quant_col):
    model = build_model(tcfg, "cpu", None)
    model.load_state_dict(from_flax(variables))
    load_quant(model, quant_col)
    return model


def _compare_scales(ours, theirs):
    a, b = dict(_leaves(ours)), dict(_leaves(theirs))
    assert a.keys() == b.keys() and a
    for k in a:
        np.testing.assert_allclose(np.float32(a[k]), np.float32(b[k]),
                                   rtol=1e-5, err_msg=str(k))


@pytest.mark.parametrize("network,quant", [
    ("tiny", dict()), ("tiny", dict(mode="sim")),
    ("tiny", dict(dtype="fp8", estimator="percentile")),
    ("resnet101", dict()), ("resnet101", dict(dtype="fp8"))])
def test_quantized_forward_equals_jax(network, quant, shallow_resnet):
    """The JAX-calibrated scales through the bridge: backbone features
    bit-equal, the head on the same pooled features within fp32
    summation, the full forward within the module's stated tolerance;
    the port's own sweep gives the JAX scales and fingerprint inputs."""
    jcfg, tcfg, variables = _case(network, **quant)
    batches = [_images(0), _images(1)]
    qcol = _jax_quant(jcfg, variables, batches)
    _compare_scales(ttester.calibrate_quant(tcfg, from_flax(variables), "cpu",
                                            batches=batches), qcol)
    model = _port_model(tcfg, variables, qcol)
    jmodel = j_build_model(jcfg)
    jvars = {**variables, "quant": qcol}
    images, im_info = _images(5)
    jfeat = np.asarray(jmodel.apply(jvars, jnp.asarray(images),
                                    jnp.asarray(im_info),
                                    method=jmodel.features))
    with torch.inference_mode():
        tfeat = model.features(T(images), T(im_info)).numpy()
    if tcfg.quant.dtype == "int8":
        np.testing.assert_array_equal(tfeat, jfeat)
    else:
        # e4m3 sums in another order (the fp8 bound above, layer after
        # layer): a few activations move to a neighbouring step
        np.testing.assert_allclose(tfeat, jfeat, rtol=0,
                                   atol=1e-3 * np.abs(jfeat).max())

    pooled = (np.random.RandomState(3).randn(
        6, *tcfg.network.rcnn_pooled_size, tfeat.shape[-1]) * 3
              ).astype(np.float32)
    jhead = jax.device_get(jmodel.apply(jvars, jnp.asarray(pooled),
                                        method=jmodel.roi_head))
    with torch.inference_mode():
        thead = model.roi_head(T(pooled))
    for t, j in zip(thead, jhead):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)

    jout = [np.asarray(o) for o in jax.device_get(jmodel.apply(
        jvars, jnp.asarray(images), jnp.asarray(im_info)))]
    with torch.inference_mode():
        tout = [t.numpy() for t in model(T(images), T(im_info))]
    np.testing.assert_array_equal(tout[1], jout[1])
    assert jout[1].sum() > 0
    np.testing.assert_allclose(tout[0], jout[0], rtol=0, atol=0.1)
    np.testing.assert_allclose(tout[2], jout[2], rtol=0, atol=5e-3)
    np.testing.assert_allclose(tout[3], jout[3], rtol=0, atol=0.2)

    pred = ttester.Predictor(model, tcfg, "cpu")
    assert pred.quant_fingerprint == jq.calibration_fingerprint(
        qcol, jcfg.quant)
    assert pred.program_tag == jq.quant_program_tag(jcfg.quant,
                                                    pred.quant_fingerprint)


def test_quantized_vgg16_features_equal_jax():
    """The quantized VGG16 as a whole at a 128x160 canvas: the port's
    own calibration sweep gives the JAX scales (its 13 convolutions at
    rtol 1e-5; fc6/fc7 within 1e-3, below), and with the JAX-calibrated
    scales through the bridge the int8 features are bit-equal (every
    convolution an exact integer sum, the same fp32 rescale, bias and
    ReLU)."""
    jcfg, tcfg, variables = _case("vgg")
    batches = [_images(0, n=1)]
    qcol = jax.tree_util.tree_map(np.asarray, jtester.calibrate_quant(
        jcfg, variables["params"], variables.get("batch_stats", {}),
        batches=batches))
    ours = ttester.calibrate_quant(tcfg, from_flax(variables), "cpu",
                                   batches=batches)
    _compare_scales(ours["backbone"], qcol["backbone"])
    # fc6 reads ROIAlign of the proposals, which the RPN's fp32
    # convolution moves by ~1e-2 px (the module's stated tolerance): its
    # absmax moves by ~1e-4 of itself, and fc7's with it
    a, b = dict(_leaves(ours["head"])), dict(_leaves(qcol["head"]))
    assert a.keys() == b.keys() == {("fc6", "act_scale"), ("fc7", "act_scale")}
    for k in a:
        np.testing.assert_allclose(np.float32(a[k]), np.float32(b[k]),
                                   rtol=1e-3, err_msg=str(k))
    model = _port_model(tcfg, variables, qcol)
    jmodel = j_build_model(jcfg)
    images, im_info = _images(5, n=1)
    jfeat = np.asarray(jmodel.apply({**variables, "quant": qcol},
                                    jnp.asarray(images), jnp.asarray(im_info),
                                    method=jmodel.features))
    with torch.inference_mode():
        tfeat = model.features(T(images), T(im_info)).numpy()
    assert tfeat.shape == (1, 8, 10, 512) and np.abs(tfeat).max() > 0
    np.testing.assert_array_equal(tfeat, jfeat)


def test_calibration_batches_equal_jax(tmp_path):
    over = dict(test__batch_images=2, quant__calibration_batches=2,
                quant__calibration_seed=3,
                dataset__root_path=str(tmp_path),
                dataset__dataset_path=str(tmp_path / "synthetic"),
                bucket__scale=128, bucket__max_size=160,
                bucket__shapes=((128, 160), (160, 128)))
    jb = jtester.calibration_batches(
        j_generate_config("tiny", "synthetic", **over), {"num_images": 9})
    tb = ttester.calibration_batches(
        generate_config("tiny", "synthetic", **over), {"num_images": 9})
    assert len(tb) == len(jb) == 2
    for (ti, tinfo), (ji, jinfo) in zip(tb, jb):
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_array_equal(tinfo, np.asarray(jinfo))


def test_uncalibrated_quantized_predictor_refuses():
    cfg = generate_config("tiny", "synthetic", quant__enabled=True)
    with pytest.raises(ValueError, match="calibrate first"):
        ttester.Predictor(build_model(cfg, "cpu", 0), cfg, "cpu")
    with pytest.raises(ValueError, match="not the quantized"):
        ttester.Predictor(build_model(cfg.replace_in(
            "quant", enabled=False), "cpu", 0), cfg, "cpu")
    with pytest.raises(ValueError, match="not the quantized"):
        ttester.Predictor(build_model(cfg, "cpu", 0, quant_phase="calib"),
                          cfg, "cpu")
    with pytest.raises(RuntimeError, match="calibrate first"):
        build_model(cfg, "cpu", 0).backbone.conv1(torch.zeros(1, 3, 8, 8))
    with pytest.raises(ValueError, match="needs cfg.quant.enabled"):
        ttester.calibrate_quant(cfg.replace_in("quant", enabled=False), {},
                                "cpu", batches=[])


def test_train_refuses_a_quant_config(tmp_path):
    from mx_rcnn_tpu_torch.tools.train import train_net

    cfg = generate_config("tiny", "synthetic", quant__enabled=True)
    with pytest.raises(ValueError) as err:
        train_net(cfg, prefix=str(tmp_path / "m"), end_epoch=1,
                  synthetic=2, device="cpu")
    assert str(err.value) == (
        "quant__enabled=true is inference-only — train with the fp config "
        "and enable quant at test/serve/export time")


def _tiny_checkpoint(tmp_path):
    cfg = generate_config("tiny", "synthetic",
                          dataset__root_path=str(tmp_path),
                          dataset__dataset_path=str(tmp_path / "synthetic"))
    prefix = str(tmp_path / "m")
    save_params(prefix, 1, build_model(cfg, "cpu", 0, train=True)
                .state_dict())
    return prefix


def test_test_cli_quant_prints_fingerprint_and_map(tmp_path):
    from mx_rcnn_tpu_torch.tools import test as test_cli

    prefix = _tiny_checkpoint(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = test_cli.main([
            "--device", "cpu", "--network", "tiny", "--dataset", "synthetic",
            "--root_path", str(tmp_path),
            "--dataset_path", str(tmp_path / "synthetic"), "--synthetic", "4",
            "--prefix", prefix, "--epoch", "1",
            "--set", "quant__enabled=true", "--set", "quant__dtype=fp8"])
    text = buf.getvalue()
    assert "quant eval: fp8/native estimator=absmax bits=8" in text
    assert re.search(r"^quant calibration fingerprint: [0-9a-f]{16}$", text,
                     re.M)
    assert re.search(r"^mAP = [0-9.]+$", text, re.M)
    assert np.isfinite(res["mAP"])


def test_serving_predictor_is_the_quantized_one(tmp_path):
    from mx_rcnn_tpu_torch.serve.engine import ServingEngine
    from mx_rcnn_tpu_torch.tools.loadgen import init_predictor

    prefix = _tiny_checkpoint(tmp_path)
    cfg = generate_config("tiny", "synthetic", quant__enabled=True,
                          dataset__root_path=str(tmp_path),
                          dataset__dataset_path=str(tmp_path / "synthetic"),
                          serve__batch_size=2)
    pred = init_predictor(cfg, prefix, 1, device="cpu")
    assert re.fullmatch(r"[0-9a-f]{16}", pred.quant_fingerprint)
    assert pred.program_tag.startswith("quant[int8:native:absmax:b8:")
    random_pred = init_predictor(cfg, None, device="cpu")
    assert re.fullmatch(r"[0-9a-f]{16}", random_pred.quant_fingerprint)
    engine = ServingEngine(pred, cfg)
    try:
        img = (np.random.RandomState(0).rand(100, 120, 3) * 255).astype(
            np.uint8)
        dets = engine.detect(img, timeout_ms=0)
        assert isinstance(dets, dict)
    finally:
        engine.close()


def test_quant_smoke_check_on_cpu(tmp_path):
    """tools/quant_smoke.py --device cpu --check: fp bit-identity, the
    int8 gate passes and the 2-bit red team fires it, the quantized
    store round-trips (an 8-image burst served after the join) and
    refuses an fp config and another estimator."""
    from mx_rcnn_tpu_torch.tools import quant_smoke

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = quant_smoke.main(["--device", "cpu", "--check", "--workdir",
                               str(tmp_path)])
    assert rc == 0, buf.getvalue()[-2000:]
    assert "CHECK OK" in buf.getvalue()


def test_quant_smoke_runs_with_deterministic_algorithms(monkeypatch):
    """quant_smoke's run uses PyTorch's deterministic algorithms in full
    fp32 (on the card two trainings from one seed otherwise can end at
    different weights) and hands the caller's settings back."""
    from mx_rcnn_tpu_torch.tools import quant_smoke

    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32)
    try:
        torch.use_deterministic_algorithms(False)
        cudnn.benchmark = cudnn.allow_tf32 = matmul.allow_tf32 = True
        with quant_smoke.reproducible():
            assert torch.are_deterministic_algorithms_enabled()
            assert not torch.is_deterministic_algorithms_warn_only_enabled()
            assert not cudnn.benchmark
            assert not cudnn.allow_tf32 and not matmul.allow_tf32
            assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        assert not torch.are_deterministic_algorithms_enabled()
        assert cudnn.benchmark and cudnn.allow_tf32 and matmul.allow_tf32
        assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = was[2:]
