"""Kernel K4 with the frozen BN and ReLU before it (``csrc/quantize.cu``),
held on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py — check_k4``
holds it there against its plain version, bytes equal).  Here:

- the fused plain version (``ops/quant.py — quantize_act_fused_plain``)
  gives the bytes of the unfused sequence the quantized ResNet ran
  before: ``FrozenBatchNorm`` on ``x.to(dtype)``, ``F.relu``, then
  ``quantize_act_plain`` once per reading layer, with the BN's scale and
  shift and each layer's unit folded once; over int8 at 8 and 4 bits and
  fp8, bf16 and fp32 models, ReLU on and off, one and two outputs, and
  C = 3, 64 and 2048 on channels-last tensors, with quotient ties, values
  past +-qmax, -0.0 and NaN in the input;
- a numpy model of the kernel's walk over the storage: which element and
  which channel each lane of each vector handles, with the grid's stride,
  the per-vector channel advance, the tail and the unaligned path, for
  the channel counts of ResNet-101 and conv0's 3;
- a numpy float32 model of the kernel's int8 rounding (the clipped
  quotient plus 1.5 * 2^23, its low byte) against round-half-even and the
  integer cast, over all 65,536 bf16 inputs at several units;
- a numpy float32 model of the kernel's quotient: the product by the
  reciprocal, and the IEEE division only near a rounding boundary of the
  container, gives the bytes of the division (``__fdiv_rn``, numpy's
  float32 division) in int8 at 8 and 4 bits and in e4m3, over all 65,536
  bf16 inputs, a random fp32 sample and the values around every
  boundary, at units that are powers of two and units that are not;
- the quantized ResNet's K4 count: one pass per BN that feeds quantized
  convolutions (100 in ResNet-101, against 104 quantized convolutions).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.models import resnet as t_resnet
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.models.layers import FrozenBatchNorm, QuantConv2dSame
from mx_rcnn_tpu_torch.ops import quant as tq

torch.set_num_threads(1)

SOURCE = (Path(tq.__file__).resolve().parents[1] / "csrc" /
          "quantize.cu").read_text()
SPECS = {"int8 b8": tq.QuantSpec(), "int8 b4": tq.QuantSpec(weight_bits=4),
         "fp8": tq.QuantSpec(dtype="fp8")}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
MAGIC = np.float32(12582912.0)     # 1.5 * 2^23


def _eps_one(eps=2e-5):
    """A running variance whose ``var + eps`` is exactly 1 in fp32: the
    channel's inv is then its weight, exactly."""
    v = np.float32(1.0) - np.float32(eps)
    for _ in range(8):
        s = np.float32(v + np.float32(eps))
        if s == 1.0:
            return v
        v = np.nextafter(v, np.float32(0 if s > 1 else 2), dtype=np.float32)
    raise AssertionError("no fp32 variance gives var + eps == 1")


def _bn(c, dtype, rng):
    """A frozen BN with random statistics on most channels; channel c % 4
    == 0 has inv a power of two and shift +0 (exact ties downstream),
    c % 4 == 1 shift -0.0 (bias -0, mean 0)."""
    bn = FrozenBatchNorm(c, dtype)
    w = rng.uniform(0.5, 2.0, c).astype(np.float32)
    b = rng.uniform(-1, 1, c).astype(np.float32)
    mean = rng.uniform(-1, 1, c).astype(np.float32)
    var = rng.uniform(0.2, 3.0, c).astype(np.float32)
    exact = np.arange(c) % 4 == 0
    w[exact] = 2.0 ** rng.randint(-2, 3, exact.sum())
    var[exact] = _eps_one()
    b[exact] = 0.0
    mean[exact] = 0.0
    negz = np.arange(c) % 4 == 1
    b[negz] = -0.0
    mean[negz] = 0.0
    with torch.no_grad():
        for t, a in ((bn.weight, w), (bn.bias, b), (bn.running_mean, mean),
                     (bn.running_var, var)):
            t.copy_(torch.from_numpy(a))
    inv, _ = bn.folded()
    assert torch.equal(inv[torch.from_numpy(exact)],
                       torch.from_numpy(w[exact]))
    return bn, w, exact, negz


def _case(c, in_dtype, dtype, spec, seed):
    rng = np.random.RandomState(seed)
    bn, w, exact, negz = _bn(c, dtype, rng)
    unit = np.float32(2.0 ** -3)           # a power of two: exact quotients
    est_tie = torch.tensor(float(unit) * spec.qmax)
    est_any = torch.tensor(3.7)            # a unit that is not
    n, h, wd = (1, 2, 3) if c > 256 else (2, 3, 5)
    x = (rng.randn(n, h, wd, c) * 2.0).astype(np.float32)
    flat = x.reshape(-1, c)
    rows = flat.shape[0]
    # ties after the BN: x = (k + 0.5) * unit / inv on the exact channels
    lim = min(int(spec.qmax), 40)
    k = rng.randint(-lim, lim, (rows, c)).astype(np.float32) + 0.5
    tie = k * unit / w[None, :]
    pick = rng.rand(rows, c) < 0.7
    flat[:, exact] = np.where(pick[:, exact], tie[:, exact], flat[:, exact])
    # past +-qmax (after any BN): large magnitudes
    big = rng.rand(rows, c) < 0.1
    flat[big] = np.sign(rng.randn(big.sum())) * (
        3.0 * float(spec.qmax) * float(unit) * 4)
    # -0.0 on the -0 shift channels and elsewhere; NaN here and there
    z = rng.rand(rows, c) < 0.2
    flat[z & negz[None, :]] = -0.0
    flat[rng.rand(rows, c) < 0.05] = -0.0
    flat[rng.rand(rows, c) < 0.01] = np.nan
    flat[0, 0] = np.nan
    flat[1, 1] = -0.0              # channel 1: shift -0.0, so y is -0.0
    xt = torch.from_numpy(x).to(in_dtype).permute(0, 3, 1, 2)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    return bn, xt, (est_tie, est_any)


def _as_bytes(q):
    q = q.permute(0, 2, 3, 1).contiguous()
    return (q.view(torch.uint8) if q.dtype == torch.float8_e4m3fn
            else q).numpy()


@pytest.mark.parametrize("c", [3, 64, 2048])
@pytest.mark.parametrize("outputs", [1, 2])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("sname", list(SPECS))
def test_fused_plain_equals_the_unfused_sequence(sname, dname, relu,
                                                 outputs, c):
    spec, dtype = SPECS[sname], DTYPES[dname]
    # conv0 reads the fp32 image and casts it to the model dtype first
    in_dtype = torch.float32 if c == 3 else dtype
    bn, x, ests = _case(c, in_dtype, dtype, spec, seed=c + outputs)
    ests = ests[:outputs]
    y = bn(x.to(dtype))
    if relu:
        y = F.relu(y)
    want = [tq.quantize_act_plain(y.permute(0, 2, 3, 1), e, spec)[0]
            for e in ests]
    units = [tq._unit(e, spec.qmax) for e in ests]
    got = tq.quantize_act_fused(x, units, spec, affine=bn.folded(),
                                dtype=dtype, relu=relu)
    assert len(got) == outputs
    for g, wnt in zip(got, want):
        assert g.dtype == spec.container
        assert g.is_contiguous(memory_format=torch.channels_last)
        wb = (wnt.view(torch.uint8) if wnt.dtype == torch.float8_e4m3fn
              else wnt).numpy()
        np.testing.assert_array_equal(_as_bytes(g), wb)
    # the inputs reach every case the kernel must get right
    q = y.permute(0, 2, 3, 1).to(torch.float32) / units[0]
    assert bool(torch.isnan(q).any())
    assert bool((q.abs() > spec.qmax).any())
    if spec.dtype == "int8":
        finite = q[torch.isfinite(q) & (q.abs() < spec.qmax)]
        assert bool(((finite - finite.floor()) == 0.5).any())
    zero = y == 0
    assert bool((zero & torch.signbit(y)).any()) or relu


def test_fused_without_affine_is_the_plain_quantizer():
    spec = tq.QuantSpec(dtype="fp8")
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 5, 7, 16)
                         .astype(np.float32))
    x[0, 0, 0, :3] = torch.tensor([-0.0, float("nan"), 1e6])
    est = x[torch.isfinite(x)].abs().max()
    want, unit = tq.quantize_act_plain(x, est, spec)
    got, = tq.quantize_act_fused(x, [tq._unit(est, spec.qmax)], spec)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_folded_bn_tracks_its_parameters():
    bn = FrozenBatchNorm(8)
    first = bn.folded()
    assert bn.folded()[0] is first[0]
    with torch.no_grad():
        bn.running_var.fill_(4.0)
    inv, shift = bn.folded()
    assert inv is not first[0]
    assert torch.equal(inv, bn._fold()[0]) and torch.equal(shift,
                                                         bn._fold()[1])


def test_fused_cuda_wrapper_refuses_cpu_tensors_and_counts_nothing():
    kernels.reset_launch_counts()
    x = torch.randn(1, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    bn = FrozenBatchNorm(8)
    unit = torch.tensor(0.1)
    with pytest.raises(ValueError, match="CUDA"):
        tq.quantize_act_fused_cuda(x, [unit], tq.QuantSpec(),
                                   affine=bn.folded(), dtype=torch.float32)
    tq.quantize_act_fused(x, [unit, unit], tq.QuantSpec(),
                          affine=bn.folded(), dtype=torch.float32,
                          relu=True)
    assert kernels.launch_counts() == {k.name: 0 for k in kernels.KERNELS}


# ---- the kernel's walk over the storage -------------------------------------

def _source_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def test_kernel_constants_match_the_wrapper():
    assert _source_int("kThreads") == tq.K4_THREADS
    assert _source_int("kMaxChannels") == tq.K4_MAX_CHANNELS
    assert re.search(r"constexpr float kMagic = 12582912\.0f;", SOURCE)
    assert re.search(r"constexpr int U = BF16 \? 4 : 2;", SOURCE)


def k4_walk(n, c, blocks, bf16, aligned=True):
    """The kernel's loops in numpy, every thread of the grid at once:
    the channel each element is given and how often it is written."""
    threads = tq.K4_THREADS
    u_count = 4 if bf16 else 2
    stride = blocks * threads
    nvec = n // tq.K4_VECTOR if aligned else 0
    adv = (stride * tq.K4_VECTOR) % c
    first = np.arange(stride, dtype=np.int64)
    c0 = (first * 8) % c
    fixed = adv == 0 and c % 8 == 0
    regs = c0[:, None] + np.arange(8)[None, :]      # fixed: held once
    chan = np.full(n, -1, np.int64)
    writes = np.zeros(n, np.int64)
    base = first.copy()
    while (base < nvec).any():
        for u in range(u_count):
            v = base + u * stride
            live = v < nvec
            if fixed:
                lanes = regs
            else:
                lanes = np.empty((stride, 8), np.int64)
                cc = c0.copy()
                for j in range(8):
                    lanes[:, j] = cc
                    cc = np.where(cc + 1 == c, 0, cc + 1)
            elem = v[live, None] * 8 + np.arange(8)[None, :]
            chan[elem] = lanes[live]
            np.add.at(writes, elem.reshape(-1), 1)
            c0 = c0 + adv
            c0 = np.where(c0 >= c, c0 - c, c0)
        base = base + u_count * stride
    i = nvec * 8 + first
    while (i < n).any():
        live = i[i < n]
        chan[live] = live % c
        np.add.at(writes, live, 1)
        i = i + stride
    return chan, writes, fixed


@pytest.mark.parametrize("c,rows", [
    (3, 37), (3, 1000), (64, 19), (256, 7), (2048, 3), (1024, 5), (40, 9),
    (5, 333)])
@pytest.mark.parametrize("blocks", [1, 3, 7])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("aligned", [True, False])
def test_kernel_walk_gives_every_element_its_channel_once(c, rows, blocks,
                                                         bf16, aligned):
    n = rows * c
    chan, writes, _ = k4_walk(n, c, blocks, bf16, aligned)
    np.testing.assert_array_equal(writes, 1)
    np.testing.assert_array_equal(chan, np.arange(n) % c)


def test_resnet_channels_keep_their_lanes_for_every_grid():
    """Every C of ResNet-101's quantized inputs but conv0's divides the
    grid's stride of 8 * 256 * blocks elements: a thread's 8 channels are
    fixed and live in registers; conv0's 3 takes the per-lane walk."""
    for blocks in (1, 2, 132 * 3, 132 * 4):
        for c in (64, 128, 256, 512, 1024, 2048):
            assert k4_walk(c * 3, c, blocks, True)[2]
        assert not k4_walk(30, 3, blocks, False)[2]


# ---- the int8 rounding --------------------------------------------------------

def _all_bf16():
    bits = np.arange(65536, dtype=np.uint32) << 16
    return bits.view(np.float32)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("unit", [2.0 ** -3, 1.0, 2.0 ** 7, 0.0137, 3.7 / 127,
                                  1e-12 / 127])
def test_int8_rounding_by_the_magic_add_equals_rint_over_all_bf16(unit,
                                                                   bits):
    """quantize_s8: t = clip(v / unit) by comparisons, then byte 0 of
    fp32(t + 1.5 * 2^23), 0 for NaN, against clip(rint(v / unit)) cast
    to int8 (the plain version), for every bf16 value ``v``."""
    qmax = np.float32(2 ** (bits - 1) - 1)
    v = _all_bf16()
    with np.errstate(all="ignore"):
        t = v / np.float32(unit)                # IEEE division, as __fdiv_rn
        ref = np.clip(np.rint(t), -qmax, qmax)
        want = np.where(np.isnan(ref), 0, ref).astype(np.int64) & 0xFF
        tc = np.where(t < -qmax, -qmax, np.where(t > qmax, qmax, t))
        model = (tc + MAGIC).astype(np.float32).view(np.uint32) & 0xFF
        model = np.where(np.isnan(tc), 0, model)
    np.testing.assert_array_equal(model, want)


# ---- the quotient: the reciprocal, the division near a boundary -------------

UNITS = [2.0 ** -3, 1.0, 2.0 ** 7, 2.0 ** -20, 0.0137, 3.7 / 127,
         1e-12 / 127, 3.7 / 448, 1e-12 / 448, 123.456 / 448, 7.3e30]


def _f32(a):
    return np.asarray(a, np.float32)


def _clip(t, lim):
    lim = np.float32(lim)
    return _f32(np.where(t < -lim, -lim, np.where(t > lim, lim, t)))


def _quotient_s8(v, unit, qmax):
    """csrc/quantize.cu — product_s8 and its fallback in numpy float32:
    the clipped quotient and whether the division was taken."""
    u, lim = np.float32(unit), np.float32(qmax)
    rcp = np.float32(1.0) / u                         # __frcp_rn
    p = _f32(v * rcp)
    t = _f32(np.fmin(np.fmax(p, -lim), lim))          # fminf / fmaxf
    s = _f32(t + MAGIC)
    d = _f32(t - _f32(s - MAGIC))
    near = (np.abs(d) >= np.float32(0.5 - 2.0 ** -13)) | np.isnan(p)
    return _f32(np.where(near, _clip(v / u, qmax), t)), near


def _quotient_e4m3(v, unit):
    """csrc/quantize.cu — product_e4m3 and its fallback in numpy float32."""
    u = np.float32(unit)
    rcp = np.float32(1.0) / u
    p = _f32(v * rcp)
    t = _f32(np.fmin(np.fmax(p, np.float32(-448.0)), np.float32(448.0)))
    a = np.abs(t)
    w = _f32(np.where(a < np.float32(2.0 ** -6), _f32(a + np.float32(2.0 ** -6)),
                      a))
    m = (w.view(np.uint32) + np.uint32((16 - 0x80000) & 0xFFFFFFFF)) & \
        np.uint32(0xFFFFF)
    near = (m <= 32) | np.isnan(p)
    return _f32(np.where(near, _clip(v / u, 448.0), t)), near


def _s8_bytes(t):
    """The int8 byte of a clipped value (magic add, NaN -> 0)."""
    s = _f32(t + MAGIC)
    return np.where(np.isnan(t), 0, s.view(np.uint32) & 0xFF)


def _e4m3_bytes(t):
    return torch.from_numpy(_f32(t)).to(torch.float8_e4m3fn).view(
        torch.uint8).numpy()


def _e4m3_values():
    v = torch.arange(256, dtype=torch.uint8).view(torch.float8_e4m3fn)
    v = v.to(torch.float32).numpy()
    return np.unique(v[np.isfinite(v)])


def _around(points, unit, k=6):
    """fp32 inputs whose quotient by ``unit`` lands on and within k ulps
    of each point (a rounding boundary)."""
    v = _f32(np.asarray(points, np.float64) * float(unit))
    out = [v]
    lo, hi = v.copy(), v.copy()
    for _ in range(k):
        lo = np.nextafter(lo, np.float32(-np.inf), dtype=np.float32)
        hi = np.nextafter(hi, np.float32(np.inf), dtype=np.float32)
        out += [lo, hi]
    return _f32(np.concatenate(out))


def _inputs(unit, boundaries):
    rng = np.random.RandomState(0)
    wide = _f32(rng.randn(200_000) * np.exp2(rng.randint(-30, 30, 200_000)))
    with np.errstate(over="ignore"):
        return np.concatenate([_all_bf16(), wide, _around(boundaries, unit)])


@pytest.mark.parametrize("unit", UNITS)
@pytest.mark.parametrize("bits", [8, 4])
def test_reciprocal_route_gives_the_division_bytes_int8(unit, bits):
    qmax = np.float32(2 ** (bits - 1) - 1)
    ties = np.arange(-qmax - 1, qmax + 1) + 0.5
    v = _inputs(unit, ties)
    with np.errstate(all="ignore"):
        want = _s8_bytes(_clip(v / np.float32(unit), qmax))
        t, near = _quotient_s8(v, unit, qmax)
        got = _s8_bytes(t)
    np.testing.assert_array_equal(got, want)
    # the division is the rare route: the boundaries' neighbourhoods
    assert near[:65536].mean() < 0.01


@pytest.mark.parametrize("unit", UNITS)
def test_reciprocal_route_gives_the_division_bytes_e4m3(unit):
    vals = _e4m3_values()
    mids = (vals[1:].astype(np.float64) + vals[:-1]) / 2
    v = _inputs(unit, np.concatenate([mids, vals]))
    with np.errstate(all="ignore"):
        want = _e4m3_bytes(_clip(v / np.float32(unit), 448.0))
        t, near = _quotient_e4m3(v, unit)
        got = _e4m3_bytes(t)
    np.testing.assert_array_equal(got, want)
    assert near[:65536].mean() < 0.01


# ---- launches on the quantized ResNet -----------------------------------------

def test_resnet101_has_one_k4_pass_per_bn_feeding_quantized_convs():
    """conv0's bn_data and each unit's three BNs: 1 + 3 * 33 = 100 K4
    passes for 104 quantized convolutions (the four projection units'
    shortcut reads bn1's pass)."""
    cfg = generate_config("resnet101", "PascalVOC", quant__enabled=True)
    model = build_model(cfg, "cpu", None)
    convs = [m for m in model.modules() if isinstance(m, QuantConv2dSame)]
    units = [m for m in model.modules()
             if isinstance(m, t_resnet.BottleneckUnit)]
    assert len(convs) == 104
    assert len(units) == 33 and sum(not u.dim_match for u in units) == 4
    assert 1 + 3 * len(units) == 100


@pytest.fixture
def shallow_resnet():
    saved = t_resnet.STAGE_UNITS[101]
    t_resnet.STAGE_UNITS[101] = (1, 2, 1, 1)
    yield
    t_resnet.STAGE_UNITS[101] = saved


def test_quantized_resnet_calls_the_fused_quantizer_once_per_bn(
        monkeypatch, shallow_resnet):
    """The apply phase quantizes each convolution's input through one
    fused call per BN (two outputs for a projection unit's bn1), and the
    calibration phase through none."""
    calls = []
    real = tq.quantize_act_fused

    def spy(x, units, spec, affine=None, dtype=None, relu=False):
        calls.append((len(units), affine is not None, relu))
        return real(x, units, spec, affine, dtype, relu)

    monkeypatch.setattr(t_resnet, "quantize_act_fused", spy)
    cfg = generate_config("resnet101", "PascalVOC", quant__enabled=True,
                          network__compute_dtype="float32")
    model = build_model(cfg, "cpu", 0)
    for m in model.modules():
        if isinstance(m, QuantConv2dSame):
            m.prepare_(np.float32(4.0))
    with torch.inference_mode():
        feat = model.backbone(torch.randn(1, 3, 48, 64).contiguous(
            memory_format=torch.channels_last))
        model.head(torch.randn(2, 14, 14, 1024))
    units = 5     # (1, 2, 1, 1) units a stage, stage 4 in the head
    assert len(calls) == 1 + 3 * units
    assert calls[0] == (1, True, False)                  # bn_data -> conv0
    assert sorted(set(calls[1:])) == [(1, True, True), (2, True, True)]
    assert sum(n == 2 for n, _, _ in calls) == 4         # the projections
    assert torch.isfinite(feat).all()
    calib = build_model(cfg, "cpu", 0, quant_phase="calib")
    calls.clear()
    with torch.inference_mode():
        calib.backbone(torch.randn(1, 3, 48, 64))
    assert calls == []
