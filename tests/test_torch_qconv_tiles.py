"""A numpy model of kernels K5 and K6's tiles (``csrc/qconv.cu``), held
against the port's plain contraction and the JAX package on the CPU.

The CUDA kernel runs only on the card.  This model repeats what its blocks
do, so that a mistake in the design shows here:

- the tile plan (``ops/quant.py — qconv_plan``) of every quantized layer
  ResNet-101 runs at the 608x1024 and 1024x608 buckets and of VGG16's
  quantized dense layers: the route by which A reaches shared memory, BN,
  the ring's depth, the shared memory a block asks for (at most the
  H100's 232,448 bytes) and the TMA boxes (dims <= 256, row strides a
  multiple of 16 bytes), with the constants and the instantiated tiles of
  the CUDA source;
- the gather producer: its row-origin table, its 16-byte chunks (eight
  threads a 128-byte row), its walk over the taps and its zero fill,
  written at the swizzled address, are the TMA's ``SWIZZLE_128B`` image
  of the A tile (16-byte chunk j of row r at chunk j ^ (r % 8)), and
  de-swizzled they are the im2col rows; conv0's byte route likewise;
- K6's f16 operands: the weight widened once a call and each thread's A
  fragment registers take K in the same order within every 16-deep
  block (position 2t + e holds k 4t + e, position 2t + 8 + e holds
  k 4t + 2 + e), so each k16 wgmma pairs every A byte with the B byte of
  its own k;
- the contraction assembled stage by stage and k32 step by k32 step in
  the kernel's K order: int8 bit-equal to ``_accum_plain`` and to the JAX
  ``_accum`` (exact integer sums); e4m3 with each k32 partial rounded to
  fp32 and added in fp32, within ``chip_smoke.py — check_qconv``'s bound
  (K * 2^-24 of the sum of the |products|) of both;
- the source: K6 gives each k32 step a fragment its first k16 wgmma
  zeroes (scale-d 0) and adds it with ``__fadd_rn``; K5 accumulates with
  scale-d 1.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.ops import quant as jq
from mx_rcnn_tpu_torch.models.layers import QuantConv2dSame, same_pads
from mx_rcnn_tpu_torch.models.resnet import ResNetBackbone, ResNetHead
from mx_rcnn_tpu_torch.ops import quant as tq

torch.set_num_threads(1)

T = torch.from_numpy
SOURCE = (Path(tq.__file__).resolve().parents[1] / "csrc" /
          "qconv.cu").read_text()
BM, BK = tq.QCONV_BM, tq.QCONV_BK
BUCKETS = ((608, 1024), (1024, 608))
IMAGES, ROIS = 2, 600          # an eval batch: 2 images x 300 rois
POOLED = 14


def _out(size, stride):
    return -(-size // stride)


def _convs(module):
    """The quantized convolutions of a ResNet backbone or head in forward
    order: conv0, then each unit's conv1, conv2, conv3 and projection."""
    found = [module.conv0] if hasattr(module, "conv0") else []
    for name in module.units:
        unit = getattr(module, name)
        found += [unit.conv1, unit.conv2, unit.conv3]
        if not unit.dim_match:
            found.append(unit.sc)
    assert all(isinstance(c, QuantConv2dSame) for c in found)
    return found


def resnet101_layers(bucket):
    """(label, (n, h, w, cin), cout, k, stride) of each of the 104
    quantized convolutions one ResNet-101 eval batch runs, the input
    extents carried through the network (conv0's stride, the 3x3/2 max
    pool, each unit's stride on conv2 and its projection)."""
    spec = tq.QuantSpec()
    with torch.device("meta"):
        backbone = ResNetBackbone(101, quant=spec)
        head = ResNetHead(101, quant=spec)
    layers = []
    h, w = bucket
    convs = _convs(backbone)
    c0 = convs[0]
    layers.append(("conv0", (IMAGES, h, w, c0.weight.shape[1]),
                   c0.weight.shape[0], 7, 2))
    h, w = _out(h, 2), _out(w, 2)
    h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1     # max pool
    for n, convs_, hw in ((IMAGES, convs[1:], (h, w)),
                          (ROIS, _convs(head), (POOLED, POOLED))):
        h, w = hw
        for conv in convs_:
            cout, cin, k, _ = conv.weight.shape
            s = conv.stride
            layers.append((f"{n}x{h}x{w} {k}x{k}/{s} {cin}->{cout}",
                           (n, h, w, cin), cout, k, s))
            if k == 3:   # conv2 carries the unit's stride to what follows
                h, w = _out(h, s), _out(w, s)
    return layers


VGG_DENSE = (("fc6", (ROIS, 1, 1, 7 * 7 * 512), 4096, 1, 1),
             ("fc7", (ROIS, 1, 1, 4096), 4096, 1, 1))


def _plan(shape, cout, k, stride, fp8):
    n, h, w, c = shape
    pads = (same_pads(h, k, stride), same_pads(w, k, stride))
    m = n * _out(h, stride) * _out(w, stride)
    kp = -(-k * k * c // tq.K_TILE) * tq.K_TILE
    return tq.qconv_plan(m, c, cout, kp, (k, k), (stride, stride), pads,
                         fp8), m, kp


def _source_tiles():
    """(bn, route) pairs qconv.cu instantiates, for K5 and K6."""
    body = SOURCE[SOURCE.index("int launch(const Params& p"):]
    body = body[:body.index("#undef QCONV_TILE")]
    both, s8_only = body.split("#if !QCONV_FP8")
    pat = r"QCONV_TILE\((\d+), ROUTE_(\w+)\)"
    common = {(int(b), r.lower()) for b, r in re.findall(pat, both)}
    return common | {(int(b), r.lower()) for b, r in
                     re.findall(pat, s8_only)}, common


def test_source_constants_match_the_plan():
    for name, value in (("BM", tq.QCONV_BM), ("BK", tq.QCONV_BK),
                        ("MAX_STAGES", tq.QCONV_MAX_STAGES)):
        assert re.search(rf"constexpr int {name} = {value};", SOURCE), name
    assert "STAGE_BUDGET = 192 * 1024;" in SOURCE
    assert tq.QCONV_STAGE_BUDGET == 192 * 1024
    assert "TABLE_BYTES = BM * 16;" in SOURCE
    # each consumer stages 64 rows x 32 fp32 columns (rows padded by 32
    # bytes) outside the ring
    assert "EPI_PITCH = 32 * 4 + 32;" in SOURCE
    assert "EPI_BYTES = 2 * 64 * EPI_PITCH;" in SOURCE
    assert tq.QCONV_EPI_BYTES == 2 * 64 * (32 * 4 + 32)
    assert tq.QCONV_ROUTES == ("gemm", "gather", "bytes")
    assert re.search(r"enum Route \{ ROUTE_GEMM = 0, ROUTE_GATHER = 1, "
                     r"ROUTE_BYTES = 2 \};", SOURCE)
    assert [tq.qconv_stages(bn) for bn in (64, 128, 256)] == [6, 6, 4]
    assert [tq.qconv_stages(bn, fp8=True) for bn in (64, 128)] == [6, 4]
    assert "B_STAGE = (QCONV_FP8 ? 2 : 1) * BN * BK;" in SOURCE


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("bucket", BUCKETS)
def test_resnet101_plans(bucket, dtype):
    """Every one of the 104 layers gets a route and tile the kernel
    instantiates, within the card's shared memory and TMA's limits."""
    layers = resnet101_layers(bucket)
    assert len(layers) == 104
    s8_tiles, e4m3_tiles = _source_tiles()
    tiles = e4m3_tiles if dtype == "fp8" else s8_tiles
    routes = {}
    for label, shape, cout, k, stride in layers:
        plan, m, kp = _plan(shape, cout, k, stride, dtype == "fp8")
        c = shape[3]
        want_route = ("bytes" if c % 16 else
                      "gemm" if (k, stride) == (1, 1) else "gather")
        assert plan.route == want_route, label
        routes[plan.route] = routes.get(plan.route, 0) + 1
        assert (plan.bn, plan.route) in tiles, label
        if cout <= 64:
            assert plan.bn == 64, label
        if dtype == "fp8" or plan.route == "bytes":
            assert plan.bn <= 128, label
        assert plan.stages == tq.qconv_stages(plan.bn, dtype == "fp8")
        assert 3 <= plan.stages <= 6
        assert plan.smem <= tq.QCONV_SMEM_LIMIT, label
        assert plan.grid == (-(-m // BM), -(-cout // plan.bn))
        names = [mp[0] for mp in plan.maps]
        assert names == (["b", "a"] if plan.route == "gemm" else ["b"])
        for name, dims, stride_bytes, box in plan.maps:
            # K6's B is f16; A and K5's B are bytes
            esize = 2 if (name, dtype) == ("b", "fp8") else 1
            assert all(1 <= b <= 256 for b in box), label
            assert box[0] * esize == BK   # the 128-byte swizzle span
            assert stride_bytes % 16 == 0
            assert stride_bytes == dims[0] * esize
            assert dims == ((kp, cout) if name == "b" else (c, m))
    # conv0 alone gathers bytes; each of the 33 units' conv1 and conv3 and
    # stage 1's projection are 1x1 stride 1; the 3x3s and the three 1x1/2
    # projections gather
    assert routes == {"bytes": 1, "gemm": 67, "gather": 36}


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_vgg16_dense_and_named_plans(dtype):
    """fc6 and fc7 (M = 600: five row tiles) take the width whose waves
    cost least: K5 one wave of 80 blocks at 256, K6 64 (a tie with 128's
    two waves of 160)."""
    fp8 = dtype == "fp8"
    for label, shape, cout, k, stride in VGG_DENSE:
        plan, m, kp = _plan(shape, cout, k, stride, fp8)
        want = ("gemm", 64, 6) if fp8 else ("gemm", 256, 4)
        assert (plan.route, plan.bn, plan.stages) == want, label
        assert plan.smem <= tq.QCONV_SMEM_LIMIT
        assert plan.grid == (5, 4096 // plan.bn)
    named = {lab: _plan(shape, cout, k, s, fp8)[0]
             for lab, shape, cout, k, s in resnet101_layers(BUCKETS[0])}
    roi_1x1 = named["600x14x14 1x1/1 1024->512"]
    assert (roi_1x1.route, roi_1x1.bn) == ("gemm", 128 if fp8 else 256)
    assert roi_1x1.grid == (919, 4 if fp8 else 2)
    assert named["conv0"].route == "bytes" and named["conv0"].bn == 64
    stage1 = named["2x152x256 3x3/1 64->64"]
    assert (stage1.route, stage1.bn, stage1.stages) == ("gather", 64, 6)
    stage3 = named["2x76x128 3x3/2 256->256"]
    assert (stage3.route, stage3.bn) == ("gather", 128)


# ---- the producer's gather, modelled ----------------------------------

def swizzle128(addr):
    """TMA's SWIZZLE_128B: within each 1024 bytes, address bits 4-6 (the
    16-byte chunk) XOR bits 7-9 (the row of eight)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def row_table(m0, geo):
    """The producer's row origins: (byte offset of the image, iy0, ix0),
    rows past M out of every image."""
    n, h, w, c, oh, ow, kh, kw, sh, sw, pt, pl = geo
    table = []
    for lt in range(BM):
        m = m0 + lt
        if m < n * oh * ow:
            img, rem = divmod(m, oh * ow)
            oy, ox = divmod(rem, ow)
            table.append((img * h * w * c, oy * sh - pt, ox * sw - pl))
        else:
            table.append((0, -(1 << 20), 0))
    return table


def gather_stage(xb, m0, kt, geo):
    """One stage of the gather route as the 128 producer threads write it:
    thread lt copies 16-byte chunk j = lt % 8 of rows lt // 8 + 16 i,
    its tap walked from k = 16 j one stage (128 bytes) at a time."""
    n, h, w, c, oh, ow, kh, kw, sh, sw, pt, pl = geo
    ktot = kh * kw * c
    table = row_table(m0, geo)
    smem = np.full(BM * BK, 0xAA, np.uint8)     # every byte must be written
    for lt in range(BM):
        j, rsub = lt & 7, lt >> 3
        swz = rsub * BK + ((j ^ (rsub & 7)) << 4)
        k = 16 * j
        tap, ci = divmod(k, c)
        ky, kx = divmod(tap, kw)
        for _ in range(kt):
            k += BK
            ci += BK
            while ci >= c:
                ci -= c
                kx += 1
                if kx == kw:
                    kx, ky = 0, ky + 1
        for i in range(8):
            base, iy0, ix0 = table[rsub + 16 * i]
            iy, ix = iy0 + ky, ix0 + kx
            ok = k < ktot and 0 <= iy < h and 0 <= ix < w
            dst = swz + i * 16 * BK
            src = base + (iy * w + ix) * c + ci
            smem[dst:dst + 16] = xb[src:src + 16] if ok else 0
    return smem


def bytes_stage(xb, m0, kt, geo):
    """One stage of conv0's byte route: thread lt gathers row lt's 128
    bytes one by one and stores 16-byte chunk q at chunk q ^ (lt % 8)."""
    n, h, w, c, oh, ow, kh, kw, sh, sw, pt, pl = geo
    ktot = kh * kw * c
    table = row_table(m0, geo)
    smem = np.full(BM * BK, 0xAA, np.uint8)
    for lt in range(BM):
        base, iy0, ix0 = table[lt]
        row = np.zeros(BK, np.uint8)
        for b in range(BK):
            k = kt * BK + b
            tap, ci = divmod(k, c)
            ky, kx = divmod(tap, kw)
            iy, ix = iy0 + ky, ix0 + kx
            if k < ktot and 0 <= iy < h and 0 <= ix < w:
                row[b] = xb[base + (iy * w + ix) * c + ci]
        for q in range(BK // 16):
            dst = lt * BK + ((q ^ (lt & 7)) << 4)
            smem[dst:dst + 16] = row[16 * q:16 * q + 16]
    return smem


def im2col(xb, geo, kp):
    """The A matrix, independently: pad the NHWC bytes, take each output
    pixel's (kh, kw, cin) window, zero past K."""
    n, h, w, c, oh, ow, kh, kw, sh, sw, pt, pl = geo
    x = xb.reshape(n, h, w, c)
    pb = max((oh - 1) * sh + kh - h - pt, 0)
    pr = max((ow - 1) * sw + kw - w - pl, 0)
    xp = np.pad(x, ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    a = np.zeros((n * oh * ow, kp), np.uint8)
    cols = [xp[:, dy:dy + (oh - 1) * sh + 1:sh, dx:dx + (ow - 1) * sw + 1:sw]
            for dy in range(kh) for dx in range(kw)]
    a[:, :kh * kw * c] = np.concatenate(cols, -1).reshape(n * oh * ow, -1)
    return a


def a_tile(a, m0, kt):
    """Rows m0.. and K bytes kt*128.. of A, zero past M and Kp (TMA's
    out-of-bounds fill, the gather's zero fill)."""
    tile = np.zeros((BM, BK), np.uint8)
    part = a[m0:m0 + BM, kt * BK:(kt + 1) * BK]
    tile[:part.shape[0], :part.shape[1]] = part
    return tile


def deswizzle(smem):
    addr = np.arange(BM * BK)
    return smem[swizzle128(addr)].reshape(BM, BK)


def _geo(n, h, w, c, k, s, pads=None):
    (pt, pb), (pl, pr) = pads or (same_pads(h, k, s), same_pads(w, k, s))
    oh = (h + pt + pb - k) // s + 1
    ow = (w + pl + pr - k) // s + 1
    return (n, h, w, c, oh, ow, k, k, s, s, pt, pl), ((pt, pb), (pl, pr))


# (n, h, w, cin, k, stride, explicit pads or None for flax SAME)
GATHER_CASES = [
    (1, 9, 11, 64, 3, 1, None),        # stage-1 3x3: two taps a stage
    (2, 8, 10, 32, 3, 2, None),        # 3x3/2 on even extents: pads (0, 1)
    (1, 7, 9, 256, 3, 1, None),        # one tap a stage
    (1, 10, 6, 48, 3, 1, ((2, 0), (0, 2))),   # asymmetric pads
    (2, 9, 9, 16, 1, 2, None),         # the 1x1/2 projection
]


@pytest.mark.parametrize("case", GATHER_CASES)
def test_gather_writes_the_swizzled_a_tile(case):
    n, h, w, c, k, s, pads = case
    geo, _ = _geo(n, h, w, c, k, s, pads)
    m = n * geo[4] * geo[5]
    kp = -(-k * k * c // tq.K_TILE) * tq.K_TILE
    rng = np.random.RandomState(sum(case[:6]))
    xb = rng.randint(1, 256, n * h * w * c).astype(np.uint8)  # no zeros
    a = im2col(xb, geo, kp)
    for m0 in sorted({0, (m - 1) // BM * BM}):
        for kt in range(-(-kp // BK)):
            smem = gather_stage(xb, m0, kt, geo)
            want = a_tile(a, m0, kt)
            # the TMA image: byte (r, b) of the tile at swizzle128(r*128+b)
            tma = np.zeros(BM * BK, np.uint8)
            tma[swizzle128(np.arange(BM * BK))] = want.reshape(-1)
            np.testing.assert_array_equal(smem, tma)
            np.testing.assert_array_equal(deswizzle(smem), want)


def test_bytes_route_writes_the_swizzled_a_tile():
    """conv0's route: C_in 3, 7x7/2 with flax's (2, 3) pads, K 147."""
    geo, _ = _geo(1, 12, 14, 3, 7, 2)
    assert (geo[10], geo[11]) == (2, 2)
    kp = 160
    rng = np.random.RandomState(3)
    xb = rng.randint(1, 256, 12 * 14 * 3).astype(np.uint8)
    a = im2col(xb, geo, kp)
    for kt in range(2):
        smem = bytes_stage(xb, 0, kt, geo)
        np.testing.assert_array_equal(deswizzle(smem), a_tile(a, 0, kt))
        tma = np.zeros(BM * BK, np.uint8)
        tma[swizzle128(np.arange(BM * BK))] = a_tile(a, 0, kt).reshape(-1)
        np.testing.assert_array_equal(smem, tma)


# ---- K6's f16 operands --------------------------------------------------

def k_of_position(p):
    """The k (within a 16-deep block) that f16 position p holds."""
    t, e = (p % 8) // 2, p % 2
    return 4 * t + e + (2 if p >= 8 else 0)


def widen_b(packed):
    """``qconv_kernel_widen_b``: each 16-byte block of a packed (cout, kp)
    row, as words w0..w3, becomes 16 f16, positions 0-7 the words' low
    byte pairs and 8-15 their high ones; each f16 is kept as the e4m3
    byte it is widened from (the cvt is exact), so positions can be held
    against bytes."""
    rows, kp = packed.shape
    words = np.ascontiguousarray(packed).view(np.uint32).reshape(
        rows, kp // 16, 4)
    out = np.zeros((rows, kp // 16, 16), np.uint8)
    for half in range(2):
        pairs = (words >> (16 * half)) & 0xFFFF
        out[:, :, 8 * half:8 * half + 8:2] = pairs & 0xFF
        out[:, :, 8 * half + 1:8 * half + 8:2] = pairs >> 8
    return out.reshape(rows, kp)


def test_k6_fragments_and_widened_b_share_the_k_order():
    """Every A byte a thread's fragment holds meets, in the k16 wgmma, the
    B byte of its own k: positions hold k by ``k_of_position`` in both."""
    rng = np.random.RandomState(9)
    rows_b = 64
    a = rng.randint(0, 256, (BM, BK)).astype(np.uint8)    # one stage, K 128
    b = rng.randint(0, 256, (rows_b, BK)).astype(np.uint8)
    swz = swizzle128(np.arange(BM * BK))
    a_smem = np.zeros(BM * BK, np.uint8)
    a_smem[swz] = a.reshape(-1)
    # the widened weight: position p of k16 step q of row n holds (as its
    # e4m3 byte, before the exact cvt) b[n, 16 q + k_of_position(p)]; TMA
    # then brings 64 of them a row into each 128-byte atom, as A's bytes
    wide = widen_b(b)
    for q in range(8):
        for p in range(16):
            np.testing.assert_array_equal(wide[:, 16 * q + p],
                                          b[:, 16 * q + k_of_position(p)])
    # each consumer thread's A fragment: rows r0, r0 + 8; one 4-byte load
    # a row at chunk q ^ (r0 % 8), byte 4t: registers 0/1 the loads' low
    # pairs (positions 2t, 2t+1), 2/3 their high pairs (2t+8, 2t+9)
    for wg in range(2):
        for lt in range(128):
            warp, lane = lt >> 5, lt & 31
            t4 = 4 * (lane & 3)
            r0 = wg * 64 + 16 * warp + (lane >> 2)
            for q in range(8):
                chunk = (q ^ (r0 & 7)) << 4
                x0 = a_smem[r0 * BK + chunk + t4:][:4]
                x1 = a_smem[(r0 + 8) * BK + chunk + t4:][:4]
                regs = [(x0[:2], r0, 2 * (lane & 3)),
                        (x1[:2], r0 + 8, 2 * (lane & 3)),
                        (x0[2:], r0, 2 * (lane & 3) + 8),
                        (x1[2:], r0 + 8, 2 * (lane & 3) + 8)]
                for pair, row, pos in regs:
                    want = [a[row, 16 * q + k_of_position(pos + e)]
                            for e in range(2)]
                    np.testing.assert_array_equal(pair, want)
    # the order is a permutation of each 16-deep block
    assert sorted(k_of_position(p) for p in range(16)) == list(range(16))


# ---- the contraction in the kernel's order ------------------------------

def _values(q):
    """int8 or e4m3 bytes → their float64 values."""
    return q.to(torch.float64).numpy()


def tile_contraction(qx, packed, geo, route, fp8):
    """acc[m, n] as the kernel forms it: A stage by stage (gathered and
    de-swizzled, or the [M, C] rows TMA reads), B's 128-byte slices, four
    k32 steps a stage; int8 summed exactly, e4m3 each k32 partial
    rounded to fp32 and added to an fp32 accumulator."""
    n, h, w, c, oh, ow = geo[:6]
    m = n * oh * ow
    kp = packed.shape[1]
    xb = qx.contiguous().view(torch.uint8).numpy().reshape(-1)
    xval = np.zeros(256)      # byte → value of the container
    codes = torch.arange(256, dtype=torch.int16).to(torch.uint8)
    xval[:] = _values(codes.view(qx.dtype))
    bval = _values(packed)
    acc = np.zeros((m, packed.shape[0]),
                   np.float32 if fp8 else np.int64)
    for m0 in range(0, m, BM):
        for kt in range(-(-kp // BK)):
            if route == "gemm":
                rows = xb.reshape(m, c)
                tile = np.zeros((BM, BK), np.uint8)
                part = rows[m0:m0 + BM, kt * BK:(kt + 1) * BK]
                tile[:part.shape[0], :part.shape[1]] = part
            else:
                stage = (gather_stage if route == "gather" else
                         bytes_stage)(xb, m0, kt, geo)
                tile = deswizzle(stage)
            av = xval[tile]
            rows = slice(m0, min(m0 + BM, m))
            for kk in range(BK // 32):
                k0 = kt * BK + kk * 32
                bk = np.zeros((packed.shape[0], 32))
                bk[:, :max(0, min(32, kp - k0))] = bval[:, k0:k0 + 32]
                partial = av[:m - m0 if m - m0 < BM else BM,
                             kk * 32:kk * 32 + 32] @ bk.T   # exact
                if fp8:
                    acc[rows] = (acc[rows] + partial.astype(np.float32)
                                 ).astype(np.float32)
                else:
                    acc[rows] += partial.astype(np.int64)
    return acc.astype(np.float32) if not fp8 else acc


# (label, (n, h, w, cin), cout, k, stride)
CONTRACTION_CASES = [
    ("gemm 1x1", (2, 9, 15, 160), 72, 1, 1),
    ("gemm dense", (150, 1, 1, 288), 40, 1, 1),
    ("gather 3x3", (1, 10, 14, 48), 24, 3, 1),
    ("gather 3x3/2", (2, 12, 10, 32), 40, 3, 2),
    ("bytes 7x7/2", (1, 14, 18, 3), 16, 7, 2),
]


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("case", CONTRACTION_CASES, ids=lambda c: c[0])
def test_tile_contraction_against_plain_and_jax(case, dtype):
    label, shape, cout, k, s = case
    n, h, w, c = shape
    fp8 = dtype == "fp8"
    rng = np.random.RandomState(len(label) + k + s + c)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    wt = (rng.randn(cout, c, k, k) *
          np.linspace(0.5, 2.0, cout)[:, None, None, None]).astype(np.float32)
    est = np.float32(np.abs(x).max() * 0.9)
    spec = tq.QuantSpec(dtype=dtype)
    qx, _ = tq.quantize_act(T(x), torch.tensor(est), spec)
    qw, _ = tq.quantize_weight(T(wt), spec)
    packed = tq.pack_weight(qw)
    geo, pads = _geo(n, h, w, c, k, s)
    plan, m, kp = _plan(shape, cout, k, s, fp8)
    assert plan.route == label.split()[0]
    got = tile_contraction(qx, packed, geo, plan.route, fp8)
    conv = ((s, s), pads)
    plain = tq._accum_plain(qx, qw, spec, conv).numpy().reshape(m, cout)
    jspec = jq.QuantSpec(dtype=dtype)
    jqx, _ = jq.quantize_act(jnp.asarray(x), jnp.asarray(est), jspec)
    jqw, _ = jq.quantize_weight(jnp.asarray(wt.transpose(2, 3, 1, 0)), jspec)
    np.testing.assert_array_equal(np.asarray(jqx).view(np.uint8),
                                  qx.view(torch.uint8).numpy()
                                  if fp8 else qx.numpy().view(np.uint8))
    jacc = np.asarray(jq._accum(jqx, jqw, jspec, conv_kw={
        "strides": (s, s), "padding": pads})).reshape(m, cout)
    if not fp8:
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, jacc)
        return
    abs_sum = tq._conv_nhwc(qx.to(torch.float64).abs(),
                            qw.to(torch.float64).abs(), *conv)
    allow = k * k * c * 2.0 ** -24 * abs_sum.numpy().reshape(m, cout) + 1e-30
    for ref in (plain, jacc):
        err = np.abs(got.astype(np.float64) - ref)
        assert (err <= allow).all(), float((err / allow).max())
    # and the k32 promotion is not the exact sum: it rounds somewhere
    assert np.abs(got.astype(np.float64) - plain).max() <= allow.max()


# ---- the source ---------------------------------------------------------

def test_e4m3_zeroes_each_k32_fragment_and_adds_it_in_fp32():
    body = SOURCE[SOURCE.index("__device__ __forceinline__ void consume("):]
    body = body[:body.index("__global__")]
    fp8 = body[body.index("#if QCONV_FP8\n"):]
    fp8 = fp8[:fp8.index("#else")]
    # a job is one k32 step: two k16 wgmmas into part[j % 2], the first
    # with scale-d e = 0 (it zeroes the fragment), the second e = 1
    assert re.search(r"for \(int e = 0; e < 2; \+\+e\) \{\s*"
                     r"const int q = 2 \* kk \+ e;\s*"
                     r"wgmma_rs_n64\(part\[j % 2\], af\[e\],[^;]*,\s*e\);",
                     fp8)
    # waited for, then added to the fp32 accumulators with __fadd_rn, one
    # k32 partial at a time
    assert re.search(r"wgmma_wait<1>\(\);\s*add_partial\(acc\[\(j - 1\) "
                     r"% HALVES\], part\[\(j - 1\) % 2\]\);", fp8)
    assert re.search(r"wgmma_wait<0>\(\);\s*add_partial\(", fp8)
    add = SOURCE[SOURCE.index("void add_partial("):]
    add = add[:add.index("\n}\n")]
    assert "acc[i] = __fadd_rn(acc[i], part[i]);" in add
    s8 = body[body.index("#else", body.index("#if QCONV_FP8\n")):]
    s8 = s8[:s8.index("#endif")]
    assert re.search(r"wgmma<WN>\(acc\[h\], [^;]*,\s*1\);", s8)
    assert "__fadd_rn" not in s8
    # the instructions the design is built on, and no mma.sync left
    for needle in ("wgmma.mma_async.sync.aligned.m64n", "k16.f32.f16.f16",
                   "k32.s32.s8.s8", "cvt.rn.f16x2.e4m3x2",
                   "cp.async.bulk.tensor.2d",
                   "cp.async.mbarrier.arrive.noinc", "setmaxnreg.dec",
                   "setmaxnreg.inc", "CU_TENSOR_MAP_SWIZZLE_128B",
                   "cuTensorMapEncodeTiled"):
        assert needle in SOURCE, needle
    assert "mma.sync.aligned" not in SOURCE
