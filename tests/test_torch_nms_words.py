"""A numpy model of kernel K1's two passes (``csrc/nms_sweep.cu``), held
against the plain sweep and the JAX package's batched sweep on the CPU.

The CUDA kernel runs only on the card.  This model repeats its index
arithmetic and its order of work over ``uint64`` words so that a mistake in
the design shows here:

- the mask pass walks the upper triangle of (row block, col block) pairs
  through the kernel's ``tri_pair`` map, and writes the words
  column-block-major, ``mask[b][col_block][row]`` with rows padded to a
  multiple of 64, with the kernel's exact shortcuts (a non-intersecting
  pair gives ``0 > thr`` without a divide; dead rows and dead columns give
  0 bits);
- the reduction seeds ``removed`` from ``~alive``; its mover warps copy
  each row block's words into a two-slot tile the way the kernel's
  ``cp.async`` copies do (16 bytes a lane, col blocks past the tile's
  capacity read straight from the mask); warp 0 resolves the 64-box chain
  from the diagonal words held two per lane as 32-bit halves (rows 0..31
  on the low halves, then the kept rows' high halves folded in, then rows
  32..63, whose low halves are zero by the triangle); mover ``mw`` ORs the
  kept rows' words into its col blocks ``j = mw (mod movers)``, eight at a
  time, each warp's lanes reduced on two 32-bit halves.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu_torch.ops import boxes as tboxes
from mx_rcnn_tpu_torch.ops import nms as tnms

jnms = importlib.import_module("mx_rcnn_tpu.ops.nms")
torch.set_num_threads(1)

KB = 64                      # boxes per row / col block, bits per word
OPTIN_SMEM = 232448          # an H100 block's shared-memory limit, bytes
M32 = 0xFFFFFFFF
MOVERS = 31                  # the kernel's most mover warps
STALE = np.uint64(0xA5A5A5A5A5A5A5A5)   # memory nobody wrote


def tri_pair(t, n):
    """The kernel's map from a 1-D grid index to (row block, col block)."""
    total = n * (n + 1) // 2
    tp = total - 1 - t
    r = int((np.sqrt(8.0 * tp + 1.0) - 1.0) * 0.5)
    while (r + 1) * (r + 2) // 2 <= tp:
        r += 1
    while r * (r + 1) // 2 > tp:
        r -= 1
    e = tp - r * (r + 1) // 2
    return n - 1 - r, n - 1 - e


def pack(bits):
    """(..., 64) bool → (...,) uint64, bit q from bits[..., q]."""
    shifts = np.arange(KB, dtype=np.uint64)
    return np.bitwise_or.reduce(bits.astype(np.uint64) << shifts, axis=-1)


def _area(b):
    one = np.float32(1.0)
    return ((b[:, 2] - b[:, 0]) + one) * ((b[:, 3] - b[:, 1]) + one)


def mask_pass(boxes, alive, thr):
    """boxes (B, K, 4) fp32, alive (B, K) bool → words (B, n, 64 n)
    uint64."""
    bsz, k = alive.shape
    n = -(-k // KB)
    thr = np.float32(thr)
    one, zero = np.float32(1.0), np.float32(0.0)
    # never-written slots (under the diagonal) hold a pattern, not zeros
    words = np.full((bsz, n, n * KB), STALE, np.uint64)
    lane = np.arange(KB)
    for b in range(bsz):
        for t in range(n * (n + 1) // 2):
            rb, cb = tri_pair(t, n)
            rows, cols = rb * KB + lane, cb * KB + lane
            row_live = (rows < k) & alive[b, np.minimum(rows, k - 1)]
            col_live = (cols < k) & alive[b, np.minimum(cols, k - 1)]
            r = boxes[b, np.minimum(rows, k - 1)]
            c = boxes[b, np.minimum(cols, k - 1)]
            iw = (np.minimum(r[:, None, 2], c[None, :, 2])
                  - np.maximum(r[:, None, 0], c[None, :, 0])) + one
            ih = (np.minimum(r[:, None, 3], c[None, :, 3])
                  - np.maximum(r[:, None, 1], c[None, :, 1])) + one
            meet = (iw > zero) & (ih > zero)
            with np.errstate(divide="ignore", invalid="ignore",
                             over="ignore"):
                inter = iw * ih
                uni = (_area(r)[:, None] + _area(c)[None, :]) - inter
                iou = np.where(uni > zero,
                               inter / np.maximum(uni, np.float32(1e-12)),
                               zero)
            hit = np.where(meet, iou > thr, zero > thr)
            todo = row_live[:, None] & col_live[None, :]
            if rb == cb:
                todo &= lane[None, :] > lane[:, None]
            words[b, cb, rb * KB:(rb + 1) * KB] = pack(hit & todo)
    return words


def first_owned(lo, mw, movers):
    """The first col block j >= lo that mover mw owns: j = mw (mod movers).
    The kernel tracks it from one row block to the next."""
    return lo + (mw - lo) % movers


def reduce_pass(words, alive, optin=OPTIN_SMEM, max_movers=MOVERS):
    """words from :func:`mask_pass`, alive (B, K) → keep (B, K) bool.

    Warp 0 resolves the chain; ``movers`` warps copy the words and OR them.
    Shared memory starts stale, so a word the kernel would read before it
    is copied shows in the keep mask.
    """
    bsz, k = alive.shape
    n = words.shape[1]
    movers = min(n, max_movers)
    head = ((n + 2) & ~1) * 8
    tile_cols = min(n, (optin - head) // (2 * KB * 8))
    assert tile_cols >= 1
    lanes = np.arange(32)
    keep = np.zeros((bsz, k), bool)
    for b in range(bsz):
        m = words[b]
        removed = []
        for j in range(n):
            idx = j * KB + np.arange(KB)
            removed.append(int(pack((idx >= k)
                                    | ~alive[b, np.minimum(idx, k - 1)])))
        tile = np.full((2, tile_cols * KB), STALE, np.uint64)

        def prefetch(r):
            # mover mw copies col blocks r + mw, r + mw + movers, ..., 16
            # bytes (rows 2 lane, 2 lane + 1) a lane
            slot = tile[r & 1]
            for mw in range(movers):
                for c in range(mw, min(n - r, tile_cols), movers):
                    for part in range(0, KB, 2):
                        slot[c * KB + part:c * KB + part + 2] = \
                            m[r + c, r * KB + part:r * KB + part + 2]

        prefetch(0)
        for nb in range(n):
            cur = tile[nb & 1]
            base = nb * KB
            # warp 0: lane q holds rows q and q+32 as 32-bit halves
            dl, dh = cur[lanes], cur[lanes + 32]
            r_lo, r_hi = removed[nb] & M32, removed[nb] >> 32
            kw_lo = kw_hi = 0
            for q in range(32):      # rows 0..31 decide on the low halves
                if not r_lo >> q & 1:
                    kw_lo |= 1 << q
                    r_lo |= int(dl[q]) & M32
            for q in range(32):      # then the kept rows' high halves
                if kw_lo >> q & 1:
                    r_hi |= int(dl[q]) >> 32
            for q in range(32):      # the low halves of rows q+32 are 0
                if not r_hi >> q & 1:
                    kw_hi |= 1 << q
                    r_hi |= int(dh[q]) >> 32
            kw = kw_hi << 32 | kw_lo
            for q in range(min(KB, k - base)):
                keep[b, base + q] = (kw >> q) & 1
            if nb + 1 < n:           # the movers, while the chain resolves
                prefetch(nb + 1)
            if kw == 0:
                continue
            k_lo = np.array([(kw >> q) & 1 for q in range(32)], bool)
            k_hi = np.array([(kw >> (q + 32)) & 1 for q in range(32)], bool)
            split = min(n, nb + tile_cols)
            ored = np.zeros(n, int)
            for mw in range(movers):
                for lo, end, from_tile in ((nb + 1, split, True),
                                           (split, n, False)):
                    j0 = first_owned(lo, mw, movers)
                    for jc in range(j0, end, 8 * movers):
                        for j in range(jc, min(jc + 8 * movers, end), movers):
                            w = (cur[(j - nb) * KB:(j - nb + 1) * KB]
                                 if from_tile else m[j, base:base + KB])
                            acc = (np.where(k_lo, w[:32], np.uint64(0))
                                   | np.where(k_hi, w[32:], np.uint64(0)))
                            lo_w = int(np.bitwise_or.reduce(
                                acc & np.uint64(M32)))
                            hi_w = int(np.bitwise_or.reduce(
                                acc >> np.uint64(32)))
                            removed[j] |= hi_w << 32 | lo_w
                            ored[j] += 1
            assert (ored[nb + 1:] == 1).all() and not ored[:nb + 1].any()
    return keep


def _boxes(rng, shape, span=120.0):
    xy = rng.uniform(0, span, shape + (2,))
    wh = rng.uniform(4, 60, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _case(name, b, k, seed):
    """(boxes (B, K, 4) fp32, alive (B, K) bool, optin) for one case."""
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, (b, k))
    alive = rng.uniform(size=(b, k)) > 0.15
    optin = OPTIN_SMEM
    if name == "all_dead":
        alive[1] = False
    elif name == "duplicates":
        src = rng.randint(0, k, (b, k // 3))
        dst = rng.randint(0, k, (b, k // 3))
        for i in range(b):
            boxes[i, dst[i]] = boxes[i, src[i]]
    elif name == "integer":
        # the integer boxes whose IoUs sit exactly on the thresholds
        xy = rng.randint(0, 48, (b, k, 2))
        boxes = np.concatenate([xy, xy + rng.randint(0, 24, (b, k, 2))],
                               -1).astype(np.float32)
    elif name == "dense":
        boxes = np.repeat(_boxes(rng, (b, 4), span=30.0), -(-k // 4),
                          axis=1)[:, :k]
        boxes += rng.uniform(-2, 2, boxes.shape).astype(np.float32)
    elif name == "small_tile":
        # a tile of 2 col blocks: the later columns come from the mask
        optin = ((8 + 2) & ~1) * 8 + 2 * 2 * KB * 8
    return boxes, alive, optin


_CASES = [("random", 1, 1), ("random", 2, 63), ("random", 3, 64),
          ("random", 2, 65), ("random", 3, 130), ("random", 2, 512),
          ("all_dead", 3, 130), ("duplicates", 2, 130), ("integer", 3, 512),
          ("dense", 2, 512), ("small_tile", 2, 512)]


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("name,b,k", _CASES)
def test_word_model_keep_equals_plain_and_jax_sweep(name, b, k, thr):
    boxes, alive, optin = _case(name, b, k, seed=k + b)
    mask = mask_pass(boxes, alive, thr)
    # every word a live row can contribute holds the plain IoU test's bits
    iou = tboxes.bbox_overlaps(torch.from_numpy(boxes),
                               torch.from_numpy(boxes)).numpy() > thr
    n = mask.shape[1]
    bits = (mask[:, :, :, None] >> np.arange(KB, dtype=np.uint64)) & 1
    bits = bits.astype(bool).transpose(0, 2, 1, 3).reshape(b, n * KB, n * KB)
    live = alive[:, :, None] & alive[:, None, :] & np.triu(
        np.ones((k, k), bool), 1)
    np.testing.assert_array_equal(bits[:, :k, :k] & live, iou & live)

    got = reduce_pass(mask, alive, optin)
    tile = min(k, 256)
    want = tnms.suppression_sweep_plain(torch.from_numpy(boxes),
                                        torch.from_numpy(alive), thr,
                                        tile).numpy()
    np.testing.assert_array_equal(got, want)
    want_jax = np.asarray(jnms._suppression_sweep_batched(
        jnp.asarray(boxes), jnp.asarray(alive), thr, tile))
    np.testing.assert_array_equal(got, want_jax)
    if name == "all_dead":
        assert not got[1].any()
    if name == "dense":
        assert got.sum() < alive.sum() / 4      # mostly suppressed


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 188])
def test_tri_pair_covers_the_upper_triangle_in_row_order(n):
    pairs = [tri_pair(t, n) for t in range(n * (n + 1) // 2)]
    assert pairs == [(r, c) for r in range(n) for c in range(r, n)]
