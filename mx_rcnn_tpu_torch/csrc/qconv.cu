// K5 and K6: the quantized convolution (and dense layer) of the inference
// forward, an implicit GEMM over NHWC activations, for Hopper (sm_90a).
//
//   K5 qconv_s8   (built with -DQCONV_FP8=0): int8 x int8, accumulated in
//                 int32 by wgmma.mma_async m64nNk32.s32.s8.s8 (exact sums)
//   K6 qconv_e4m3 (built with -DQCONV_FP8=1): e4m3 x e4m3, widened
//                 exactly to f16 (the weight once a call, A in registers);
//                 each 32-deep partial (two wgmma m64n64k16.f32.f16.f16)
//                 added to fp32 accumulators with __fadd_rn
//
// What it replaces: no Pallas kernel.  The JAX package contracts the
// quantized values with XLA (mx_rcnn_tpu/ops/quant.py:179 — _accum, a
// lax.conv_general_dilated / lax.dot_general with an int32 or fp32
// preferred_element_type, then qconv/qdot's rescale and QuantConv's bias
// and cast, mx_rcnn_tpu/models/layers.py:166-171).  Same function:
//   out[m, n] = cast(float(acc[m, n]) * (x_unit * w_unit[n]) + bias[n])
// with the product of the units first, the bias (optional) added in fp32,
// and one cast to the output type (bf16 or fp32), each step rounded on its
// own (__fmul_rn / __fadd_rn: no contraction into an FMA).  int32 -> fp32
// is round-to-nearest-even (__int2float_rn), as XLA's convert.
//
// GEMM view: M = N*OH*OW output pixels (rows of the NHWC output), N = Cout,
// K = KH*KW*Cin in (kh, kw, cin) order.  Row m of A is gathered from the
// input at (img, oy*sh - pt + kh, ox*sw - pl + kw, cin), zero outside the
// image: the explicit pads (pt, pl) carry flax's asymmetric "SAME" (the
// stride-2 convs pad (2, 3) and (0, 1)).  The weight arrives packed as
// (Cout, Kp) rows in the same (kh, kw, cin) order, zero-padded to Kp, a
// multiple of 32 (ops/quant.py — pack_weight).  A dense layer is the 1x1
// case on a 1x1 map.
//
// What bounds it on an H100: operations (2*M*N*K at 1,979 dense int8/fp8
// TOP/s) or bytes (A and B read once, the output written once, at 3.35
// TB/s), whichever is larger: the per-ROI 1x1 layers by bytes, fc6 and
// the 3x3 layers with deep K by operations.  Only wgmma reaches the
// tensor cores' full rate, and it reads its operands from shared memory,
// so the design is about keeping it fed:
//
// - A block computes BM x BN = 128 x {64, 128, 256} tiles with three
//   warpgroups: a producer that loads, and two consumers that each run
//   wgmma on one 64-row half.  setmaxnreg moves registers from the
//   producer to the consumers.  One block an SM walks the tiles (row
//   tiles fastest, so blocks at work together share B's column tile);
//   the producer loads the next tile while the consumers store this one.
// - K runs through a ring of stages, each 128 bytes deep (four k32
//   steps), rows 128 bytes apart in the 128-byte swizzle that TMA writes
//   and the wgmma descriptors read (16-byte chunk j of row r at chunk
//   j ^ (r % 8)).  Each stage has a full and an empty mbarrier.
// - B, the packed weight, comes by TMA (a 2D tensor map over (Cout, Kp);
//   its out-of-bounds zero fill covers the ragged Cout and K edges): K5's
//   bytes, or for K6 the f16 rows a first, small kernel widens once a
//   call (qconv_kernel_widen_b), two 128-byte atoms a stage.
// - A comes by one of three routes, chosen by the wrapper from the shape
//   (ops/quant.py — qconv_plan):
//     gemm:   1x1 stride-1 convolutions and dense layers, where A is a
//             row-major [M, Cin] matrix: a 2D TMA like B's;
//     gather: the 3x3 and strided convolutions (Cin % 16 == 0): the
//             producer warpgroup's 128 threads issue 16-byte cp.async
//             copies (8 threads a 128-byte row, a row-origin table in
//             shared memory), zero-filled for pads, rows past M and the K
//             tail, written at the swizzled address, each thread's copies
//             signalled to the stage's barrier by cp.async.mbarrier.arrive;
//     bytes:  conv0 (Cin = 3, K = 147): a 16-byte chunk spans taps, so
//             each producer thread gathers its row byte by byte, stores
//             it swizzled, and arrives after a proxy fence.
// - K5's consumers read both operands from the ring (m64nBNk32; BN 256 as
//   two n128 halves) and release each stage one stage late.
// - K6's consumers widen their A fragment in registers (K permuted within
//   each 16-deep block, in the widened B alike, so that a fragment is
//   one 4-byte load a row) and run wgmma with A from registers, n64 at a
//   time.
// - The epilogue stages each consumer's 64 x BN results, 32 columns at a
//   time, through a buffer of its own outside the ring and writes them as
//   16-byte vectors, masking M and Cout.  (Storing straight from the
//   fragments, 4 or 8 bytes a thread and row, was slower.)
//
// Why K6 promotes every 32 deep, and on f16: Hopper's fp8 tensor cores
// keep fewer bits than fp32 when they sum products (about 14, DeepSeek-
// V3's technical report measures, across k32 steps), and within one k32
// step too: the first build of this kernel ran K6 on e4m3 wgmma with a
// zeroed fragment each k32 step and still missed chip_smoke.py —
// check_qconv's bound (K * 2^-24 of the sum of the |products|) at the
// shallow layers (K of a few hundred and less).  e4m3 values are f16
// values exactly, and the f16 tensor cores hold that bound, so each k32
// step runs two k16 wgmmas into a fragment the first one zeroes (scale-d
// 0), added to the fp32 accumulators with __fadd_rn: the sum across steps
// is a true fp32 sum.  Each job (a k32 step of one 64-column half) is
// issued before the last one is waited for, so its adds overlap the next
// wgmma.  The price: the f16 rate (989 TFLOP/s), twice B's bytes, and an
// fp32 add per accumulator each k32 step (as many adds as a k32 wgmma
// does multiply-adds per SM sub-partition).  K5's int32 sums are exact at
// any depth, so K5 accumulates across all of K on the 8-bit tensor cores
// (scale-d 1).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef QCONV_FP8
#error "build with -DQCONV_FP8=0 (K5, int8) or -DQCONV_FP8=1 (K6, e4m3)"
#endif

namespace {

constexpr int BM = 128;        // rows of a tile: two consumers of 64
constexpr int BK = 128;        // bytes of K a stage holds (the swizzle span)
constexpr int THREADS = 384;   // producer, consumer 0, consumer 1
constexpr int A_STAGE = BM * BK;
constexpr int STAGE_BUDGET = 192 * 1024;
constexpr int MAX_STAGES = 6;
constexpr int TABLE_BYTES = BM * 16;   // one int4 row origin a row
// each consumer's epilogue buffer: 64 rows of 32 fp32 columns, padded
constexpr int EPI_PITCH = 32 * 4 + 32;
constexpr int EPI_BYTES = 2 * 64 * EPI_PITCH;

enum Route { ROUTE_GEMM = 0, ROUTE_GATHER = 1, ROUTE_BYTES = 2 };

// ops/quant.py — qconv_plan computes the same numbers
template <int BN>
struct Tile {
  // K6's B is f16 (widened once a call): 128 f16 of K a row, in two
  // 128-byte atoms (k 0-63, 64-127), twice K5's bytes
  static constexpr int B_STAGE = (QCONV_FP8 ? 2 : 1) * BN * BK;
  static constexpr int SLOT = A_STAGE + B_STAGE;
  static constexpr int STAGES =
      STAGE_BUDGET / SLOT < MAX_STAGES ? STAGE_BUDGET / SLOT : MAX_STAGES;
  // 1024 bytes of slack to align the ring for the swizzle, the ring, the
  // row table, the epilogue buffers, each stage's full and empty barriers
  static constexpr int SMEM = 1024 + STAGES * SLOT + TABLE_BYTES +
                              EPI_BYTES + 2 * STAGES * 8;
};

#if QCONV_FP8
typedef float Acc;
#define WG_SHAPE "k16.f32.f16.f16"
#define WG_IMM ", 1, 1, 0, 0"   // scale-a, scale-b, both K-major
#define ACC(i) "+f"(d[i])
#define ACC_REG(r) "+f"(r)
#else
typedef int Acc;
#define WG_SHAPE "k32.s32.s8.s8"
#define WG_IMM ""
#define ACC(i) "+r"(d[i])
#define ACC_REG(r) "+r"(r)
#endif

struct Params {
  const uint8_t* x;       // (n, h, w, c) NHWC
  const float* x_unit;    // one fp32
  const float* w_unit;    // (cout,)
  const float* bias;      // (cout,) or null
  void* out;              // (n, oh, ow, cout), bf16 or fp32
  int out_bf16;
  int n, h, w, c, oh, ow, cout, kh, kw, sh, sw, pt, pl, kp, ktot, m, ktiles;
  int row_tiles, tiles;   // the tiles' grid: BM-row tiles by BN-column ones
};

// tile t of a block's walk (t = blockIdx.x, + gridDim.x, ...): row tiles
// fastest, so the blocks at work at one time share B's column tile
__device__ __forceinline__ void tile_origin(const Params& p, int t, int bn,
                                            int& m0, int& n0) {
  const int nt = t / p.row_tiles;
  m0 = (t - nt * p.row_tiles) * BM;
  n0 = nt * bn;
}

// ---- shared memory, barriers, copies -------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// waits for the phase of parity `parity` to complete; a pipeline that
// never completes it (a fault in this file) traps after ~10 s of clocks
// instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int inner, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"((uint64_t)map), "r"(bar), "r"(inner), "r"(row)
      : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// the barrier's phase completes once this thread's earlier cp.asyncs land
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(bar) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- wgmma -------------------------------------------------------------

// a K-major operand in the 128-byte swizzle: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of an accumulator across a wait
__device__ __forceinline__ void fence_reg(Acc& r) {
  asm volatile("" : ACC_REG(r)::"memory");
}

// d (+)= A . B^T over one k step, B (N x 32 bytes) from shared memory by
// descriptor db: K5 k32 of int8 with A (64 x 32 bytes) by descriptor da,
// K6 k16 of f16 with A's fragment in registers; scale_d 0 writes d
#if QCONV_FP8
__device__ __forceinline__ void wgmma_rs_n64(Acc (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64" WG_SHAPE " "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : ACC(0), ACC(1), ACC(2), ACC(3), ACC(4), ACC(5), ACC(6), ACC(7),
        ACC(8), ACC(9), ACC(10), ACC(11), ACC(12), ACC(13), ACC(14), ACC(15),
        ACC(16), ACC(17), ACC(18), ACC(19), ACC(20), ACC(21), ACC(22), ACC(23),
        ACC(24), ACC(25), ACC(26), ACC(27), ACC(28), ACC(29), ACC(30), ACC(31)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}
#else
__device__ __forceinline__ void wgmma_n64(Acc (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64" WG_SHAPE " "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p" WG_IMM ";\n}\n"
      : ACC(0), ACC(1), ACC(2), ACC(3), ACC(4), ACC(5), ACC(6), ACC(7),
        ACC(8), ACC(9), ACC(10), ACC(11), ACC(12), ACC(13), ACC(14), ACC(15),
        ACC(16), ACC(17), ACC(18), ACC(19), ACC(20), ACC(21), ACC(22), ACC(23),
        ACC(24), ACC(25), ACC(26), ACC(27), ACC(28), ACC(29), ACC(30), ACC(31)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(Acc (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128" WG_SHAPE " "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p" WG_IMM ";\n}\n"
      : ACC(0), ACC(1), ACC(2), ACC(3), ACC(4), ACC(5), ACC(6), ACC(7),
        ACC(8), ACC(9), ACC(10), ACC(11), ACC(12), ACC(13), ACC(14), ACC(15),
        ACC(16), ACC(17), ACC(18), ACC(19), ACC(20), ACC(21), ACC(22), ACC(23),
        ACC(24), ACC(25), ACC(26), ACC(27), ACC(28), ACC(29), ACC(30), ACC(31),
        ACC(32), ACC(33), ACC(34), ACC(35), ACC(36), ACC(37), ACC(38), ACC(39),
        ACC(40), ACC(41), ACC(42), ACC(43), ACC(44), ACC(45), ACC(46), ACC(47),
        ACC(48), ACC(49), ACC(50), ACC(51), ACC(52), ACC(53), ACC(54), ACC(55),
        ACC(56), ACC(57), ACC(58), ACC(59), ACC(60), ACC(61), ACC(62), ACC(63)
      : "l"(da), "l"(db), "r"(scale_d));
}
#endif

// one wgmma of width N (64 or 128) over the fragment d
#if !QCONV_FP8
template <int N>
__device__ __forceinline__ void wgmma(Acc (&d)[N / 2], uint64_t da,
                                      uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wgmma_n64(d, da, db, scale_d);
  else
    wgmma_n128(d, da, db, scale_d);
}
#endif

// the accumulator's value: K5's int32 rounded once, K6's fp32 as it is
#if QCONV_FP8
__device__ __forceinline__ float to_float(float v) { return v; }
#else
__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }
#endif

// ---- shared memory -----------------------------------------------------

template <int BN>
struct Smem {
  uint8_t* a;          // STAGES x (BM x BK)
  uint8_t* b;          // STAGES x B_STAGE
  int4* table;         // BM row origins: byte offset of the image, iy0, ix0
  uint8_t* epi;        // the consumers' epilogue buffers
  // shared addresses of each stage's barriers: full (A and B landed),
  // empty (the consumers are done with the stage)
  uint32_t full, empty;

  __device__ __forceinline__ explicit Smem(uint8_t* base) {
    constexpr int S = Tile<BN>::STAGES;
    a = base;
    b = a + S * A_STAGE;
    table = (int4*)(b + S * Tile<BN>::B_STAGE);
    epi = (uint8_t*)(table + BM);
    full = smem_u32(epi + EPI_BYTES);
    empty = full + 8 * S;
  }
};

// ---- the producer ------------------------------------------------------

// Loads stage kt of A and B into 8-bit slot kt % STAGES and arrives on its
// full barrier; the caller has made sure the slot is free.  The gather
// routes walk K one stage at a time, so stages load in order.
template <int BN, int ROUTE>
struct Loader {
  int k, ci, kx, ky;   // the gather's place in K: this thread's next byte

  // a tile's start: the row-origin table of the gather routes, one row a
  // thread (once every thread is done with the last tile's), rows past M
  // out of every image; the walk back to k = 0
  __device__ __forceinline__ void begin(const Params& p, const Smem<BN>& sm,
                                        int lt, int m0) {
    if (ROUTE == ROUTE_GEMM) return;
    bar_sync(1, 128);
    const int m = m0 + lt;
    int4 r = make_int4(0, -(1 << 20), 0, 0);
    if (m < p.m) {
      const int per_img = p.oh * p.ow;
      const int img = m / per_img;
      const int rem = m - img * per_img;
      const int oy = rem / p.ow;
      const int ox = rem - oy * p.ow;
      r = make_int4(img * p.h * p.w * p.c, oy * p.sh - p.pt,
                    ox * p.sw - p.pl, 0);
    }
    sm.table[lt] = r;
    bar_sync(1, 128);
    // gather: this thread's 16-byte chunk j of rows lt / 8 + 16 i (eight
    // threads copy one 128-byte row); Cin % 16 == 0, so the chunk's 16
    // bytes share one tap (ky, kx), from channel ci on.  bytes: row lt,
    // byte by byte from k = 0.
    k = ROUTE == ROUTE_GATHER ? 16 * (lt & 7) : 0;
    const int tap = k / p.c;
    ci = k - tap * p.c;
    ky = tap / p.kw;
    kx = tap - ky * p.kw;
  }

  __device__ __forceinline__ void load(const Params& p,
                                       const CUtensorMap* tm_a,
                                       const CUtensorMap* tm_b,
                                       const Smem<BN>& sm, int lt, int m0,
                                       int n0, int kt, int s) {
    const uint32_t full = sm.full + 8 * s;
    uint8_t* a = sm.a + s * A_STAGE;
    if (lt == 0) {
      mbar_expect_tx(full, (ROUTE == ROUTE_GEMM ? A_STAGE : 0) +
                               Tile<BN>::B_STAGE);
      if (ROUTE == ROUTE_GEMM) tma_load(smem_u32(a), tm_a, full, kt * BK, m0);
      // K5: 128 bytes of K; K6: its two f16 atoms, 64 of K each
      const uint32_t b = smem_u32(sm.b + s * Tile<BN>::B_STAGE);
      tma_load(b, tm_b, full, kt * BK, n0);
      if (QCONV_FP8) tma_load(b + BN * BK, tm_b, full, kt * BK + 64, n0);
    }
    if (ROUTE == ROUTE_GATHER) {
      const int j = lt & 7, rsub = lt >> 3;
      // (rsub + 16 i) % 8 == rsub % 8: one swizzled chunk for all 8 rows
      const uint32_t dst =
          smem_u32(a) + (uint32_t)(rsub * BK + ((j ^ (rsub & 7)) << 4));
      const bool kin = k < p.ktot;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int4 r = sm.table[rsub + 16 * i];
        const int iy = r.y + ky, ix = r.z + kx;
        const bool ok = kin && (unsigned)iy < (unsigned)p.h &&
                        (unsigned)ix < (unsigned)p.w;
        const uint8_t* src =
            ok ? p.x + r.x + (iy * p.w + ix) * p.c + ci : p.x;
        cp_async16(dst + i * 16 * BK, src, ok);
      }
      cp_async_arrive(full);
      // one stage on: 128 bytes further in K
      k += BK;
      ci += BK;
      while (ci >= p.c) {
        ci -= p.c;
        if (++kx == p.kw) {
          kx = 0;
          ++ky;
        }
      }
    } else if (ROUTE == ROUTE_BYTES) {
      const int4 r = sm.table[lt];
      uint8_t* row = a + lt * BK;
      for (int q = 0; q < BK / 16; ++q) {
        uint32_t v[4];
#pragma unroll
        for (int wd = 0; wd < 4; ++wd) {
          uint32_t word = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int iy = r.y + ky, ix = r.z + kx;
            if (k < p.ktot && (unsigned)iy < (unsigned)p.h &&
                (unsigned)ix < (unsigned)p.w)
              word |= (uint32_t)p.x[r.x + (iy * p.w + ix) * p.c + ci]
                      << (8 * b);
            ++k;
            if (++ci == p.c) {
              ci = 0;
              if (++kx == p.kw) {
                kx = 0;
                ++ky;
              }
            }
          }
          v[wd] = word;
        }
        *(uint4*)(row + ((q ^ (lt & 7)) << 4)) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
      // generic-proxy stores, read by wgmma through the async proxy
      fence_proxy_async();
      mbar_arrive(full);
    }
  }

  __device__ __forceinline__ void finish() {
    if (ROUTE == ROUTE_GATHER)
      asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
};

#if QCONV_FP8
// two e4m3 (the low 16 bits of v) as two f16, exactly; e4m3's values are
// f16 values.  (Moving the bits with integer operations instead, exact
// at a 2^-8 scale, was slower on the H100.)
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t v) {
  uint32_t d;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(d) : "h"((uint16_t)v));
  return d;
}

// acc += part, element by element, each add rounded once in fp32
__device__ __forceinline__ void add_partial(float (&acc)[32],
                                            float (&part)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    fence_reg(part[i]);
    acc[i] = __fadd_rn(acc[i], part[i]);
  }
}

// K6 runs K permuted within each 16-deep block, in A's fragment and in
// the widened B alike: fragment position 2t + e holds k = 4t + e and
// position 2t + 8 + e holds k = 4t + 2 + e (t < 4, e < 2), so that a
// thread's A fragment of a row is one 4-byte load (k 4t .. 4t + 3).
//
// B widened once a call, before the contraction: each 16-deep block of a
// packed row (16 e4m3 bytes, as words w0..w3) becomes 16 f16 in that
// order, positions 0-7 the words' low halves, 8-15 their high halves.
// (Widening each landed stage in every block instead repeated the work
// once per row tile.)  Its name starts with the contraction's, so a
// profile counts both as K6.
__global__ void qconv_kernel_widen_b(const uint4* wt, uint4* w16,
                                     int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= chunks) return;
  const uint4 q = wt[i];
  w16[2 * i] = make_uint4(e4m3x2_to_f16x2(q.x), e4m3x2_to_f16x2(q.y),
                          e4m3x2_to_f16x2(q.z), e4m3x2_to_f16x2(q.w));
  w16[2 * i + 1] =
      make_uint4(e4m3x2_to_f16x2(q.x >> 16), e4m3x2_to_f16x2(q.y >> 16),
                 e4m3x2_to_f16x2(q.z >> 16), e4m3x2_to_f16x2(q.w >> 16));
}
#endif

template <int BN, int ROUTE>
__device__ __forceinline__ void produce(const Params& p,
                                        const CUtensorMap* tm_a,
                                        const CUtensorMap* tm_b,
                                        const Smem<BN>& sm, int lt) {
  constexpr int S = Tile<BN>::STAGES;
  Loader<BN, ROUTE> ld;
  int m0 = 0, n0 = 0;
  // the ring's stages are numbered across the block's tiles: stage g in
  // slot g % S, its (g / S)-th use
  if (ROUTE == ROUTE_GEMM && lt != 0) return;
  int g = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    tile_origin(p, t, BN, m0, n0);
    ld.begin(p, sm, lt, m0);
    for (int kt = 0; kt < p.ktiles; ++kt, ++g) {
      if (g >= S) mbar_wait(sm.empty + 8 * (g % S), ((g / S) - 1) & 1);
      ld.load(p, tm_a, tm_b, sm, lt, m0, n0, kt, g % S);
    }
  }
  ld.finish();
}

// ---- the consumers -----------------------------------------------------

// the epilogue of 64 rows x NJ n8 blocks of one warpgroup's fragment:
// rescale, bias, one cast, staged 32 columns at a time through the
// warpgroup's buffer and stored as 16-byte vectors
template <int NJ>
__device__ __forceinline__ void store_tile(const Params& p, const Acc* acc,
                                           float xu, uint8_t* buf, int wg,
                                           int lt, int m0, int n0) {
  const int warp = lt >> 5, lane = lt & 31;
  const int esz = p.out_bf16 ? 2 : 4;
  const int pitch = 32 * esz + 8 * esz;   // no bank conflict either way
  const int vrow = 32 * esz / 16;         // 16-byte vectors a row
  const bool vec = (p.cout * esz) % 16 == 0;
#pragma unroll
  for (int c4 = 0; c4 < NJ / 4; ++c4) {
    const int c0 = n0 + 32 * c4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = 4 * c4 + j;
      const int col = 8 * j + 2 * (lane & 3);
      const int gc = c0 + col;
      float s0 = 0.0f, s1 = 0.0f, b0v = 0.0f, b1v = 0.0f;
      if (gc < p.cout) {
        s0 = __fmul_rn(xu, p.w_unit[gc]);
        if (p.bias) b0v = p.bias[gc];
      }
      if (gc + 1 < p.cout) {
        s1 = __fmul_rn(xu, p.w_unit[gc + 1]);
        if (p.bias) b1v = p.bias[gc + 1];
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * warp + (lane >> 2) + 8 * hr;
        float y0 = __fmul_rn(to_float(acc[4 * jj + 2 * hr]), s0);
        float y1 = __fmul_rn(to_float(acc[4 * jj + 2 * hr + 1]), s1);
        if (p.bias) {
          y0 = __fadd_rn(y0, b0v);
          y1 = __fadd_rn(y1, b1v);
        }
        uint8_t* at = buf + row * pitch + col * esz;
        if (p.out_bf16)
          *(__nv_bfloat162*)at = __halves2bfloat162(__float2bfloat16_rn(y0),
                                                    __float2bfloat16_rn(y1));
        else
          *(float2*)at = make_float2(y0, y1);
      }
    }
    bar_sync(3 + wg, 128);
    const int valid = min(32, p.cout - c0) * esz;
    for (int v = lt; v < 64 * vrow; v += 128) {
      const int row = v / vrow, cb = (v - row * vrow) * 16;
      const int gm = m0 + wg * 64 + row;
      if (gm < p.m && cb < valid) {
        uint8_t* dst = (uint8_t*)p.out + ((size_t)gm * p.cout + c0) * esz + cb;
        const uint8_t* src = buf + row * pitch + cb;
        if (vec && cb + 16 <= valid) {
          *(uint4*)dst = *(const uint4*)src;
        } else {
          for (int e = 0; e < 16 && cb + e < valid; e += esz) {
            if (esz == 2)
              *(uint16_t*)(dst + e) = *(const uint16_t*)(src + e);
            else
              *(uint32_t*)(dst + e) = *(const uint32_t*)(src + e);
          }
        }
      }
    }
    bar_sync(3 + wg, 128);
  }
}

template <int BN, int ROUTE>
__device__ __forceinline__ void consume(const Params& p, const Smem<BN>& sm,
                                        int wg, int lt) {
  constexpr int S = Tile<BN>::STAGES;
  const int warp = lt >> 5, lane = lt & 31;
  // this thread's fragment rows: r and r + 8 of the tile
  const int r = wg * 64 + 16 * warp + (lane >> 2);
  const float xu = *p.x_unit;
  uint8_t* buf = sm.epi + wg * 64 * EPI_PITCH;
  int g = 0;   // stages consumed, numbered as the producer's
#if QCONV_FP8
  // K6 runs n64 wgmmas: a job is one k32 step of one 64-column half, into
  // scratch fragment j % 2.  Job j is issued before job j - 1 is waited
  // for and added, so one half's fp32 adds overlap the other's wgmma (BN
  // 128), or one step's the next's (BN 64); the pipe drains once a stage.
  constexpr int HALVES = BN / 64, JOBS = 4 * HALVES;
  Acc acc[HALVES][32], part[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) part[0][i] = part[1][i] = 0;
  // this thread's 4 bytes of each 16-deep block of its A rows: k 4t ..
  // 4t + 3 (see qconv_kernel_widen_b)
  const uint32_t row0 = (uint32_t)(r * BK + 4 * (lane & 3));
  const uint32_t row1 = row0 + 8 * BK;
  const int sw = r & 7;   // (r + 8) % 8 too
  const uint32_t b0 = smem_u32(sm.b);
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0;
    for (int kt = 0; kt < p.ktiles; ++kt, ++g) {
      const int s = g % S;
      mbar_wait(sm.full + 8 * s, (g / S) & 1);
      const uint8_t* a = sm.a + s * A_STAGE;
      const uint64_t db = sw128_desc(b0 + s * Tile<BN>::B_STAGE);
      uint32_t af[2][4];
#pragma unroll
      for (int j = 0; j < JOBS; ++j) {
        const int kk = j / HALVES, h = j % HALVES;
        if (h == 0) {
          // A's fragments of k16 steps 2 kk and 2 kk + 1, widened
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t chunk = (uint32_t)(((2 * kk + e) ^ sw) << 4);
            const uint32_t x0 = *(const uint32_t*)(a + row0 + chunk);
            const uint32_t x1 = *(const uint32_t*)(a + row1 + chunk);
            af[e][0] = e4m3x2_to_f16x2(x0);
            af[e][1] = e4m3x2_to_f16x2(x1);
            af[e][2] = e4m3x2_to_f16x2(x0 >> 16);
            af[e][3] = e4m3x2_to_f16x2(x1 >> 16);
          }
        }
        // the k32 step into a fragment its first k16 wgmma zeroes
        // (scale-d 0); k16 step q reads B atom q / 4 at 32 bytes a step,
        // half h 64 rows on
        wgmma_fence();
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 2 * kk + e;
          wgmma_rs_n64(part[j % 2], af[e],
                       db + (q >> 2) * (BN * BK >> 4) + h * (64 * BK >> 4) +
                           2 * (q & 3),
                       e);
        }
        wgmma_commit();
        if (j > 0) {
          // job j - 1 is done: add its k32 partial in fp32
          wgmma_wait<1>();
          add_partial(acc[(j - 1) % HALVES], part[(j - 1) % 2]);
        }
      }
      wgmma_wait<0>();
      add_partial(acc[(JOBS - 1) % HALVES], part[(JOBS - 1) % 2]);
      if (lt == 0) mbar_arrive(sm.empty + 8 * s);
    }
    int m0, n0;
    tile_origin(p, t, BN, m0, n0);
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
      store_tile<8>(p, acc[h], xu, buf, wg, lt, m0, n0 + 64 * h);
  }
#else
  constexpr int WN = BN == 64 ? 64 : 128;   // one wgmma's width
  constexpr int NH = BN / WN;               // wgmmas a k32 step
  Acc acc[NH][WN / 2];
  const uint32_t a0 = smem_u32(sm.a) + wg * 64 * BK;
  const uint32_t b0 = smem_u32(sm.b);
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) acc[h][i] = 0;
    for (int kt = 0; kt < p.ktiles; ++kt, ++g) {
      const int s = g % S;
      mbar_wait(sm.full + 8 * s, (g / S) & 1);
      // cp.async writes through the generic proxy; wgmma reads through
      // the async one
      if (ROUTE == ROUTE_GATHER) fence_proxy_async();
      const uint64_t da = sw128_desc(a0 + s * A_STAGE);
      const uint64_t db = sw128_desc(b0 + s * Tile<BN>::B_STAGE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
        for (int h = 0; h < NH; ++h)
          wgmma<WN>(acc[h], da + 2 * kk, db + h * (WN * BK >> 4) + 2 * kk,
                    1);
      wgmma_commit();
      // the stage before this one is read: release it
      wgmma_wait<1>();
      if (kt > 0 && lt == 0) mbar_arrive(sm.empty + 8 * ((g - 1) % S));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) fence_reg(acc[h][i]);
    if (lt == 0) mbar_arrive(sm.empty + 8 * ((g - 1) % S));
    int m0, n0;
    tile_origin(p, t, BN, m0, n0);
#pragma unroll
    for (int h = 0; h < NH; ++h)
      store_tile<WN / 8>(p, acc[h], xu, buf, wg, lt, m0, n0 + WN * h);
  }
#endif
}

template <int BN, int ROUTE>
__global__ void __launch_bounds__(THREADS, 1)
    qconv_kernel(const Params p, const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes: align the rings to it
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Smem<BN> sm(base);
  if (threadIdx.x == 0) {
    // full: the TMA's arrival (and in the gather routes, one a producer
    // thread); empty: one a consumer warpgroup
    for (int s = 0; s < Tile<BN>::STAGES; ++s) {
      mbar_init(sm.full + 8 * s, ROUTE == ROUTE_GEMM ? 1 : 129);
      mbar_init(sm.empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, lt = threadIdx.x & 127;
  if (wg == 0) {
    // 128 x 40 + 256 x 232 <= the SM's 65,536
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    produce<BN, ROUTE>(p, &tm_a, &tm_b, sm, lt);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume<BN, ROUTE>(p, sm, wg - 1, lt);
  }
}

// ---- host side ---------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime: the library
// needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found =
        cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                            cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// error codes past cudaError's: the encoder's CUresult, offset
constexpr int ENCODE_ERROR = 1000;

// a (rows, inner) matrix of 1- or 2-byte elements in boxes of 128 bytes
// by box_rows, 128-byte swizzle, zero fill out of bounds
int tile_map(CUtensorMap* map, const void* ptr, int esize, int inner,
             int rows, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(BK / esize), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map,
                         esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                    : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                         2,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

// the card's SMs: one block each walks the tiles
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// B: K5's packed bytes, or K6's widened f16 rows
template <int BN, int ROUTE>
int launch_tile(Params p, const void* b, int stages, cudaStream_t stream) {
  if (stages != Tile<BN>::STAGES) return (int)cudaErrorInvalidValue;
  p.row_tiles = (p.m + BM - 1) / BM;
  const long long tiles =
      (long long)p.row_tiles * ((p.cout + BN - 1) / BN);
  const int sms = sm_count();
  if (tiles >= (1LL << 31) || sms <= 0) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  const dim3 grid((unsigned)(p.tiles < sms ? p.tiles : sms));
  CUtensorMap tm_a, tm_b;
  int rc = tile_map(&tm_b, b, QCONV_FP8 ? 2 : 1, p.kp, p.cout, BN);
  if (rc) return rc;
  if (ROUTE == ROUTE_GEMM)
    rc = tile_map(&tm_a, p.x, 1, p.c, p.m, BM);
  else
    tm_a = tm_b;   // unused
  if (rc) return rc;
  auto kernel = qconv_kernel<BN, ROUTE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, Tile<BN>::SMEM, stream>>>(p, tm_a, tm_b);
  return (int)cudaGetLastError();
}

int launch(const Params& p, const void* wt, void* w16, int route, int bn,
           int stages, cudaStream_t s) {
#if QCONV_FP8
  // widen B once for every block: (cout, kp) e4m3 -> f16, 16 bytes a
  // thread
  if (w16 == nullptr || (uintptr_t)wt % 16 || (uintptr_t)w16 % 16)
    return (int)cudaErrorInvalidValue;
  const int chunks = p.cout * (p.kp / 16);
  qconv_kernel_widen_b<<<(chunks + 255) / 256, 256, 0, s>>>(
      (const uint4*)wt, (uint4*)w16, chunks);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const void* b = w16;
#else
  const void* b = wt;
#endif
  // the tile shapes the wrapper may ask for: K6 keeps BN <= 128, conv0's
  // byte route needs no BN 256
#define QCONV_TILE(BN, ROUTE)    \
  if (bn == BN && route == ROUTE) \
    return launch_tile<BN, ROUTE>(p, b, stages, s);
  QCONV_TILE(64, ROUTE_GEMM)
  QCONV_TILE(64, ROUTE_GATHER)
  QCONV_TILE(64, ROUTE_BYTES)
  QCONV_TILE(128, ROUTE_GEMM)
  QCONV_TILE(128, ROUTE_GATHER)
  QCONV_TILE(128, ROUTE_BYTES)
#if !QCONV_FP8
  QCONV_TILE(256, ROUTE_GEMM)
  QCONV_TILE(256, ROUTE_GATHER)
#endif
#undef QCONV_TILE
  return (int)cudaErrorInvalidValue;
}

int fill(Params& p, const void* x, const float* x_unit, const float* w_unit,
         const float* bias, void* out, int out_bf16, int n, int h, int w,
         int c, int oh, int ow, int cout, int kh, int kw, int sh, int sw,
         int pt, int pl, int kp, int route) {
  p.x = (const uint8_t*)x;
  p.x_unit = x_unit;
  p.w_unit = w_unit;
  p.bias = bias;
  p.out = out;
  p.out_bf16 = out_bf16;
  p.n = n; p.h = h; p.w = w; p.c = c; p.oh = oh; p.ow = ow; p.cout = cout;
  p.kh = kh; p.kw = kw; p.sh = sh; p.sw = sw; p.pt = pt; p.pl = pl;
  p.kp = kp;
  p.ktot = kh * kw * c;
  p.ktiles = (kp + BK - 1) / BK;
  const long long m = (long long)n * oh * ow;
  if (m <= 0 || m >= (1LL << 31) || kp % 32 || kp < p.ktot || cout <= 0)
    return (int)cudaErrorInvalidValue;
  p.m = (int)m;
  // the copies' alignment: 16-byte chunks (gather), TMA rows (gemm)
  const bool c16 = c % 16 == 0 && (uintptr_t)x % 16 == 0;
  const bool one = kh == 1 && kw == 1 && sh == 1 && sw == 1 && pt == 0 &&
                   pl == 0 && oh == h && ow == w;
  if ((route == ROUTE_GEMM && !(c16 && one)) ||
      (route == ROUTE_GATHER && !c16) ||
      route < ROUTE_GEMM || route > ROUTE_BYTES)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// x: (n, h, w, c) int8 or e4m3 NHWC; wt: (cout, kp) packed rows; x_unit:
// one fp32 on the device; w_unit, bias (nullable): (cout,) fp32; out:
// (n, oh, ow, cout) bf16 if out_bf16 else fp32; route (0 gemm, 1 gather,
// 2 bytes), bn and stages: the tile plan (ops/quant.py — qconv_plan);
// w16: K6's scratch for the widened weight, (cout, kp) f16 (K5: null).
// Launches on `stream` and returns cudaGetLastError(), or a refusal
// (cudaErrorInvalidValue for a plan or shape the kernel does not take,
// 1000 + the CUresult for a tensor map cuTensorMapEncodeTiled refuses).
#if QCONV_FP8
#define QCONV_NAME qconv_e4m3_launch
#else
#define QCONV_NAME qconv_s8_launch
#endif
extern "C" int QCONV_NAME(const void* x, const void* wt, const float* x_unit,
                          const float* w_unit, const float* bias, void* out,
                          int out_bf16, int n, int h, int w, int c, int oh,
                          int ow, int cout, int kh, int kw, int sh, int sw,
                          int pt, int pl, int kp, int route, int bn,
                          int stages, void* w16, void* stream) {
  Params p;
  const int rc = fill(p, x, x_unit, w_unit, bias, out, out_bf16, n, h, w, c,
                      oh, ow, cout, kh, kw, sh, sw, pt, pl, kp, route);
  if (rc) return rc;
  return launch(p, wt, w16, route, bn, stages, (cudaStream_t)stream);
}
