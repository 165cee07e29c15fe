// K5 and K6: the quantized convolution (and dense layer) of the inference
// forward, an implicit GEMM over NHWC activations.
//
//   K5 qconv_s8:   int8 x int8, accumulated in int32 on the tensor cores
//                  (mma.sync.m16n8k32.s32.s8.s8.s32: exact integer sums)
//   K6 qconv_e4m3: e4m3 x e4m3, accumulated in fp32
//                  (mma.sync.m16n8k32.f32.e4m3.e4m3.f32)
//
// No Pallas counterpart: the JAX package contracts the quantized values
// with XLA (mx_rcnn_tpu/ops/quant.py:179-226 — _accum through
// lax.conv_general_dilated / lax.dot_general with an int32 or fp32
// preferred_element_type, then qconv/qdot's rescale, and QuantConv's bias
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
// multiple of 32 (ops/quant.py — pack_weight), so a B tile never needs a
// bound on k; A's tail past K is zero-filled.  A dense layer is the 1x1
// case on a 1x1 map.
//
// Design (the simple first version): a block computes a 128 x 64 output
// tile with 4 warps, each 64 x 32 as 4 x 4 mma tiles of 16 x 8, stepping
// K by 32.  A and B tiles go through shared memory, double-buffered:
// cp.async (16 bytes, zero-fill for padding, past-the-end rows and the K
// tail) fetches tile k+1 while tile k is multiplied.  Rows are 48 bytes
// apart in shared memory, so the fragment loads of a warp hit 32 distinct
// banks.  When Cin is not a multiple of 16 (conv0's Cin = 3: K = 147)
// a 16-byte chunk of A spans several taps, and A is gathered byte by byte
// instead.  K6 adds each 32-deep partial product to its fp32 accumulator
// with an ordinary add, so the sum across tiles is a true fp32 sum.
//
// What bounds it on an H100: at the backbone's and head's shapes,
// operations (2*M*N*K at 1979 dense int8/fp8 TOP/s) against bytes (A and
// B read once, the output written once, at 3.35 TB/s).  mma.sync reaches
// a fraction of the wgmma rate, and the loads are not pipelined deeper
// than two tiles; wgmma with TMA is the follow-on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int LDS = 48;   // shared row stride, bytes
constexpr int THREADS = 128;

struct Params {
  const uint8_t* x;       // (n, h, w, c) NHWC
  const uint8_t* wt;      // (cout, kp)
  const float* x_unit;    // one fp32
  const float* w_unit;    // (cout,)
  const float* bias;      // (cout,) or null
  void* out;              // (n, oh, ow, cout), bf16 or fp32
  int out_bf16;
  int n, h, w, c, oh, ow, cout, kh, kw, sh, sw, pt, pl, kp, ktot, m;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ uint32_t ld_shared32(const uint8_t* p) {
  return *(const uint32_t*)p;
}

template <bool FP8>
struct Mma;

template <>
struct Mma<false> {
  typedef int Acc;
  __device__ __forceinline__ static void run(Acc (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ __forceinline__ static float to_float(Acc v) {
    return __int2float_rn(v);
  }
};

template <>
struct Mma<true> {
  typedef float Acc;
  __device__ __forceinline__ static void run(Acc (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    float d0, d1, d2, d3;
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
        : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
    c[0] = __fadd_rn(c[0], d0);
    c[1] = __fadd_rn(c[1], d1);
    c[2] = __fadd_rn(c[2], d2);
    c[3] = __fadd_rn(c[3], d3);
  }
  __device__ __forceinline__ static float to_float(Acc v) { return v; }
};

// One output row's gather origin.
struct RowSrc {
  const uint8_t* base;  // the row's image
  int iy0, ix0;
  bool valid;
};

__device__ __forceinline__ RowSrc row_src(const Params& p, int m) {
  RowSrc r;
  r.valid = m < p.m;
  const int mm = r.valid ? m : 0;
  const int per_img = p.oh * p.ow;
  const int img = mm / per_img;
  const int rem = mm - img * per_img;
  const int oy = rem / p.ow;
  const int ox = rem - oy * p.ow;
  r.iy0 = oy * p.sh - p.pt;
  r.ix0 = ox * p.sw - p.pl;
  r.base = p.x + (size_t)img * p.h * p.w * p.c;
  return r;
}

// The 16 bytes of A at (row, k .. k+15), gathered one by one (any Cin).
__device__ __forceinline__ uint4 gather16(const Params& p, const RowSrc& r,
                                          int k) {
  uint8_t v[16];
#pragma unroll 4
  for (int j = 0; j < 16; ++j) {
    const int kk = k + j;
    uint8_t b = 0;
    if (r.valid && kk < p.ktot) {
      const int tap = kk / p.c;
      const int ci = kk - tap * p.c;
      const int ky = tap / p.kw;
      const int kx = tap - ky * p.kw;
      const int iy = r.iy0 + ky, ix = r.ix0 + kx;
      if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w)
        b = r.base[((size_t)iy * p.w + ix) * p.c + ci];
    }
    v[j] = b;
  }
  uint4 out;
  uint8_t* o = (uint8_t*)&out;
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j] = v[j];
  return out;
}

template <bool FP8, bool VEC>
__global__ void __launch_bounds__(THREADS)
    qconv_kernel(const Params p) {
  __shared__ __align__(16) uint8_t As[2][BM * LDS];
  __shared__ __align__(16) uint8_t Bs[2][BN * LDS];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int half = tid & 1;
  const int kc = half * 16;
  // this thread's two A rows and one B row, fixed over the K loop
  const int ar0 = tid >> 1, ar1 = (tid >> 1) + 64;
  const RowSrc r0 = row_src(p, m0 + ar0);
  const RowSrc r1 = row_src(p, m0 + ar1);
  const int br = tid >> 1;
  const bool bvalid = n0 + br < p.cout;
  const uint8_t* bsrc = p.wt + (size_t)(bvalid ? n0 + br : 0) * p.kp + kc;

  auto load_tile = [&](int kt, int buf) {
    const int k = kt * BK + kc;
    uint8_t* a0 = &As[buf][ar0 * LDS + kc];
    uint8_t* a1 = &As[buf][ar1 * LDS + kc];
    if (VEC) {
      // Cin % 16 == 0: the 16 bytes share one tap and are contiguous
      bool in = k < p.ktot;
      int ky = 0, kx = 0, ci = 0;
      if (in) {
        const int tap = k / p.c;
        ci = k - tap * p.c;
        ky = tap / p.kw;
        kx = tap - ky * p.kw;
      }
      {
        const int iy = r0.iy0 + ky, ix = r0.ix0 + kx;
        const bool ok = in && r0.valid && iy >= 0 && iy < p.h && ix >= 0 &&
                        ix < p.w;
        cp_async16(a0, ok ? r0.base + ((size_t)iy * p.w + ix) * p.c + ci
                          : p.x, ok);
      }
      {
        const int iy = r1.iy0 + ky, ix = r1.ix0 + kx;
        const bool ok = in && r1.valid && iy >= 0 && iy < p.h && ix >= 0 &&
                        ix < p.w;
        cp_async16(a1, ok ? r1.base + ((size_t)iy * p.w + ix) * p.c + ci
                          : p.x, ok);
      }
    } else {
      *(uint4*)a0 = gather16(p, r0, k);
      *(uint4*)a1 = gather16(p, r1, k);
    }
    cp_async16(&Bs[buf][br * LDS + kc], bsrc + (size_t)kt * BK, bvalid);
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;

  typename Mma<FP8>::Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  const int ktiles = p.kp / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load_tile(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const uint8_t* a_s = As[kt & 1];
    const uint8_t* b_s = Bs[kt & 1];
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const uint8_t* row = a_s + (wm * 64 + mi * 16 + g) * LDS + t * 4;
      af[mi][0] = ld_shared32(row);
      af[mi][1] = ld_shared32(row + 8 * LDS);
      af[mi][2] = ld_shared32(row + 16);
      af[mi][3] = ld_shared32(row + 8 * LDS + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint8_t* col = b_s + (wn * 32 + ni * 8 + g) * LDS + t * 4;
      bf[ni][0] = ld_shared32(col);
      bf[ni][1] = ld_shared32(col + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) Mma<FP8>::run(acc[mi][ni], af[mi], bf[ni]);
    __syncthreads();
  }

  // epilogue: rescale, bias, one cast
  const float xu = *p.x_unit;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = n0 + wn * 32 + ni * 8 + t * 2 + q;
      if (col >= p.cout) continue;
      const float s = __fmul_rn(xu, p.w_unit[col]);
      const float b = p.bias ? p.bias[col] : 0.0f;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int hrow = 0; hrow < 2; ++hrow) {
          const int row = m0 + wm * 64 + mi * 16 + g + hrow * 8;
          if (row >= p.m) continue;
          float y = __fmul_rn(Mma<FP8>::to_float(acc[mi][ni][hrow * 2 + q]), s);
          if (p.bias) y = __fadd_rn(y, b);
          const size_t o = (size_t)row * p.cout + col;
          if (p.out_bf16)
            ((__nv_bfloat16*)p.out)[o] = __float2bfloat16_rn(y);
          else
            ((float*)p.out)[o] = y;
        }
      }
    }
  }
}

template <bool FP8>
int launch(const Params& p, cudaStream_t s) {
  const dim3 grid((unsigned)((p.m + BM - 1) / BM),
                  (unsigned)((p.cout + BN - 1) / BN));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = p.c % 16 == 0 && (uintptr_t)p.x % 16 == 0;
  if (vec)
    qconv_kernel<FP8, true><<<grid, THREADS, 0, s>>>(p);
  else
    qconv_kernel<FP8, false><<<grid, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

int fill(Params& p, const void* x, const void* wt, const float* x_unit,
         const float* w_unit, const float* bias, void* out, int out_bf16,
         int n, int h, int w, int c, int oh, int ow, int cout, int kh, int kw,
         int sh, int sw, int pt, int pl, int kp) {
  p.x = (const uint8_t*)x;
  p.wt = (const uint8_t*)wt;
  p.x_unit = x_unit;
  p.w_unit = w_unit;
  p.bias = bias;
  p.out = out;
  p.out_bf16 = out_bf16;
  p.n = n; p.h = h; p.w = w; p.c = c; p.oh = oh; p.ow = ow; p.cout = cout;
  p.kh = kh; p.kw = kw; p.sh = sh; p.sw = sw; p.pt = pt; p.pl = pl;
  p.kp = kp;
  p.ktot = kh * kw * c;
  const long long m = (long long)n * oh * ow;
  if (m <= 0 || m >= (1LL << 31) || kp % BK || kp < p.ktot)
    return (int)cudaErrorInvalidValue;
  p.m = (int)m;
  return 0;
}

}  // namespace

// x: (n, h, w, c) int8 or e4m3 NHWC; wt: (cout, kp) packed rows; x_unit:
// one fp32 on the device; w_unit, bias (nullable): (cout,) fp32; out:
// (n, oh, ow, cout) bf16 if out_bf16 else fp32.  Launches on `stream`
// and returns cudaGetLastError().
#define QCONV_ENTRY(NAME, FP8)                                               \
  extern "C" int NAME(const void* x, const void* wt, const float* x_unit,   \
                      const float* w_unit, const float* bias, void* out,    \
                      int out_bf16, int n, int h, int w, int c, int oh,     \
                      int ow, int cout, int kh, int kw, int sh, int sw,     \
                      int pt, int pl, int kp, void* stream) {               \
    Params p;                                                                \
    const int rc = fill(p, x, wt, x_unit, w_unit, bias, out, out_bf16, n, h, \
                        w, c, oh, ow, cout, kh, kw, sh, sw, pt, pl, kp);     \
    if (rc) return rc;                                                       \
    return launch<FP8>(p, (cudaStream_t)stream);                             \
  }

QCONV_ENTRY(qconv_s8_launch, false)
QCONV_ENTRY(qconv_e4m3_launch, true)
