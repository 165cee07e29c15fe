// K4: the activation quantizer, with the frozen BN and ReLU that produce
// its input, in one streaming pass over channels-last storage:
//
//   x (bf16 or fp32) -> [frozen BN: fp32 x*inv[c] + shift[c], rounded to
//   the model dtype] -> [ReLU] -> per-tensor quantization into one or two
//   outputs (int8 at qmax, or e4m3), each against its own unit.
//
// No Pallas counterpart: the JAX package computes the quantizer with XLA
// (mx_rcnn_tpu/ops/quant.py — _quantize, reached from quantize_act), and
// XLA fuses the BN and ReLU before it into the same loop.  The port's plain
// version is ops/quant.py — quantize_act_fused_plain, which runs the torch
// ops of FrozenBatchNorm.forward, F.relu and quantize_act_plain; the
// kernel gives the same bytes on the card:
//   - x*inv then +shift as two roundings (__fmul_rn, __fadd_rn): torch
//     runs the multiply and the add as two kernels, so no FMA;
//   - the model dtype's cast: with `round_bf16`, an fp32 input is first
//     rounded to bf16 (conv0's x.to(dtype)) and the affine result is
//     rounded to bf16, both to nearest even;
//   - ReLU as torch's on the card: max(v, 0), a NaN passed on;
//   - int8: clip(round_half_even(v / unit), -qmax, qmax); fp8:
//     clip(v / unit, -448, 448) cast to e4m3 to nearest even, where
//     `v / unit` is the IEEE quotient (__fdiv_rn).  The int8 rounding adds
//     1.5 * 2^23 to the clipped value: the sum is then an integer rounded
//     half to even, and its low byte is the two's-complement int8 (qmax
//     <= 127 < 2^22).  A NaN gives 0, as the integer conversion gives it;
//     the clips are comparisons, so a NaN stays NaN up to there, as
//     torch.clamp leaves it.
//   Each unit is read from device memory: a calibrated scale never makes
//   a round trip to the host.
//
// What bounds it on an H100: bytes, once the division is out of the way.
// Each element is read once (2 or 4 bytes) and written once per output
// (1 byte); the BN's fp32 intermediate and the ReLU's output never reach
// device memory.  An IEEE division per element and output set the pace
// instead: 3 to 4 times the time of the route below at the per-ROI
// stage-4 shapes on an H100 (tools/k4_probe.py times both).  So the
// kernel multiplies by the reciprocal and divides only where the product
// lies near a rounding boundary of the container (product_s8,
// product_e4m3), out of line; the two routes give the same bytes
// (tests/test_torch_quant_fused.py holds a numpy model of both over
// every bf16 input at several units).  A thread moves 8 elements a
// vector: one 16-byte load (bf16; fp32 two) and one 8-byte store per
// output, with U vectors' loads issued before any is used, so that enough
// bytes are in flight.  The grid holds as many 256-thread blocks as are
// resident on the card at once (the occupancy query), each thread walking
// the storage in strides of the whole grid.
//
// Channels.  Element e of the storage has channel e % C.  A block stages
// inv and shift (C <= 2048: at most 16 KB) in shared memory once.  The
// grid's stride of 8 * threads elements is a multiple of every C that
// divides 2048, so for those (every ResNet layer but conv0's input) a
// thread meets the same 8 channels at every vector and keeps their 16
// values in registers.  Any other C (conv0's 3) reads them from shared
// memory per element, the channel advanced by (8 * threads) % C a vector
// and wrapped per lane.  The tail (n % 8) and a base that is not aligned
// for the vector loads go element by element.  The test file holds a
// numpy model of this walk too.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // ops/quant.py — K4_THREADS
constexpr int kMaxChannels = 2048;     // ops/quant.py — K4_MAX_CHANNELS
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23

struct Args {
  const void* x;
  long long n;         // elements
  int c;               // channels, innermost in storage (1: no affine)
  int adv;             // (8 * threads of the grid) % c
  int vec;             // 8-element vectors: x 16-byte, outputs 8-byte aligned
  const float* inv;    // per channel, or null: no BN
  const float* shift;
  int round_bf16;      // the model dtype is bf16
  int relu;
  uint8_t* out[2];
  const float* unit[2];
  float qmax;
  int fp8;
};

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// F.relu on the card: max(v, 0) with a NaN passed on (as a NaN: its
// quotient, a NaN either way, is what the container sees)
__device__ __forceinline__ float relu(float v) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(0.0f));
  return r;
}

// to_bf16 of 8 values, two to a conversion
__device__ __forceinline__ void to_bf16_8(float (&y)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(
        __floats2bfloat162_rn(y[2 * j], y[2 * j + 1]));
    y[2 * j] = f.x;
    y[2 * j + 1] = f.y;
  }
}

// BN (when inv is given), the model dtype's rounding, ReLU: one element
// of the tensor the quantizer reads.  `v` is x widened to fp32.
template <bool BF16>
__device__ __forceinline__ float produce(float v, float inv, float shift,
                                         const Args& a, bool affine) {
  if (affine) {
    if (!BF16 && a.round_bf16) v = to_bf16(v);
    v = __fadd_rn(__fmul_rn(v, inv), shift);
    if (a.round_bf16) v = to_bf16(v);
  }
  if (a.relu) v = relu(v);
  return v;
}

// produce for a vector of 8 and its channels' inv and shift
template <bool BF16>
__device__ __forceinline__ void produce8(float (&y)[8], const float (&inv)[8],
                                         const float (&shift)[8],
                                         const Args& a, bool affine) {
  if (affine) {
    if (!BF16 && a.round_bf16) to_bf16_8(y);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      y[j] = __fadd_rn(__fmul_rn(y[j], inv[j]), shift[j]);
    }
    if (a.round_bf16) to_bf16_8(y);
  }
  if (a.relu) {
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = relu(y[j]);
  }
}

// the clip of the plain version: comparisons, so a NaN stays NaN
__device__ __forceinline__ float clip(float t, float lim) {
  return t < -lim ? -lim : (t > lim ? lim : t);
}

// v / unit as the quantizer rounds it: the product by the reciprocal
// `rcp`, and the IEEE quotient (__fdiv_rn) wherever the product lies near
// a rounding boundary of the container, or is NaN.  The product is within
// 2^-22 of the quotient, relatively (two roundings of 2^-24); each "near"
// band is at least 4 times wider, so outside it the two round alike.
//
// int8's boundaries are the half-integers.  The clipped product t plus
// 1.5 * 2^23 is rint(t) in the low mantissa bits (|t| <= 127 < 2^22);
// t - rint(t) is exact, and t is near when it is at least 0.5 - 2^-13
// in magnitude (the error is at most 127 * 2^-22 < 2^-15).  The sum is
// kept: its low byte is the int8 value.
//
// e4m3's boundaries are the midpoints between its values: with 3 mantissa
// bits from 2^-6 up, a midpoint's fp32 mantissa bits 19..0 are 0x80000,
// and near is within 16 ulps of that (the error is at most 4).  Below
// 2^-6 the values are multiples of 2^-9, the spacing of the binade
// [2^-6, 2^-5): |t| + 2^-6 moves them there with the same bit patterns
// (the add's rounding, 2^-30, is far inside the band of 2^-25).
//
// Each takes 8 values and says whether any of them needs the quotient;
// the caller then takes the quotient for all 8.
__device__ __forceinline__ bool product_s8(const float (&y)[8], float rcp,
                                           float qmax, float (&s)[8]) {
  bool near = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p = __fmul_rn(y[j], rcp);
    const float t = fminf(fmaxf(p, -qmax), qmax);
    s[j] = __fadd_rn(t, kMagic);
    const float d = __fsub_rn(t, __fsub_rn(s[j], kMagic));
    near |= fabsf(d) >= 0.5f - 0x1p-13f;
    near |= p != p;
  }
  return near;
}

__device__ __forceinline__ bool product_e4m3(const float (&y)[8], float rcp,
                                             float (&t)[8]) {
  bool near = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p = __fmul_rn(y[j], rcp);
    t[j] = fminf(fmaxf(p, -448.0f), 448.0f);
    const float a = fabsf(t[j]);
    const float w = a < 0x1p-6f ? __fadd_rn(a, 0x1p-6f) : a;
    near |= ((__float_as_uint(w) + (16u - 0x80000u)) & 0xfffffu) <= 32u;
    near |= p != p;
  }
  return near;
}

// the quotient's route: the plain version's arithmetic, out of line, so
// that the common path keeps its registers
__device__ __noinline__ float exact_s8(float v, float unit, float qmax) {
  const float q = clip(__fdiv_rn(v, unit), qmax);
  return q != q ? kMagic : __fadd_rn(q, kMagic);  // NaN -> byte 0
}

__device__ __noinline__ float exact_e4m3(float v, float unit) {
  return clip(__fdiv_rn(v, unit), 448.0f);
}

__device__ __forceinline__ uint32_t e4m3x2(float a, float b) {
  return (uint32_t)__nv_cvt_float2_to_fp8x2(make_float2(a, b),
                                            __NV_SATFINITE, __NV_E4M3);
}

// 8 values -> 8 quantized bytes, element j in byte j
__device__ __forceinline__ uint2 quantize8(const float (&y)[8], float unit,
                                           float rcp, const Args& a) {
  uint32_t w0, w1;
  if (a.fp8) {
    float t[8];
    if (product_e4m3(y, rcp, t)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) t[j] = exact_e4m3(y[j], unit);
    }
    w0 = e4m3x2(t[0], t[1]) | e4m3x2(t[2], t[3]) << 16;
    w1 = e4m3x2(t[4], t[5]) | e4m3x2(t[6], t[7]) << 16;
  } else {
    float s[8];
    if (product_s8(y, rcp, a.qmax, s)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = exact_s8(y[j], unit, a.qmax);
    }
    uint32_t b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = __float_as_uint(s[j]);
    w0 = __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                     __byte_perm(b[2], b[3], 0x0040), 0x5410);
    w1 = __byte_perm(__byte_perm(b[4], b[5], 0x0040),
                     __byte_perm(b[6], b[7], 0x0040), 0x5410);
  }
  return make_uint2(w0, w1);
}

// one element, for the tail: the quotient always (exact by definition)
__device__ __forceinline__ uint8_t quantize_one(float v, float unit,
                                                const Args& a) {
  if (a.fp8) {
    return (uint8_t)__nv_cvt_float_to_fp8(exact_e4m3(v, unit),
                                          __NV_SATFINITE, __NV_E4M3);
  }
  return (uint8_t)__float_as_uint(exact_s8(v, unit, a.qmax));
}

// one vector's raw bytes: 16 (bf16) or 32 (fp32)
template <bool BF16> struct Raw;
template <> struct Raw<true> { uint4 a; };
template <> struct Raw<false> { float4 a, b; };

template <bool BF16>
__device__ __forceinline__ Raw<BF16> load_vec(const void* x, long long v);

template <>
__device__ __forceinline__ Raw<true> load_vec<true>(const void* x,
                                                    long long v) {
  return Raw<true>{__ldg((const uint4*)x + v)};
}

template <>
__device__ __forceinline__ Raw<false> load_vec<false>(const void* x,
                                                      long long v) {
  return Raw<false>{__ldg((const float4*)x + 2 * v),
                    __ldg((const float4*)x + 2 * v + 1)};
}

__device__ __forceinline__ void widen(const Raw<true>& r, float (&f)[8]) {
  const __nv_bfloat162* h = (const __nv_bfloat162*)&r.a;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p = __bfloat1622float2(h[j]);
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

__device__ __forceinline__ void widen(const Raw<false>& r, float (&f)[8]) {
  f[0] = r.a.x; f[1] = r.a.y; f[2] = r.a.z; f[3] = r.a.w;
  f[4] = r.b.x; f[5] = r.b.y; f[6] = r.b.z; f[7] = r.b.w;
}

template <bool BF16>
__device__ __forceinline__ float load_one(const void* x, long long i) {
  if (BF16) return __bfloat162float(((const __nv_bfloat16*)x)[i]);
  return ((const float*)x)[i];
}

template <bool BF16, int NOUT>
__global__ void __launch_bounds__(kThreads, 3)
quantize_act_kernel(const Args a) {
  // vectors a thread loads before it uses the first: 64 bytes in flight
  constexpr int U = BF16 ? 4 : 2;
  extern __shared__ float sh[];  // inv[c], then shift[c]
  const bool affine = a.inv != nullptr;
  if (affine) {
    for (int i = threadIdx.x; i < a.c; i += kThreads) {
      sh[i] = a.inv[i];
      sh[a.c + i] = a.shift[i];
    }
    __syncthreads();
  }
  float unit[NOUT], rcp[NOUT];
#pragma unroll
  for (int o = 0; o < NOUT; ++o) {
    unit[o] = *a.unit[o];
    rcp[o] = __frcp_rn(unit[o]);
  }

  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nvec = a.vec ? a.n / 8 : 0;
  // the channel of this thread's first vector's first element
  int c0 = (int)((first * 8) % a.c);
  const bool fixed = a.adv == 0 && a.c % 8 == 0;
  float inv[8], shift[8];
  if (affine && fixed) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      inv[j] = sh[c0 + j];
      shift[j] = sh[a.c + c0 + j];
    }
  }
  for (long long base = first; base < nvec; base += U * stride) {
    Raw<BF16> raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long v = base + u * stride;
      if (v < nvec) raw[u] = load_vec<BF16>(a.x, v);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long v = base + u * stride;
      if (v < nvec) {
        if (affine && !fixed) {
          int c = c0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            inv[j] = sh[c];
            shift[j] = sh[a.c + c];
            c = c + 1 == a.c ? 0 : c + 1;
          }
        }
        float y[8];
        widen(raw[u], y);
        produce8<BF16>(y, inv, shift, a, affine);
#pragma unroll
        for (int o = 0; o < NOUT; ++o) {
          ((uint2*)a.out[o])[v] = quantize8(y, unit[o], rcp[o], a);
        }
      }
      c0 += a.adv;
      if (c0 >= a.c) c0 -= a.c;
    }
  }
  // the tail, or everything when the vector path is off
  for (long long i = nvec * 8 + first; i < a.n; i += stride) {
    const int c = affine ? (int)(i % a.c) : 0;
    const float y = produce<BF16>(load_one<BF16>(a.x, i),
                                  affine ? sh[c] : 1.0f,
                                  affine ? sh[a.c + c] : 0.0f, a, affine);
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
      a.out[o][i] = quantize_one(y, unit[o], a);
    }
  }
}

// resident 256-thread blocks on the card for one instantiation at the
// largest shared memory it asks for, per device, queried once (a race
// writes the same value twice); 0 with `err` set if the query fails
template <bool BF16, int NOUT>
int resident_blocks(int dev, cudaError_t* err) {
  static int cache[64];
  if (dev >= 0 && dev < 64 && cache[dev] > 0) return cache[dev];
  int per_sm = 0, sms = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, quantize_act_kernel<BF16, NOUT>, kThreads,
      2 * kMaxChannels * sizeof(float));
  if (*err == cudaSuccess) {
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (*err != cudaSuccess) return 0;
  const int blocks = per_sm * sms > 0 ? per_sm * sms : 1;
  if (dev >= 0 && dev < 64) cache[dev] = blocks;
  return blocks;
}

template <bool BF16, int NOUT>
int launch(Args a, cudaStream_t s) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int resident = resident_blocks<BF16, NOUT>(dev, &err);
  if (resident == 0) return (int)err;
  const long long work = a.vec ? a.n / 8 : a.n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  a.adv = (int)((blocks * kThreads * 8) % a.c);
  const size_t smem = a.inv ? 2 * (size_t)a.c * sizeof(float) : 0;
  quantize_act_kernel<BF16, NOUT><<<(unsigned)blocks, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x: n elements of channels-last storage (bf16 if is_bf16, else fp32)
// with c channels innermost; inv/shift: c fp32 values on the device, or
// both null (no BN; c is then ignored); out1/unit1 null for one output.
// Each unit is one fp32 on the device; each output n bytes (int8, or e4m3
// if fp8).  Launches on `stream` and returns cudaGetLastError() (or 1 for
// arguments it does not take).
extern "C" int quantize_act_launch(const void* x, int is_bf16, long long n,
                                   int c, const float* inv,
                                   const float* shift, int round_bf16,
                                   int relu, void* out0, const float* unit0,
                                   void* out1, const float* unit1,
                                   float qmax, int fp8, void* stream) {
  if (n == 0) return 0;
  const bool affine = inv != nullptr;
  if (affine != (shift != nullptr) ||
      (affine && (c < 1 || c > kMaxChannels)) || out0 == nullptr ||
      unit0 == nullptr || (out1 == nullptr) != (unit1 == nullptr)) {
    return 1;
  }
  Args a{};
  a.x = x;
  a.n = n;
  a.c = affine ? c : 1;
  a.inv = inv;
  a.shift = shift;
  a.round_bf16 = round_bf16;
  a.relu = relu;
  a.out[0] = (uint8_t*)out0;
  a.out[1] = (uint8_t*)out1;
  a.unit[0] = unit0;
  a.unit[1] = unit1;
  a.qmax = qmax;
  a.fp8 = fp8;
  a.vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out0 % 8 == 0) &&
          ((uintptr_t)out1 % 8 == 0);
  cudaStream_t s = (cudaStream_t)stream;
  const bool two = out1 != nullptr;
  if (is_bf16) return two ? launch<true, 2>(a, s) : launch<true, 1>(a, s);
  return two ? launch<false, 2>(a, s) : launch<false, 1>(a, s);
}
