// K4: per-tensor symmetric activation quantization, bf16/fp32 -> int8 or
// e4m3, one elementwise pass over the tensor's storage (NHWC for the
// port's activations, which live channels-last).
//
// No Pallas counterpart: the JAX package computes it with XLA
// (mx_rcnn_tpu/ops/quant.py — _quantize, reached from quantize_act).
// Same function, bit for bit:
//   int8: clip(round_half_even(x / unit), -qmax, qmax)
//   fp8:  clip(x / unit, -448, 448), cast to e4m3 with round to nearest even
// `x / unit` is an IEEE division (__fdiv_rn), never a multiply by the
// reciprocal, which rounds differently; rintf rounds half to even.  The
// clip is written with comparisons so that a NaN stays NaN, as jnp.clip
// leaves it.  `unit` is read from device memory: the calibrated scale
// never makes a round trip to the host.
//
// What bounds it on an H100: bytes.  Each element is read once (2 or 4
// bytes) and written once (1 byte); a thread moves 8 elements with one
// 16-byte (bf16) or two 16-byte (fp32) loads and one 8-byte store, so the
// pass runs at the memory rate.  The tail (numel % 8) and a base that is
// not 16-byte aligned go element by element.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint8_t quantize_one(float v, float unit,
                                                float qmax, bool fp8) {
  float t = __fdiv_rn(v, unit);
  if (fp8) {
    t = t < -448.0f ? -448.0f : (t > 448.0f ? 448.0f : t);
    return (uint8_t)__nv_cvt_float_to_fp8(t, __NV_SATFINITE, __NV_E4M3);
  }
  float r = rintf(t);
  r = r < -qmax ? -qmax : (r > qmax ? qmax : r);
  return (uint8_t)(int8_t)(int)r;
}

template <bool BF16>
__device__ __forceinline__ float load_one(const void* x, long long i) {
  if (BF16) return __bfloat162float(((const __nv_bfloat16*)x)[i]);
  return ((const float*)x)[i];
}

template <bool BF16>
__global__ void quantize_act_kernel(const void* __restrict__ x,
                                    const float* __restrict__ unit_ptr,
                                    float qmax, int fp8,
                                    uint8_t* __restrict__ out, long long n,
                                    int vec) {
  const float unit = *unit_ptr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long nvec = vec ? n / 8 : 0;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < nvec; v += stride) {
    float f[8];
    if (BF16) {
      const uint4 raw = ((const uint4*)x)[v];
      const __nv_bfloat162* h = (const __nv_bfloat162*)&raw;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 p = __bfloat1622float2(h[j]);
        f[2 * j] = p.x;
        f[2 * j + 1] = p.y;
      }
    } else {
      const float4 a = ((const float4*)x)[2 * v];
      const float4 b = ((const float4*)x)[2 * v + 1];
      f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
      f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
    }
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo |= (uint32_t)quantize_one(f[j], unit, qmax, fp8) << (8 * j);
      hi |= (uint32_t)quantize_one(f[j + 4], unit, qmax, fp8) << (8 * j);
    }
    ((uint2*)out)[v] = make_uint2(lo, hi);
  }
  for (long long i = nvec * 8 + blockIdx.x * (long long)blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = quantize_one(load_one<BF16>(x, i), unit, qmax, fp8);
  }
}

}  // namespace

// x: n elements (bf16 if is_bf16, else fp32); unit: one fp32 on the
// device; out: n bytes (int8, or e4m3 if fp8).  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int quantize_act_launch(const void* x, int is_bf16,
                                   const float* unit, float qmax, int fp8,
                                   void* out, long long n, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 8 == 0);
  const int threads = 256;
  const long long work = vec ? (n / 8 > 0 ? n / 8 : n) : n;
  long long blocks = (work + threads - 1) / threads;
  // a grid-stride loop covers the rest: enough blocks to fill the card
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  if (blocks < 1) blocks = 1;
  if (is_bf16) {
    quantize_act_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(
        x, unit, qmax, fp8, (uint8_t*)out, n, vec);
  } else {
    quantize_act_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(
        x, unit, qmax, fp8, (uint8_t*)out, n, vec);
  }
  return (int)cudaGetLastError();
}
