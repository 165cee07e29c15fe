// ROIAlign backward: the feature gradient of roi_align_fwd.cu, fp32 and bf16.
//
// Replaces: mx_rcnn_tpu/ops/roi_align_pallas.py — _bwd_kernel (entry
// _roi_align_bwd), which computes
//   dfeat[n,h,w,c] = sum_r sum_s sum_t wy[n,r,s,h] * g[n,r,s,t,c] * wx[n,r,t,w]
// with wy/wx from ops/roi_pool.py — interp_matrices, accumulated in fp32
// and cast once to g's dtype.  The rois get no gradient.  The TPU kernel
// runs the two transposed matmuls out of VMEM with an accumulator that
// persists across the sequential ROI grid axis.
//
// On the card the same sum is the transpose of K2's gather.  The obvious
// design, one fp32 atomicAdd per sample into dfeat, gives bits that depend
// on the order the atomics land in; the JAX backward is deterministic, so
// this kernel owns its outputs instead:
//
//   one block per (channel block, feature row h, image); threads run over
//   channels.  The block walks the image's ROIs in order, in chunks whose
//   row weights for h (wy[r, s, h], the sr sample taps folded) and column
//   taps are tabled in shared memory.  A ROI whose sample rows miss h is
//   skipped; for one that hits, each thread folds
//   row[t] = sum_s wy[s, h] * g[r, s, t, c] and scatters it along the
//   ROI's column taps into an fp32 (W, Cb) accumulator in shared memory.
//   Each thread touches only its own channel's column, in a fixed order,
//   so two launches give the same bits.  Row h is written once, cast once.
//
// Bilinear taps come from the same axis_tap formula as roi_align_fwd.cu,
// so the forward and the backward agree on every weight.
//
// What bounds it on an H100: bytes.  At the training shape (2 x 128 rois,
// 14x14, 38x64x1024 bf16) it must read g (103 MB) and write dfeat
// (10 MB), ~34 us at 3.35 TB/s; its ~1.6 GFLOP of fp32 FMAs would take
// ~25 us.  This first version reads each g row once for every feature row
// its samples touch (up to 2*sr), mostly from L2, and runs 608 blocks of
// 128 threads; reading each g row once per ROI is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRoiChunk = 32;     // ROIs whose tables share memory at once
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Tap {
  int lo, hi;
  float wlo, whi;
};

// one axis of _interp_matrix: sample k of num_bins*sr (as roi_align_fwd.cu)
__device__ __forceinline__ Tap axis_tap(float start, float bin, int sr, int k,
                                        int size) {
  const float step = __fdiv_rn(bin, (float)sr);
  float pos = __fsub_rn(__fadd_rn(start, __fmul_rn(__fadd_rn((float)k, 0.5f),
                                                   step)),
                        0.5f);
  pos = fminf(fmaxf(pos, 0.0f), (float)(size - 1));
  const float lo = floorf(pos);
  const float frac = __fsub_rn(pos, lo);
  Tap tap;
  tap.lo = (int)lo;
  tap.hi = min(tap.lo + 1, size - 1);
  tap.wlo = __fsub_rn(1.0f, frac);
  tap.whi = frac;
  return tap;
}

__host__ __device__ inline size_t smem_bytes(int w, int cb, int ph, int pw,
                                             int sr) {
  return (size_t)w * cb * sizeof(float) + (size_t)kRoiChunk * ph * sizeof(float)
         + (size_t)kRoiChunk * pw * sr * sizeof(Tap);
}

template <typename T>
__global__ void roi_align_bwd_kernel(const T* __restrict__ g,
                                     const float* __restrict__ rois, int r,
                                     int h, int w, int c, int ph, int pw,
                                     int sr, float scale,
                                     T* __restrict__ dfeat) {
  extern __shared__ float smem[];
  const int cb = blockDim.x;
  const int tid = threadIdx.x;
  float* acc = smem;                    // [w][cb], column tid is this thread's
  float* wyh = acc + (size_t)w * cb;    // [kRoiChunk][ph] row weights for h
  Tap* tx = reinterpret_cast<Tap*>(wyh + kRoiChunk * ph);  // [kRoiChunk][pw*sr]

  const int hrow = blockIdx.y;
  const int ni = blockIdx.z;
  const int ci = blockIdx.x * cb + tid;
  const bool active = ci < c;
  const int nx = pw * sr;
  const float inv = 1.0f / (float)sr;
  const float* roi_n = rois + (size_t)ni * r * 4;
  const T* g_n = g + (size_t)ni * r * ph * pw * c;

  for (int x = 0; x < w; ++x) acc[x * cb + tid] = 0.0f;

  for (int r0 = 0; r0 < r; r0 += kRoiChunk) {
    const int rc = min(kRoiChunk, r - r0);
    __syncthreads();  // the previous chunk's tables are no longer read
    for (int i = tid; i < rc * ph; i += cb) {
      const float* roi = roi_n + (size_t)(r0 + i / ph) * 4;
      const int s = i % ph;
      const float y1 = __fmul_rn(roi[1], scale);
      const float y2 = __fmul_rn(roi[3], scale);
      const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, y1), 1.0f), (float)ph);
      float wsum = 0.0f;
      for (int a = 0; a < sr; ++a) {
        const Tap t = axis_tap(y1, bin_h, sr, s * sr + a, h);
        if (t.lo == hrow) wsum += t.wlo;
        if (t.hi == hrow) wsum += t.whi;
      }
      wyh[i] = wsum * inv;
    }
    for (int i = tid; i < rc * nx; i += cb) {
      const float* roi = roi_n + (size_t)(r0 + i / nx) * 4;
      const float x1 = __fmul_rn(roi[0], scale);
      const float x2 = __fmul_rn(roi[2], scale);
      const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, x1), 1.0f), (float)pw);
      tx[i] = axis_tap(x1, bin_w, sr, i % nx, w);
    }
    __syncthreads();
    if (!active) continue;  // no barrier until the loop's next iteration
    for (int rr = 0; rr < rc; ++rr) {
      const float* wr = wyh + rr * ph;
      // the sample rows that touch h are contiguous in s
      int s0 = 0;
      while (s0 < ph && wr[s0] == 0.0f) ++s0;
      if (s0 == ph) continue;
      int s1 = ph;
      while (wr[s1 - 1] == 0.0f) --s1;
      const T* gr = g_n + (size_t)(r0 + rr) * ph * pw * c + ci;
      const Tap* txr = tx + rr * nx;
      for (int t = 0; t < pw; ++t) {
        float row = 0.0f;
        for (int s = s0; s < s1; ++s) {
          row += wr[s] * to_f32(gr[(size_t)(s * pw + t) * c]);
        }
        for (int b = 0; b < sr; ++b) {
          const Tap x = txr[t * sr + b];
          acc[x.lo * cb + tid] += (x.wlo * inv) * row;
          acc[x.hi * cb + tid] += (x.whi * inv) * row;
        }
      }
    }
  }
  if (!active) return;
  T* out = dfeat + ((size_t)ni * h + hrow) * w * c + ci;
  for (int x = 0; x < w; ++x) out[(size_t)x * c] = from_f32<T>(acc[x * cb + tid]);
}

template <typename T>
int launch(const void* g, const float* rois, void* dfeat, int n, int r, int h,
           int w, int c, int ph, int pw, int sr, float scale,
           cudaStream_t stream) {
  int threads = c >= 128 ? 128 : ((c + 31) / 32) * 32;
  while (threads > 32 && smem_bytes(w, threads, ph, pw, sr) > (size_t)kMaxSmem)
    threads /= 2;
  const size_t smem = smem_bytes(w, threads, ph, pw, sr);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      roi_align_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((c + threads - 1) / threads, h, n);
  roi_align_bwd_kernel<T><<<grid, threads, smem, stream>>>(
      (const T*)g, rois, r, h, w, c, ph, pw, sr, scale, (T*)dfeat);
  return (int)cudaGetLastError();
}

}  // namespace

// g (n, r, ph, pw, c) fp32 or bf16; rois (n, r, 4) fp32 in input
// coordinates; dfeat (n, h, w, c) in g's dtype, every element written.
extern "C" int roi_align_bwd_launch(const void* g, const float* rois,
                                    void* dfeat, int is_bf16, int n, int r,
                                    int h, int w, int c, int ph, int pw,
                                    int sr, float scale, void* stream) {
  if (n == 0 || h == 0 || w == 0 || c == 0) return 0;
  if (h > 65535 || n > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return launch<__nv_bfloat16>(g, rois, dfeat, n, r, h, w, c, ph, pw, sr,
                                 scale, s);
  }
  return launch<float>(g, rois, dfeat, n, r, h, w, c, ph, pw, sr, scale, s);
}
