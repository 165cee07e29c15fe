// ROIAlign forward as a bilinear gather over NHWC features, fp32 and bf16.
//
// Replaces: mx_rcnn_tpu/ops/roi_align_pallas.py — _fwd_kernel (entry
// roi_align_pallas / _roi_align_fwd), which computes
//   pooled[n,r,s,t,c] = sum_h sum_w wy[n,r,s,h] * feat[n,h,w,c] * wx[n,r,t,w]
// with wy/wx from ops/roi_pool.py — interp_matrices (the sr x sr sample mean
// folded in).  The TPU kernel runs that as two MXU matmuls out of VMEM; each
// interpolation row has at most 2*sr non-zeros, so on the card the same sum
// is a gather: each output bin reads at most 2*sr rows x 2*sr columns of
// taps.
//
// Weights are the reference's, computed in the kernel with the exact
// formula of _interp_matrix (each step rounded once): per axis,
//   pos = start + (k + 0.5) * (bin / sr) - 0.5, clipped to [0, size-1],
//   lo = floor(pos), hi = min(lo + 1, size - 1), weights (1 - frac, frac),
// ROI extent max(x2 - x1, 1) at feature scale — not torchvision's rules.
//
// Layout: one block per (channel block, roi, image); threads run over
// channels, which are contiguous in NHWC, so a warp reads 32 neighbouring
// channels of one tap.  The per-axis sample tables are built once per block
// in shared memory.  Accumulation is fp32; the output is cast once.
//
// What bounds it on an H100: bytes.  At the serving shape (300 rois,
// 38x64x1024 bf16, 14x14) it writes 120 MB of pooled output and reads the
// 5 MB feature map once, ~37 us at 3.35 TB/s; its ~2 GFLOP of fp32 FMAs
// would take ~30 us.  This first version reads every tap from L2 again
// for every sample (16 loads per output element, ~2 GB of L2 traffic per
// image), so L2 bandwidth, not HBM, limits it.  Reusing taps shared by
// neighbouring samples, which a small ROI has many of, is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

// one axis of _interp_matrix: sample k of num_bins*sr
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

template <typename T>
__global__ void roi_align_fwd_kernel(const T* __restrict__ feat,
                                     const float* __restrict__ rois, int r,
                                     int h, int w, int c, int ph, int pw,
                                     int sr, float scale, T* __restrict__ out) {
  extern __shared__ Tap taps[];  // [ph*sr] rows then [pw*sr] columns
  const int ri = blockIdx.y;
  const int ni = blockIdx.z;
  const int ny = ph * sr, nx = pw * sr;
  const float* roi = rois + ((size_t)ni * r + ri) * 4;
  const float x1 = __fmul_rn(roi[0], scale);
  const float y1 = __fmul_rn(roi[1], scale);
  const float x2 = __fmul_rn(roi[2], scale);
  const float y2 = __fmul_rn(roi[3], scale);
  const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, x1), 1.0f), (float)pw);
  const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, y1), 1.0f), (float)ph);
  for (int i = threadIdx.x; i < ny + nx; i += blockDim.x) {
    taps[i] = i < ny ? axis_tap(y1, bin_h, sr, i, h)
                     : axis_tap(x1, bin_w, sr, i - ny, w);
  }
  __syncthreads();

  const int ci = blockIdx.x * blockDim.x + threadIdx.x;
  if (ci >= c) return;
  const Tap* ty = taps;
  const Tap* tx = taps + ny;
  const T* f = feat + (size_t)ni * h * w * c + ci;
  T* o = out + ((size_t)ni * r + ri) * ph * pw * c + ci;
  const float inv = 1.0f / (float)(sr * sr);
  for (int s = 0; s < ph; ++s) {
    for (int t = 0; t < pw; ++t) {
      float acc = 0.0f;
      for (int a = 0; a < sr; ++a) {
        const Tap y = ty[s * sr + a];
        const T* rlo = f + (size_t)y.lo * w * c;
        const T* rhi = f + (size_t)y.hi * w * c;
        for (int b = 0; b < sr; ++b) {
          const Tap x = tx[t * sr + b];
          const float lo = x.wlo * to_f32(rlo[(size_t)x.lo * c]) +
                           x.whi * to_f32(rlo[(size_t)x.hi * c]);
          const float hi = x.wlo * to_f32(rhi[(size_t)x.lo * c]) +
                           x.whi * to_f32(rhi[(size_t)x.hi * c]);
          acc += y.wlo * lo + y.whi * hi;
        }
      }
      o[(size_t)(s * pw + t) * c] = from_f32<T>(acc * inv);
    }
  }
}

}  // namespace

// feat (n, h, w, c) fp32 or bf16; rois (n, r, 4) fp32 in input coordinates;
// out (n, r, ph, pw, c) in the feature dtype.
extern "C" int roi_align_fwd_launch(const void* feat, const float* rois,
                                    void* out, int is_bf16, int n, int r,
                                    int h, int w, int c, int ph, int pw,
                                    int sr, float scale, void* stream) {
  if (n == 0 || r == 0 || c == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = c >= 256 ? 256 : ((c + 31) / 32) * 32;
  dim3 grid((c + threads - 1) / threads, r, n);
  const size_t smem = (size_t)(ph + pw) * sr * sizeof(Tap);
  if (is_bf16) {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, threads, smem, s>>>(
        (const __nv_bfloat16*)feat, rois, r, h, w, c, ph, pw, sr, scale,
        (__nv_bfloat16*)out);
  } else {
    roi_align_fwd_kernel<float><<<grid, threads, smem, s>>>(
        (const float*)feat, rois, r, h, w, c, ph, pw, sr, scale,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
