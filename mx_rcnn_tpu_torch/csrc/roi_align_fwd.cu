// ROIAlign forward as a gather over the reference's merged interpolation
// taps, NHWC features, fp32 and bf16.
//
// Replaces: mx_rcnn_tpu/ops/roi_align_pallas.py — _fwd_kernel (entry
// roi_align_pallas / _roi_align_fwd), which computes
//   pooled[n,r,s,t,c] = sum_h sum_w wy[n,r,s,h] * feat[n,h,w,c] * wx[n,r,t,w]
// with wy/wx from ops/roi_pool.py — interp_matrices (the sr x sr sample mean
// folded in).  The TPU kernel runs that as two MXU matmuls out of VMEM, H
// contracted first.  On the card the same sum is a gather, because each
// row of wy and wx has at most 2*sr nonzeros.
//
// Merged taps.  Row s of wy is the mean over the bin's sr samples of
// (1 - frac) at lo plus frac at hi (_interp_matrix).  Each block builds
// that row's nonzeros once, as a compact table of (offset, weight) pairs
// in shared memory: axis_tap per sample (the reference's formula, each
// step rounded once; word for word as in roi_align_bwd.cu), the sample's
// weights added to the entry of their index in sample order (lo and hi of
// one sample summed first, as the reference's one-hot sum does), then each
// entry divided by sr.  A weight of exactly 0 (frac == 0) adds nothing and
// makes no entry.  The same for every column bin t.  Expanded to dense
// rows these are the reference's matrices bit for bit.
//
// Two stages, in the TPU kernel's order, through registers.  Stage 1
// contracts H for one feature column x of the ROI: col[x] = sum_i wy_i *
// feat[y_i, x, :].  Stage 2 contracts W for a bin: out[s,t] = sum_j wx_j *
// col[x_j].  Bins are walked in order and their taps ascend, so a column
// that a bin shares with an earlier one is always one of the two newest:
// each thread keeps those two columns' stage-1 values in registers, and
// computes every distinct column of row s once.  At the main shapes that
// is about 2 loads per output element (each 16 B for 8 channels), against
// 4.9 distinct taps per bin and 16 sample taps in the first version.
// Accumulation is fp32, with one rounding per output element.
// tests/test_torch_roi_align_taps.py models the tables, the column cache
// and the order on the CPU.
//
// Work split.  One block per (output row s, ROI, image) along grid.x and
// a range of channel vectors along grid.y; 128 threads, each owning one
// 16-byte vector of contiguous channels (8 bf16 or 4 fp32): one 16 B load
// per tap, fp32 accumulators in registers, one 16 B store per bin, so a
// warp stores 512 contiguous bytes.  Thread b <= pw of the block builds the
// table of one bin (b == 0 the row, b >= 1 column t = b - 1) before one
// barrier; then each thread walks the pw bins of row s.  All threads walk
// the same columns, so the cache's branches do not diverge.  At 2 x 128
// ROIs and 14 rows the grid has 3584 blocks (27 per SM).  Channel counts
// that are not a multiple of the vector, or a base pointer that is not
// 16 B aligned, take the same kernel with one channel per thread.  Offsets
// within an image are 32-bit where H*W*C < 2^31, 64-bit otherwise.  The
// tables take (1 + pw) * 2*sr entries of shared memory, sized at launch.
//
// What bounds it on an H100: bytes, at the serving shape 240 MB of bf16
// output for 2 x 300 ROIs (0.072 ms at 3.35 TB/s); the 5 MB feature map
// sits in L2.  Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W:
// the card writes those 240 MB alone in 0.076 ms, and K2 takes 0.168 ms
// on random ROIs of 0-500 px a side (~2 loads per output vector) and
// 0.112 ms on 16-64 px ROIs (~0.6).  So the loads from L2 and each
// block's prologue (ROI load, tables, barrier), not HBM, hold it at
// 45-67% of its bound.  A ROI as large as the map shares no column
// between bins and loads ~13 taps per output vector.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;     // channel vectors per block, at most
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

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

// one merged tap: an element offset (index * stride) and its weight
template <typename Index>
struct WTap {
  Index off;
  float w;
};

template <typename Index>
__device__ __forceinline__ void add_tap(WTap<Index>* taps, int& n, Index off,
                                        float w) {
  if (w == 0.0f) return;
  // the sample indices never decrease, so a repeated index is near the end
  for (int e = n - 1; e >= 0 && taps[e].off >= off; --e) {
    if (taps[e].off == off) {
      taps[e].w = __fadd_rn(taps[e].w, w);
      return;
    }
  }
  taps[n].off = off;
  taps[n].w = w;
  ++n;
}

// the nonzeros of row b of one axis's interpolation matrix, at most 2*sr
template <typename Index>
__device__ int merged_row(float start, float bin, int sr, int b, int size,
                          Index stride, WTap<Index>* taps) {
  int n = 0;
  for (int a = 0; a < sr; ++a) {
    const Tap t = axis_tap(start, bin, sr, b * sr + a, size);
    if (t.lo == t.hi) {
      add_tap(taps, n, (Index)t.lo * stride, __fadd_rn(t.wlo, t.whi));
    } else {
      add_tap(taps, n, (Index)t.lo * stride, t.wlo);
      add_tap(taps, n, (Index)t.hi * stride, t.whi);
    }
  }
  for (int e = 0; e < n; ++e) taps[e].w = __fdiv_rn(taps[e].w, (float)sr);
  return n;
}

// V contiguous channels as fp32: one 16 B load for V = 16 / sizeof(T)
__device__ __forceinline__ void load(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h2[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, const float (&v)[1]) {
  *p = v[0];
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16(v[0]);
}
__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 q;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h2[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}

template <int V>
__device__ __forceinline__ void axpy(float (&acc)[V], float a,
                                     const float (&x)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = fmaf(a, x[k], acc[k]);
}

// stage 1 for one column: v = sum_i wy_i * feat[y_i, x, :], p at (0, x)
template <typename T, int V, typename Index>
__device__ __forceinline__ void column(const T* p, const WTap<Index>* ty,
                                       int ny, float (&v)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = 0.0f;
  int i = 0;
  for (; i + 2 <= ny; i += 2) {  // two loads in flight, summed in order
    float q0[V], q1[V];
    load(p + ty[i].off, q0);
    load(p + ty[i + 1].off, q1);
    axpy(v, ty[i].w, q0);
    axpy(v, ty[i + 1].w, q1);
  }
  if (i < ny) {
    float q[V];
    load(p + ty[i].off, q);
    axpy(v, ty[i].w, q);
  }
}

template <typename T, int V, typename Index>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                     int r, int h, int w, int c, int ph, int pw, int sr,
                     float scale, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = 2 * sr;
  WTap<Index>* ty = reinterpret_cast<WTap<Index>*>(smem);  // [nt] row s
  WTap<Index>* tx = ty + nt;                               // [pw][nt]
  int* count = reinterpret_cast<int*>(tx + (size_t)pw * nt);  // [1 + pw]

  const int s = blockIdx.x % ph;
  const int roi_i = blockIdx.x / ph;  // ni * r + ri
  const int ni = roi_i / r;
  const float* roi = rois + (size_t)roi_i * 4;
  const float x1 = __fmul_rn(roi[0], scale);
  const float y1 = __fmul_rn(roi[1], scale);
  const float x2 = __fmul_rn(roi[2], scale);
  const float y2 = __fmul_rn(roi[3], scale);
  const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, x1), 1.0f), (float)pw);
  const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, y1), 1.0f), (float)ph);
  for (int b = threadIdx.x; b <= pw; b += blockDim.x) {
    count[b] = b == 0
        ? merged_row(y1, bin_h, sr, s, h, (Index)w * c, ty)
        : merged_row(x1, bin_w, sr, b - 1, w, (Index)c, tx + (b - 1) * nt);
  }
  __syncthreads();

  const int ci = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (ci >= c) return;
  const T* f = feat + (size_t)ni * h * w * c + ci;
  T* o = out + ((size_t)roi_i * ph + s) * pw * c + ci;
  const int ny = count[0];
  // Stage 1 values of the two newest columns: newest at offset col_n,
  // and col_n - c in prev when has_prev.  Every thread of the block walks
  // the same columns, so the branches below do not diverge.
  float newest[V], prev[V];
#pragma unroll
  for (int k = 0; k < V; ++k) newest[k] = 0.0f;
  Index col_n = -1;
  bool has_prev = false;
  for (int t = 0; t < pw; ++t) {
    const WTap<Index>* xt = tx + t * nt;
    const int nx = count[1 + t];
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    for (int j = 0; j < nx; ++j) {
      const WTap<Index> x = xt[j];
      if (x.off == col_n) {
        axpy(acc, x.w, newest);
      } else if (has_prev && x.off == col_n - c) {
        axpy(acc, x.w, prev);
      } else {
        float v[V];
        column(f + x.off, ty, ny, v);
        axpy(acc, x.w, v);
        if (x.off > col_n) {
          has_prev = col_n >= 0 && x.off == col_n + c;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            prev[k] = newest[k];
            newest[k] = v[k];
          }
          col_n = x.off;
        }
      }
    }
    store(o + (size_t)t * c, acc);
  }
}

template <typename T, int V, typename Index>
int launch(const void* feat, const float* rois, void* out, int n, int r,
           int h, int w, int c, int ph, int pw, int sr, float scale,
           cudaStream_t stream) {
  const size_t smem = (size_t)(1 + pw) * 2 * sr * sizeof(WTap<Index>)
                      + (size_t)(1 + pw) * sizeof(int);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        roi_align_fwd_kernel<T, V, Index>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vecs = (c + V - 1) / V;
  const int threads = vecs >= kThreads ? kThreads : ((vecs + 31) / 32) * 32;
  const int groups = (vecs + threads - 1) / threads;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((size_t)n * r * ph), (unsigned)groups);
  roi_align_fwd_kernel<T, V, Index><<<grid, threads, smem, stream>>>(
      (const T*)feat, rois, r, h, w, c, ph, pw, sr, scale, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* feat, const float* rois, void* out, int n, int r,
                 int h, int w, int c, int ph, int pw, int sr, float scale,
                 cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = c % kVec == 0 && (size_t)feat % 16 == 0
                   && (size_t)out % 16 == 0;
  const bool narrow = (size_t)h * w * c < ((size_t)1 << 31);
  if (vec && narrow)
    return launch<T, kVec, int>(feat, rois, out, n, r, h, w, c, ph, pw, sr,
                                scale, stream);
  if (vec)
    return launch<T, kVec, long long>(feat, rois, out, n, r, h, w, c, ph, pw,
                                      sr, scale, stream);
  if (narrow)
    return launch<T, 1, int>(feat, rois, out, n, r, h, w, c, ph, pw, sr,
                             scale, stream);
  return launch<T, 1, long long>(feat, rois, out, n, r, h, w, c, ph, pw, sr,
                                 scale, stream);
}

}  // namespace

// feat (n, h, w, c) fp32 or bf16; rois (n, r, 4) fp32 in input coordinates;
// out (n, r, ph, pw, c) in the feature dtype.
extern "C" int roi_align_fwd_launch(const void* feat, const float* rois,
                                    void* out, int is_bf16, int n, int r,
                                    int h, int w, int c, int ph, int pw,
                                    int sr, float scale, void* stream) {
  if (n == 0 || r == 0 || c == 0 || ph == 0 || pw == 0) return 0;
  if (sr < 1 || (size_t)n * r * ph > 0x7fffffffu)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return launch_dtype<__nv_bfloat16>(feat, rois, out, n, r, h, w, c, ph, pw,
                                       sr, scale, s);
  }
  return launch_dtype<float>(feat, rois, out, n, r, h, w, c, ph, pw, sr, scale,
                             s);
}
