// ROIAlign backward: the feature gradient of roi_align_fwd.cu, fp32 and bf16.
//
// Replaces: mx_rcnn_tpu/ops/roi_align_pallas.py — _bwd_kernel (entry
// _roi_align_bwd), which computes
//   dfeat[n,h,w,c] = sum_r sum_s sum_t wy[n,r,s,h] * g[n,r,s,t,c] * wx[n,r,t,w]
// with wy/wx from ops/roi_pool.py — interp_matrices.  The rois get no
// gradient.  The TPU kernel runs the two transposed matmuls out of VMEM
// with an fp32 accumulator that persists across the sequential ROI grid
// axis.  In bf16 it rounds before that accumulator: the weights are cast
// to the feature dtype (_build_interp), and so is each ROI's W-contracted
// intermediate (the das of _bwd_kernel); the reference's einsum path
// (ops/roi_pool.py — roi_align) also runs on weights cast to bf16.  This
// kernel keeps the weights in fp32, sums every product in fp32 and rounds
// once per output element, so in bf16 it is held to the fp32 sum of the
// same bf16 g (roi_pool.py — roi_align_bwd_plain), not to the TPU's bits.
//
// The same sum is the transpose of K2's gather.  fp32 atomics into dfeat
// would give bits that depend on the order they land in; the JAX backward
// is deterministic, so every output element has one owner that adds its
// terms in a fixed order.  The design, in order:
//
// 1. Tables once per ROI (roi_align_bwd_tables_kernel).  One thread per
//    (image, ROI, bin of one axis) writes the bin's merged taps, at most
//    2*sr (index, weight) pairs from K2's merged_row (the same text in both
//    sources, held equal by tests/test_torch_roi_align_taps.py), and the
//    bin's first and last index, to a scratch the wrapper allocates.  Taps
//    ascend with the bin, so the bins that touch feature row h are the
//    range [s0, s1] with s0 = #{s : last(s) < h} and s1 + 1 = #{s :
//    first(s) <= h}; the same for a band of feature columns.
// 2. Ownership.  One block per (band of kBand feature columns, channel
//    group) along grid.x, feature row h along grid.y and image along
//    grid.z.  Each thread owns one 16-byte vector of channels (8 bf16 or 4
//    fp32) of the band's columns: kBand x V fp32 accumulators in
//    registers.
// 3. The list.  Per chunk of kChunk ROIs each thread takes a ROI, finds
//    its s-range for h and t-range for the band from the spans, and stages
//    wy[s, h] over the one and wx[t, b0 .. b0 + kBand) over the other
//    (dense, 0 off the bin's taps) in shared memory; warp 0 compacts the
//    ROIs that touch both, in ascending order, into a list.
// 4. The walk.  Every thread walks the list (ROI ascending, t ascending, s
//    ascending within t) with one 16 B load of g per (ROI, s, t).  The
//    loads go through a ring of kDepth cp.async slots per thread, so
//    kDepth - 1 of them are in flight across bins and across ROIs; a
//    thread reads back only its own slots, so the walk needs no barrier.
// 5. Fold and scatter in fp32.  row = sum_s wy[s, h] * g[r, s, t, :]
//    (fmaf, s ascending), then for each column x of the band whose wx[t, x]
//    is not 0, acc[x] = fmaf(wx[t, x], row, acc[x]).  The loop over the
//    band's columns is unrolled, so acc stays in registers, and the test
//    on the weight is the same for the whole block.
// 6. One 16 B store per owned column at the end, rounded once.
//
// Channel counts that are not a multiple of the vector, or a g or dfeat
// base that is not 16 B aligned, take the same kernel with one channel per
// thread (bf16 then copies into the ring synchronously: cp.async moves 4,
// 8 or 16 bytes).  Offsets within an image are 32-bit where R*ph*pw*C <
// 2^31, 64-bit otherwise.  Every thread of a block adds the same ROIs in
// the same order to registers of its own, so two launches give the same
// bits.  tests/test_torch_roi_align_bwd_model.py models the tables, the
// ownership, the order, the skip rules and the one rounding on the CPU,
// and counts the loads.
//
// What bounds it on an H100: bytes.  At the training shape (2 x 128 rois,
// 14x14, 38x64x1024 bf16) it must read g (103 MB) and write dfeat
// (10 MB): 113 MB, 0.0336 ms at 3.35 TB/s; its ~1.6 GFLOP of fp32 FMAs
// would take ~25 us.  At the smoke's random ROIs each g element is read
// 2.97 times with bands of 4 columns (2.57 with bands of 8), mostly from
// L2.
//
// What sets its time instead, from probes on an H100 80GB HBM3 at 700 W
// (per-block clock64 records, cuobjdump, ablations; the numbers are at
// 2 x 128 random ROIs in bf16, chip_smoke.py's phase 4 inputs):
// - The first version read each bin's column taps from the tables at its
//   scatter, four dependent L2 loads per bin: 0.42 ms, in proportion to
//   the busiest block's loads.  Staging wx in shared memory (step 3) took
//   it to 0.23 ms.
// - Then the card is full (4 blocks of 128 threads per SM, 126
//   registers) and issue-bound: the walk's loop is ~55 instructions per
//   load (the cp.async, the ring, the walk's counters, 8 conversions, 8
//   FMAs), ~250 cycles per load with 16 warps sharing an SM, and each
//   block's list costs ~19 us of L2 latency.  Without its loads of g the
//   kernel still takes 0.15 ms; without its scatter, 0.18 ms.
// - Bands of 4 columns (more blocks, half the accumulators) beat bands of
//   8 on random ROIs (0.176 against 0.214 ms) and cost 7% on 16-64 px
//   ROIs; a ring of 8 loads beat 16 (occupancy).  Splitting each list
//   across the warps of a block (kSplit parts, summed in order), dense
//   weight rows in the tables, and a flat walk fed by shuffles were
//   measured and left out: none beat this design by more than 15% on
//   both ROI sets.  This design takes 0.178 ms there (chip_smoke.py, same
//   card): 19% of its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBand = 4;          // feature columns a block owns
constexpr int kThreads = 128;     // channel vectors per block, at most
constexpr int kDepth = 8;         // cp.async slots per thread
constexpr int kChunk = 64;        // ROIs listed in shared memory at once
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

// Scratch, per (image, ROI) and bin b < ph + pw (rows first, then
// columns): 2*sr WTap<int> (index, weight), unused ones (-1, 0), then one
// int per bin, first | last << 16.  The wrapper sizes it with the same
// formula (ops/roi_pool.py — _bwd_scratch_bytes).
__host__ __device__ inline size_t tap_bytes(size_t nr, int ph, int pw,
                                            int sr) {
  return nr * (ph + pw) * 2 * sr * sizeof(WTap<int>);
}
__host__ __device__ inline size_t scratch_bytes(size_t nr, int ph, int pw,
                                                int sr) {
  return tap_bytes(nr, ph, pw, sr) + nr * (ph + pw) * sizeof(int);
}

__global__ void roi_align_bwd_tables_kernel(const float* __restrict__ rois,
                                            int nr, int h, int w, int ph,
                                            int pw, int sr, float scale,
                                            WTap<int>* __restrict__ taps,
                                            int* __restrict__ span) {
  const int bins = ph + pw;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)nr * bins) return;
  const int b = (int)(i % bins);
  const float* roi = rois + i / bins * 4;
  const float x1 = __fmul_rn(roi[0], scale);
  const float y1 = __fmul_rn(roi[1], scale);
  const float x2 = __fmul_rn(roi[2], scale);
  const float y2 = __fmul_rn(roi[3], scale);
  const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, x1), 1.0f), (float)pw);
  const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, y1), 1.0f), (float)ph);
  const int nt = 2 * sr;
  WTap<int>* t = taps + i * nt;
  // (1 - frac) > 0, so every table has at least one entry
  const int n = b < ph ? merged_row(y1, bin_h, sr, b, h, 1, t)
                       : merged_row(x1, bin_w, sr, b - ph, w, 1, t);
  for (int e = n; e < nt; ++e) {
    t[e].off = -1;
    t[e].w = 0.0f;
  }
  span[i] = t[0].off | (t[n - 1].off << 16);
}

// a ROI of the chunk (i) that touches the block: its bins s0..s1, t0..t1
struct Hit {
  int i;
  short s0, s1, t0, t1;
};

// the producer's place in the list: hit k, bin (s, t), and g's address
// there (offsets within one image, the chunk's first ROI at r0)
template <typename T, typename Index>
struct Walk {
  int k, s, t, s0, s1, t1;
  const T* at;   // g[r, s, t, ci]
  const T* t_at;  // g[r, s0, t, ci]

  __device__ __forceinline__ void start(const Hit* hits, int nh, int k_,
                                        const T* g_n, int r0, int ph, int pw,
                                        int c) {
    k = k_;
    if (k >= nh) return;
    const Hit x = hits[k];
    s = s0 = x.s0;
    s1 = x.s1;
    t = x.t0;
    t1 = x.t1;
    at = t_at = g_n + (((Index)(r0 + x.i) * ph + s0) * pw + t) * (Index)c;
  }
  // s ascending within t, t ascending within the ROI, then the next ROI
  __device__ __forceinline__ void next(const Hit* hits, int nh, const T* g_n,
                                       int r0, int ph, int pw, int c) {
    if (s < s1) {
      ++s;
      at += (Index)pw * c;
    } else if (t < t1) {
      s = s0;
      ++t;
      at = t_at += c;
    } else {
      start(hits, nh, k + 1, g_n, r0, ph, pw, c);
    }
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one thread's V channels of g into its ring slot
__device__ __forceinline__ void copy_in(float* dst, const float* src,
                                        int vlen) {
  if (vlen == 4) cp_async16(dst, src);
  else cp_async4(dst, src);
}
__device__ __forceinline__ void copy_in(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src, int vlen) {
  if (vlen == 8) cp_async16(dst, src);
  else *dst = *src;  // 2 bytes: below cp.async's smallest copy
}

// V contiguous channels as fp32, from a ring slot or out to dfeat
__device__ __forceinline__ void unpack(const float* p, float (&v)[1]) {
  v[0] = *p;
}
__device__ __forceinline__ void unpack(const __nv_bfloat16* p,
                                       float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void unpack(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void unpack(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
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

template <typename T, int V, typename Index>
__global__ void __launch_bounds__(kThreads)
roi_align_bwd_kernel(const T* __restrict__ g,
                     const WTap<int>* __restrict__ taps,
                     const int* __restrict__ span, int r, int h, int w, int c,
                     int ph, int pw, int sr, int groups,
                     T* __restrict__ dfeat) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  T* ring = reinterpret_cast<T*>(smem);  // [kDepth][nthreads][V]
  float* wys = reinterpret_cast<float*>(
      smem + (size_t)kDepth * nthreads * V * sizeof(T));  // [kChunk][ph]
  float* wxs = wys + (size_t)kChunk * ph;  // [kChunk][pw][kBand]
  Hit* hits = reinterpret_cast<Hit*>(wxs + (size_t)kChunk * pw * kBand);
  int* nhits = reinterpret_cast<int*>(hits + kChunk);

  const int b0 = blockIdx.x / groups * kBand;
  const int b1 = min(b0 + kBand, w) - 1;  // the band's last column
  const int hrow = blockIdx.y;
  const int ni = blockIdx.z;
  const int ci = (blockIdx.x % groups * nthreads + tid) * V;
  const bool active = ci < c;
  const int bins = ph + pw;
  const int nt = 2 * sr;
  const T* g_n = g + (size_t)ni * r * ph * pw * c + ci;
  T* mine = ring + tid * V;  // slot q of this thread: mine + q*nthreads*V

  float acc[kBand][V];
#pragma unroll
  for (int j = 0; j < kBand; ++j)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[j][k] = 0.0f;

  for (int r0 = 0; r0 < r; r0 += kChunk) {
    const int rc = min(kChunk, r - r0);
    __syncthreads();  // the previous chunk's list is no longer read
    for (int i = tid; i < rc; i += nthreads) {
      const size_t roi_i = (size_t)ni * r + r0 + i;
      const int* sp = span + roi_i * bins;
      int s0 = 0, s1 = -1, t0 = 0, t1 = -1;
#pragma unroll 8
      for (int s = 0; s < ph; ++s) {
        const int v = __ldg(sp + s);
        s0 += (v >> 16) < hrow;
        s1 += (v & 0xffff) <= hrow;
      }
#pragma unroll 8
      for (int t = 0; t < pw; ++t) {
        const int v = __ldg(sp + ph + t);
        t0 += (v >> 16) < b0;
        t1 += (v & 0xffff) <= b1;
      }
      Hit x;
      x.i = i;
      x.s0 = (short)s0;
      x.s1 = (short)s1;
      x.t0 = (short)t0;
      x.t1 = (short)t1;
      if (s0 <= s1 && t0 <= t1) {
        // wy[s, h] over the s-range and wx[t, b0 + j] over the t-range, 0
        // off the bins' taps.  A ROI's bins lie one after another in the
        // tables, so each range is one flat loop with loads in flight.
        float* wy = wys + i * ph;
        float* wx = wxs + (size_t)i * pw * kBand;
        for (int s = s0; s <= s1; ++s) wy[s] = 0.0f;
        for (int e = t0 * kBand; e < (t1 + 1) * kBand; ++e) wx[e] = 0.0f;
        const WTap<int>* ty = taps + (roi_i * bins + s0) * nt;
#pragma unroll 8
        for (int e = 0; e < (s1 - s0 + 1) * nt; ++e) {
          const WTap<int> tap = ty[e];
          if (tap.off == hrow) wy[s0 + e / nt] = tap.w;
        }
        const WTap<int>* tx = taps + (roi_i * bins + ph + t0) * nt;
#pragma unroll 8
        for (int e = 0; e < (t1 - t0 + 1) * nt; ++e) {
          const WTap<int> tap = tx[e];
          const int j = tap.off - b0;  // the padding's -1 is never in band
          if (j >= 0 && j < kBand) wx[(t0 + e / nt) * kBand + j] = tap.w;
        }
      } else {
        x.s1 = -1;  // a miss: s0 > s1
        x.s0 = 0;
      }
      hits[i] = x;
    }
    __syncthreads();
    if (tid < 32) {  // compact the hits in place, in ROI order
      int count = 0;
      for (int base = 0; base < rc; base += 32) {
        Hit x{};
        bool hit = false;
        if (base + tid < rc) {
          x = hits[base + tid];
          hit = x.s0 <= x.s1;
        }
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit) hits[count + __popc(m & ((1u << tid) - 1u))] = x;
        count += __popc(m);
      }
      if (tid == 0) *nhits = count;
    }
    __syncthreads();
    const int nh = *nhits;
    if (!active || nh == 0) continue;

    Walk<T, Index> p;  // the producer runs kDepth - 1 loads ahead
    p.start(hits, nh, 0, g_n, r0, ph, pw, c);
    int ps = 0, qs = 0;  // ring slots
    auto produce = [&]() {
      if (p.k < nh) {
        copy_in(mine + (size_t)ps * nthreads * V, p.at, V);
        p.next(hits, nh, g_n, r0, ph, pw, c);
      }
      cp_async_commit();  // empty past the end, to keep the count
      ps = ps + 1 == kDepth ? 0 : ps + 1;
    };
#pragma unroll 1
    for (int e = 0; e < kDepth - 1; ++e) produce();
#pragma unroll 1
    for (int k = 0; k < nh; ++k) {
      const Hit x = hits[k];
      const float* wy = wys + x.i * ph;
#pragma unroll 1
      for (int t = x.t0; t <= x.t1; ++t) {
        float row[V];
#pragma unroll
        for (int m = 0; m < V; ++m) row[m] = 0.0f;
#pragma unroll 1
        for (int s = x.s0; s <= x.s1; ++s) {
          cp_async_wait<kDepth - 2>();  // this load's copy has landed
          produce();                    // into the slot freed last time
          float v[V];
          unpack(mine + (size_t)qs * nthreads * V, v);
          qs = qs + 1 == kDepth ? 0 : qs + 1;
          axpy(row, wy[s], v);
        }
        // bin t is folded: scatter it over its taps in the band
        const float* wx = wxs + ((size_t)x.i * pw + t) * kBand;
#pragma unroll
        for (int j = 0; j < kBand; ++j) {
          const float wj = wx[j];
          if (wj != 0.0f) axpy(acc[j], wj, row);
        }
      }
    }
  }
  if (!active) return;
  T* out = dfeat + (((size_t)ni * h + hrow) * w + b0) * c + ci;
#pragma unroll
  for (int j = 0; j < kBand; ++j)
    if (b0 + j <= b1) store(out + (size_t)j * c, acc[j]);
}

template <typename T, int V, typename Index>
int launch(const T* g, const WTap<int>* taps, const int* span, T* dfeat,
           int n, int r, int h, int w, int c, int ph, int pw, int sr,
           cudaStream_t stream) {
  const int vecs = (c + V - 1) / V;
  const int threads = vecs >= kThreads ? kThreads : ((vecs + 31) / 32) * 32;
  const int groups = (vecs + threads - 1) / threads;
  const int bands = (w + kBand - 1) / kBand;
  if ((size_t)bands * groups > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kDepth * threads * V * sizeof(T)
                      + (size_t)kChunk * (ph + pw * kBand) * sizeof(float)
                      + (size_t)kChunk * sizeof(Hit) + sizeof(int);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        roi_align_bwd_kernel<T, V, Index>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)(bands * groups), (unsigned)h, (unsigned)n);
  roi_align_bwd_kernel<T, V, Index><<<grid, threads, smem, stream>>>(
      g, taps, span, r, h, w, c, ph, pw, sr, groups, dfeat);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* g, const WTap<int>* taps, const int* span,
                 void* dfeat, int n, int r, int h, int w, int c, int ph,
                 int pw, int sr, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* gt = (const T*)g;
  T* out = (T*)dfeat;
  const bool vec = c % kVec == 0 && (size_t)g % 16 == 0
                   && (size_t)dfeat % 16 == 0;
  const bool narrow = (size_t)r * ph * pw * c < ((size_t)1 << 31);
  if (vec && narrow)
    return launch<T, kVec, int>(gt, taps, span, out, n, r, h, w, c, ph, pw,
                                sr, stream);
  if (vec)
    return launch<T, kVec, long long>(gt, taps, span, out, n, r, h, w, c, ph,
                                      pw, sr, stream);
  if (narrow)
    return launch<T, 1, int>(gt, taps, span, out, n, r, h, w, c, ph, pw, sr,
                             stream);
  return launch<T, 1, long long>(gt, taps, span, out, n, r, h, w, c, ph, pw,
                                 sr, stream);
}

}  // namespace

// g (n, r, ph, pw, c) fp32 or bf16; rois (n, r, 4) fp32 in input
// coordinates; dfeat (n, h, w, c) in g's dtype, every element written;
// scratch of at least scratch_bytes(n * r, ph, pw, sr) bytes, 16 B
// aligned.  Two kernels on the stream: the tables, then the walk.
extern "C" int roi_align_bwd_launch(const void* g, const float* rois,
                                    void* dfeat, void* scratch,
                                    long long scratch_size, int is_bf16,
                                    int n, int r, int h, int w, int c,
                                    int ph, int pw, int sr, float scale,
                                    void* stream) {
  if (n == 0 || h == 0 || w == 0 || c == 0) return 0;
  if (sr < 1 || r < 0 || ph < 0 || pw < 0 || h > 32767 || w > 32767
      || n > 65535 || ph > 32767 || pw > 32767)
    return (int)cudaErrorInvalidValue;
  const size_t nr = (size_t)n * r;
  if (scratch_size < 0
      || (size_t)scratch_size < scratch_bytes(nr, ph, pw, sr)
      || (size_t)scratch % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  WTap<int>* taps = (WTap<int>*)scratch;
  int* span = (int*)((char*)scratch + tap_bytes(nr, ph, pw, sr));
  const size_t nbins = nr * (ph + pw);
  if (nbins > 0) {
    if (nr > 0x7fffffffu || nbins > (size_t)0x7fffffff * 128)
      return (int)cudaErrorInvalidValue;
    roi_align_bwd_tables_kernel<<<(unsigned)((nbins + 127) / 128), 128, 0,
                                  s>>>(rois, (int)nr, h, w, ph, pw, sr, scale,
                                       taps, span);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (is_bf16) {
    return launch_dtype<__nv_bfloat16>(g, taps, span, dfeat, n, r, h, w, c,
                                       ph, pw, sr, s);
  }
  return launch_dtype<float>(g, taps, span, dfeat, n, r, h, w, c, ph, pw, sr,
                             s);
}
