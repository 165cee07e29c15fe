// Exact greedy-NMS keep mask over score-sorted boxes, batched over images.
//
// Replaces: mx_rcnn_tpu/ops/nms_pallas.py — _sweep_kernel (entry
// suppression_sweep_pallas).  Same function: box i (in sorted order) is kept
// iff alive_init[i] and no kept box j < i has IoU(i, j) > thr, with the
// reference's +1-pixel IoU (ops/boxes.py — bbox_overlaps).
//
// Why not the TPU design: the Pallas kernel walks tiles through a sequential
// grid with the keep mask resident in VMEM.  CUDA blocks run in parallel and
// in no order, so this is a two-pass bitmask sweep (the design of the
// original implementation, rcnn/cython/nms_kernel.cu), laid out for Hopper.
// Boxes go in blocks of 64; n = ceil(k / 64).
//
//   (a) nms_mask_kernel — one block of 64 threads per (row block, col block,
//       image) on or above the diagonal (a 1-D grid over the upper
//       triangle), one thread per row box, the 64 col boxes in shared
//       memory.  It writes, for each row i, a 64-bit word whose bit q is
//       IoU(i, col_base + q) > thr for col_base + q > i.  The words are
//       column-block-major, mask[b][col block][row] with rows padded to
//       64 n, so a block's 64 words are one contiguous 512 B store.  Exact
//       shortcuts: a pair with iw <= 0 or ih <= 0 has IoU exactly 0 (bit =
//       0 > thr, no divide); dead rows (alive_init false, or past k) and
//       dead columns are never read with effect, so they get no IoU and 0
//       bits.
//   (b) nms_reduce_kernel — one block per image: warp 0 resolves the chain,
//       min(n, 31) "mover" warps copy and OR the words.  It walks the row
//       blocks in order with `removed` (one word per col block) in shared
//       memory.  For row block nb:
//       - the words of rows nb*64.. of col blocks nb.. (the diagonal block
//         and every later one) are already in one slot of a double-buffered
//         shared tile: the movers copied them with cp.async while row block
//         nb-1 was resolved, and they start nb+1's copies before nb's chain
//         resolves;
//       - warp 0 holds the 64 diagonal words, two per lane.  Rows 0..31
//         decide on the low halves alone, so it broadcasts those with
//         __shfl_sync and runs the 32-step chain on registers, folds the kept
//         rows' high halves in with one __reduce_or_sync, then runs rows
//         32..63 the same way (their low halves are 0 by the triangle).  It
//         publishes the keep word kw and the 64 keep bytes;
//       - mover mw owns col blocks j = mw (mod movers).  Lane q masks the
//         words of rows q and q+32 by kw, and the warp ORs them with
//         __reduce_or_sync on the two 32-bit halves into removed[j], eight
//         col blocks at a time.
//       Two __syncthreads per row block.  Col blocks past the tile's
//       capacity (only when 2 * n * 512 B exceeds shared memory, K > 14400)
//       are read straight from global memory in the OR step.
//
// What bounds it on an H100: (a) is K^2/2 IoUs per image (~17 fp32 ops and
// an IEEE divide for each intersecting pair), arithmetic spread over the
// whole card.  (b) runs on one SM per image: a serial chain of n row
// blocks, and nothing in it waits on a load per kept box.  Its bound is
// moving each row block's words (the upper triangle, 9 MB per image at
// K=12032, 48 KB per row block on average) through that one SM: the copy,
// and the OR, whose shared loads share the load/store path with the
// landing copy, each take longer than the chain; a row block with nothing
// kept skips the OR.  In probes on the card, TMA bulk copies in place of
// cp.async were slower, and so were fewer mover warps; skipping all-zero
// ORs, shared atomics in place of the reductions, and masking the copy by
// a per-block occupancy word changed little.  Holding each mover's words
// in registers in place of the tile was a little faster, but a 1024-thread
// block's registers hold one row block's words, not two, so those loads
// could only be started after the OR and nb+1's words were no longer in
// flight during nb's chain.  Moving fewer bytes (a compact list of the
// nonzero words) is the next step.
//
// Exactness: the IoU uses exactly the reference's operations and order, each
// rounded once (__fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn, and the library is
// built with --fmad=false so nothing is contracted into an FMA), and tests
// `iou > thr`, never `inter > thr * union`.  IEEE addition is commutative,
// so IoU(i, j) == IoU(j, i) bit for bit, as the reference relies on.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;
constexpr int kMovers = 31;   // mover warps beside the chain warp
constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f),
                   __fadd_rn(__fsub_rn(y2, y1), 1.0f));
}

// Pair t of the upper triangle {(rb, cb): rb <= cb < n}, in row-major order:
// t = 0 is (0, 0), then (0, 1) .. (0, n-1), (1, 1), ...  Counted from the
// end, row block n-1-r holds r+1 pairs, so r is a triangular root.
__device__ __forceinline__ void tri_pair(int t, int n, int* rb, int* cb) {
  const long long total = (long long)n * (n + 1) / 2;
  const long long tp = total - 1 - t;
  long long r = (long long)((sqrt(8.0 * (double)tp + 1.0) - 1.0) * 0.5);
  while ((r + 1) * (r + 2) / 2 <= tp) ++r;
  while (r * (r + 1) / 2 > tp) --r;
  const int e = (int)(tp - r * (r + 1) / 2);  // 0..r
  *rb = n - 1 - (int)r;
  *cb = n - 1 - e;
}

__global__ void __launch_bounds__(kBlock)
nms_mask_kernel(const float* __restrict__ boxes,
                const uint8_t* __restrict__ alive, int k, int n, float thr,
                u64* __restrict__ mask) {
  int rb, cb;
  tri_pair(blockIdx.x, n, &rb, &cb);
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const float* bx = boxes + (size_t)b * k * 4;
  const uint8_t* al = alive + (size_t)b * k;
  u64* out = mask + ((size_t)b * n + cb) * ((size_t)n * kBlock) +
             (size_t)rb * kBlock;

  __shared__ float4 cbox[kBlock];
  __shared__ float carea[kBlock];
  __shared__ unsigned live_half[2];
  const int col = cb * kBlock + t;
  const bool col_live = col < k && al[col];
  if (col_live) {
    const float4 p = reinterpret_cast<const float4*>(bx)[col];
    cbox[t] = p;
    carea[t] = box_area(p.x, p.y, p.z, p.w);
  }
  const unsigned live = __ballot_sync(kFull, col_live);
  if ((t & 31) == 0) live_half[t >> 5] = live;
  const int i = rb * kBlock + t;
  const bool row_live = i < k && al[i];
  // a block of dead rows writes zero words and is done
  if (!__syncthreads_or(row_live) || !row_live) {
    out[t] = 0;
    return;
  }

  const float4 r = reinterpret_cast<const float4*>(bx)[i];
  const float area = box_area(r.x, r.y, r.z, r.w);
  // a non-intersecting pair has IoU exactly 0
  const bool zero_hit = 0.0f > thr;
  u64 todo = ((u64)live_half[1] << 32) | live_half[0];
  if (rb == cb) todo &= t == kBlock - 1 ? 0ULL : ~0ULL << (t + 1);
  unsigned bits[2] = {0u, 0u};
  // unrolled: the column's slot and its bit are constants; off the
  // diagonal `todo` is the same in every lane, so the test does not diverge
#pragma unroll
  for (int q = 0; q < kBlock; ++q) {
    if (!((todo >> q) & 1ULL)) continue;
    const float4 c = cbox[q];
    const float iw = __fadd_rn(__fsub_rn(fminf(r.z, c.z), fmaxf(r.x, c.x)),
                               1.0f);
    const float ih = __fadd_rn(__fsub_rn(fminf(r.w, c.w), fmaxf(r.y, c.y)),
                               1.0f);
    bool hit = zero_hit;
    if (iw > 0.0f && ih > 0.0f) {
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(area, carea[q]), inter);
      const float iou =
          uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
      hit = iou > thr;
    }
    if (hit) bits[q >> 5] |= 1u << (q & 31);
  }
  out[t] = ((u64)bits[1] << 32) | bits[0];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// Copy rows nb*64.. of col blocks nb .. nb+tile_cols-1 (those that exist)
// into one slot of the tile: slot[c * 64 + row] is col block nb + c.  Mover
// warp mw copies col blocks c = mw (mod movers), 16 bytes a lane.
__device__ __forceinline__ void prefetch_rows(const u64* m, u64* slot, int nb,
                                              int n, int tile_cols, int mw,
                                              int movers) {
  const size_t kpad = (size_t)n * kBlock;
  const int cols = min(n - nb, tile_cols);
  const int part = (threadIdx.x & 31) * 2;
  const u64* src = m + (size_t)(nb + mw) * kpad + (size_t)nb * kBlock + part;
  u64* dst = slot + mw * kBlock + part;
  for (int c = mw; c < cols; c += movers) {
    cp_async16(dst, src);
    src += (size_t)movers * kpad;
    dst += movers * kBlock;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// OR the kept rows' words of this mover's col blocks j = j0, j0 + movers,
// ... below end into removed[j].  From the tile, col block j's 64 words
// start at src + (j - off) * 64; from the mask, at src + j * off.  Eight col
// blocks at a time: every load and reduction, then lane s updates slot s.
template <bool kTile>
__device__ __forceinline__ void or_rows(const u64* src, u64* removed, int j0,
                                        int end, int movers, int off,
                                        bool k_lo, bool k_hi) {
  const int lane = threadIdx.x & 31;
  for (int jc = j0; jc < end; jc += 8 * movers) {
    unsigned lo[8], hi[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int j = jc + s * movers;
      lo[s] = hi[s] = 0;
      if (j < end) {
        const u64* w = kTile ? src + (size_t)(j - off) * kBlock
                             : src + (size_t)j * off;
        const u64 acc =
            (k_lo ? w[lane] : 0ULL) | (k_hi ? w[lane + 32] : 0ULL);
        lo[s] = __reduce_or_sync(kFull, (unsigned)acc);
        hi[s] = __reduce_or_sync(kFull, (unsigned)(acc >> 32));
      }
    }
    u64 word = 0;
#pragma unroll
    for (int s = 0; s < 8; ++s)
      if (lane == s) word = ((u64)hi[s] << 32) | lo[s];
    const int j = jc + lane * movers;
    if (lane < 8 && j < end) removed[j] |= word;
  }
}

// Warp 0 resolves the chain; warps 1.. ("movers", at least one) copy the
// words into the tile and OR them into `removed`.
__global__ void __launch_bounds__(1024)
nms_reduce_kernel(const u64* __restrict__ mask,
                  const uint8_t* __restrict__ alive, int k, int n,
                  int tile_cols, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) u64 smem[];
  u64* removed = smem;                             // [n]
  u64* kw_s = smem + n;                            // [1]
  u64* tile = smem + ((n + 2) & ~1);               // [2][tile_cols][64]
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5, movers = warps - 1, mw = warp - 1;
  int next_j = mw;
  const size_t kpad = (size_t)n * kBlock;
  const u64* m = mask + (size_t)b * n * kpad;
  const uint8_t* al = alive + (size_t)b * k;
  uint8_t* kp = keep + (size_t)b * k;

  // seed `removed` from ~alive_init; slots past k count as removed
  for (int j = warp; j < n; j += warps) {
    const int i0 = j * kBlock + lane, i1 = i0 + 32;
    const unsigned lo = __ballot_sync(kFull, i0 >= k || !al[i0]);
    const unsigned hi = __ballot_sync(kFull, i1 >= k || !al[i1]);
    if (lane == 0) removed[j] = ((u64)hi << 32) | lo;
  }
  if (warp > 0) prefetch_rows(m, tile, 0, n, tile_cols, mw, movers);

  for (int nb = 0; nb < n; ++nb) {
    if (warp > 0) asm volatile("cp.async.wait_all;\n" ::: "memory");
    // nb's words have landed everywhere, removed[nb] is final, and the
    // other slot is free again
    __syncthreads();
    const u64* cur = tile + (nb & 1) * tile_cols * kBlock;
    const int base = nb * kBlock;
    if (warp == 0) {
      // lane q holds the diagonal words of rows q and q+32, as 32-bit halves
      const u64 dl = cur[lane], dh = cur[lane + 32];
      const u64 r = removed[nb];
      unsigned r_lo = (unsigned)r, r_hi = (unsigned)(r >> 32);
      unsigned kw_lo = 0, kw_hi = 0, w[32];
      // rows 0..31 decide on the low halves alone: broadcast them all, then
      // run the chain on registers
#pragma unroll
      for (int q = 0; q < 32; ++q) w[q] = __shfl_sync(kFull, (unsigned)dl, q);
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        if (!((r_lo >> q) & 1u)) {
          kw_lo |= 1u << q;
          r_lo |= w[q];
        }
      }
      // the kept rows' high halves, folded in one reduction
      r_hi |= __reduce_or_sync(
          kFull, ((kw_lo >> lane) & 1u) ? (unsigned)(dl >> 32) : 0u);
      // rows 32..63 suppress only later rows of the block: their low halves
      // are 0
#pragma unroll
      for (int q = 0; q < 32; ++q)
        w[q] = __shfl_sync(kFull, (unsigned)(dh >> 32), q);
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        if (!((r_hi >> q) & 1u)) {
          kw_hi |= 1u << q;
          r_hi |= w[q];
        }
      }
      if (lane == 0) *kw_s = ((u64)kw_hi << 32) | kw_lo;
      if (base + lane < k) kp[base + lane] = (uint8_t)((kw_lo >> lane) & 1u);
      if (base + lane + 32 < k)
        kp[base + lane + 32] = (uint8_t)((kw_hi >> lane) & 1u);
    } else if (nb + 1 < n) {
      // nb+1's words are in flight while nb's chain resolves
      prefetch_rows(m, tile + ((nb + 1) & 1) * tile_cols * kBlock, nb + 1, n,
                    tile_cols, mw, movers);
    }
    __syncthreads();
    if (warp == 0) continue;
    // mover mw owns col blocks j = mw (mod movers); next_j is its first
    // after nb
    if (next_j == nb) next_j += movers;
    const u64 kw = *kw_s;
    if (kw == 0) continue;
    const bool k_lo = (kw >> lane) & 1ULL, k_hi = (kw >> (lane + 32)) & 1ULL;
    // col blocks nb+1 .. in the tile, then any past its capacity
    const int split = min(n, nb + tile_cols);
    or_rows<true>(cur, removed, next_j, split, movers, nb, k_lo, k_hi);
    if (split < n) {
      const int j0 = next_j + max(0, split - next_j + movers - 1) / movers *
                                  movers;
      or_rows<false>(m + base, removed, j0, n, movers, (int)kpad, k_lo,
                     k_hi);
    }
  }
}

}  // namespace

// boxes (batch, k, 4) fp32 sorted by descending score; alive (batch, k)
// bool; mask scratch (batch, n, 64 n) u64 with n = ceil(k / 64); keep
// (batch, k) bool out.
extern "C" int nms_sweep_launch(const float* boxes, const uint8_t* alive,
                                int batch, int k, float thr, void* mask,
                                uint8_t* keep, void* stream) {
  if (batch == 0 || k == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = (k + kBlock - 1) / kBlock;
  const long long pairs = (long long)n * (n + 1) / 2;
  if (pairs > INT_MAX) return (int)cudaErrorInvalidValue;
  nms_mask_kernel<<<dim3((unsigned)pairs, batch), kBlock, 0, s>>>(
      boxes, alive, k, n, thr, (u64*)mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int dev = 0, optin = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t head = (size_t)((n + 2) & ~1) * sizeof(u64);
  const size_t per_col = 2 * kBlock * sizeof(u64);
  if ((size_t)optin < head + per_col) return (int)cudaErrorInvalidValue;
  const size_t fit = ((size_t)optin - head) / per_col;
  const int tile_cols = fit < (size_t)n ? (int)fit : n;
  const size_t smem = head + (size_t)tile_cols * per_col;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_reduce_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // one chain warp and min(n, 31) movers
  const int threads = 32 * (1 + (n < kMovers ? n : kMovers));
  nms_reduce_kernel<<<batch, threads, smem, s>>>((const u64*)mask, alive, k,
                                                  n, tile_cols, keep);
  return (int)cudaGetLastError();
}
