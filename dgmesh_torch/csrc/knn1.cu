// Exact nearest neighbour (k = 1) — CUDA C++ for Hopper (sm_90a).
//
// Replaces no TPU kernel: dgmesh_tpu/ops/knn.py is plain XLA (a blocked
// distance matrix and a min).  Added because the port's blocked twin
// (ops/knn.py::knn_ref) writes a float32 distance block of ~1 GiB for every
// ~320 queries and passes over it four more times: at the anchor's sizes
// (262,144 queries, ~830k valid face centroids) ~820 blocks and ~6 GB of
// traffic each, 2.7-2.8 s a call.
//
// What it computes, for each query q (Q,3) against the compacted refs r
// (R,3): the smallest d = max((‖q‖² + ‖r‖²) − 2 q·r, 0) and the lowest ref
// index that reaches it, in the twin's arithmetic: ‖q‖² and ‖r‖² are the
// twin's own (the wrapper computes them with the same PyTorch reductions),
// q·r is the running multiply-add chain over x, y, z of the twin's float32
// matrix product, and −2 q·r is that product scaled by the power of two
// (exact), so d has the twin's bits.  A NaN anywhere in a query's row
// makes its d NaN, as torch.min does; the wrapper's index of a non-finite
// d is 0, as the twin's.
//
// What bounds it on the H100: instruction issue.  A (query, ref) pair needs
// a multiply, two multiply-adds, two adds and a NaN-keeping minimum: six
// instructions; at the anchor's 262,144 × ~836k pairs that is ~1.3e12
// instructions, ~39 ms at 132 SMs × 128 lanes × 1.98 GHz.  The refs are
// 16 bytes each, ~13 MB in all, read from L2 by every CTA; nothing of the
// (Q, R) distances reaches device memory.
//
// Design: one thread per QT = 2 queries, each held in registers with its
// running minimum and index, so that one shared-memory broadcast of a ref
// serves two pairs; a CTA of THREADS = 128 threads owns 256 queries, 1,024
// CTAs at the anchor's sizes.  At 56 registers the occupancy calculator
// fits 9 such CTAs on an SM, so all 1,024 (7.76 an SM) run in one wave, ~31
// warps an SM.  The refs, prescaled by the wrapper to (−2x, −2y, −2z,
// ‖r‖²) and padded to whole tiles with copies of the last ref (a copy ties
// with it and never wins), stream through shared memory in tiles of TILE
// float4, two stages with cp.async.  Every thread walks all refs in
// ascending order: a chunk of CHUNK refs takes only the minimum of the
// chunk's d (one instruction a pair); where the clamped minimum beats the
// running one (strictly, so a tie keeps the lower index), the chunk is
// walked again for the first ref that reaches it, with the same
// instructions and so the same bits (the compiler keeps the chunk's d in
// registers for it).  The loop issues ~6.9 instructions a pair with the
// loads, checks and counters.  On an H100 80GB HBM3 at 700 W, at the
// anchor's inputs: CHUNK 16 ran 66.9 ms, 8 68.1, 4 75.9; four queries a
// thread 74.3 (half the warps); queries sorted along a Morton curve 64.7
// (the re-walks cost ~3%).  No
// merge across CTAs: two launches give the same bits.  Built with
// --fmad=false like the other kernels; the multiply-adds are explicit.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int QT = 2;          // queries a thread
constexpr int THREADS = 128;   // threads a CTA
constexpr int QUERIES = QT * THREADS;
constexpr int TILE = 256;      // refs a shared-memory stage (4 KB)
constexpr int CHUNK = 16;      // refs a step of the running minimum

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// (‖q‖² + ‖r‖²) − 2 q·r with r = (−2x, −2y, −2z, ‖r‖²)
__device__ __forceinline__ float dist2(float x, float y, float z, float qq, float4 r) {
  const float dot = __fmaf_rn(z, r.z, __fmaf_rn(y, r.y, __fmul_rn(x, r.x)));
  return __fadd_rn(__fadd_rn(qq, r.w), dot);
}

// m beats the running minimum b: strictly smaller, or NaN while b is not
// (a NaN minimum stays)
__device__ __forceinline__ bool beats(float m, float b) { return !(m >= b) && b == b; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void stage(float4* dst, const float4* src) {
#pragma unroll
  for (int i = threadIdx.x; i < TILE; i += THREADS) cp_async16(dst + i, src + i);
}

__global__ void __launch_bounds__(THREADS)
knn1_kernel(const float* __restrict__ queries, const float* __restrict__ qnorm,
            const float4* __restrict__ refs, int Q, int n_tiles,
            const long long* __restrict__ ids, float* __restrict__ out_d,
            long long* __restrict__ out_i) {
  __shared__ __align__(16) float4 tile[2][TILE];
  const int row0 = blockIdx.x * QUERIES + threadIdx.x;
  float qx[QT], qy[QT], qz[QT], qq[QT], best[QT];
  int bi[QT];
#pragma unroll
  for (int k = 0; k < QT; ++k) {
    const int i = min(row0 + k * THREADS, Q - 1);   // rows past Q repeat the last, unwritten
    qx[k] = queries[3 * (size_t)i];
    qy[k] = queries[3 * (size_t)i + 1];
    qz[k] = queries[3 * (size_t)i + 2];
    qq[k] = qnorm[i];
    best[k] = INFINITY;
    bi[k] = 0;
  }
  stage(tile[0], refs);
  cp_async_commit();
  if (n_tiles > 1) stage(tile[1], refs + TILE);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_one();
    __syncthreads();
    const float4* s = tile[t & 1];
    for (int c = 0; c < TILE; c += CHUNK) {
      float m[QT];
#pragma unroll
      for (int k = 0; k < QT; ++k) m[k] = INFINITY;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float4 r = s[c + j];
#pragma unroll
        for (int k = 0; k < QT; ++k) m[k] = min_nan(m[k], dist2(qx[k], qy[k], qz[k], qq[k], r));
      }
      bool hit = false;
#pragma unroll
      for (int k = 0; k < QT; ++k) {
        m[k] = max_nan(m[k], 0.f);               // the clamp, after the minimum: the same value
        hit |= beats(m[k], best[k]);
      }
      if (hit) {
#pragma unroll
        for (int k = 0; k < QT; ++k) {
          if (!beats(m[k], best[k])) continue;
          int j = 0;                             // the chunk's first ref at the minimum
          if (m[k] == m[k])
            while (j < CHUNK - 1 &&
                   max_nan(dist2(qx[k], qy[k], qz[k], qq[k], s[c + j]), 0.f) != m[k])
              ++j;
          best[k] = m[k];
          bi[k] = t * TILE + c + j;
        }
      }
    }
    __syncthreads();
    if (t + 2 < n_tiles) stage(tile[t & 1], refs + (size_t)(t + 2) * TILE);
    cp_async_commit();
  }
#pragma unroll
  for (int k = 0; k < QT; ++k) {
    const int i = row0 + k * THREADS;
    if (i >= Q) continue;
    out_d[i] = best[k];
    out_i[i] = isfinite(best[k]) ? (ids ? ids[bi[k]] : (long long)bi[k]) : 0;
  }
}

}  // namespace

extern "C" int knn1_tile() { return TILE; }

// queries (Q,3) and their ‖q‖² (Q,), refs (n_tiles·TILE) float4 as above,
// ids (R,) int64 or null (the refs' own indices) → out_d (Q,) float32 and
// out_i (Q,) int64; contiguous, on the device, refs 16-byte aligned.
// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int knn1_launch(const float* queries, const float* qnorm, const void* refs, int Q,
                           int n_tiles, const long long* ids, float* out_d, long long* out_i,
                           void* stream) {
  if (Q <= 0 || n_tiles <= 0) return (int)cudaErrorInvalidValue;
  const int ctas = (Q + QUERIES - 1) / QUERIES;
  knn1_kernel<<<ctas, THREADS, 0, (cudaStream_t)stream>>>(queries, qnorm, (const float4*)refs,
                                                          Q, n_tiles, ids, out_d, out_i);
  return (int)cudaGetLastError();
}

// CTAs of the kernel that fit on one SM, by the runtime's occupancy
// calculator (registers, threads, shared memory); a CUDA error negated.
extern "C" int knn1_ctas_per_sm() {
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, knn1_kernel, THREADS, 0);
  return err == cudaSuccess ? n : -(int)err;
}
