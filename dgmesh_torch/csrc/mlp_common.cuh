// Shared pieces of the fused MLP trunk kernels: the trunk's shape and the
// order in which a pass reads the packed matrices (mlp_fwd.cu, mlp_bwd.cu,
// mlp_wgmma.cuh), the cp.async copies, and the mma.sync pieces of the
// forward kernel (mlp_fwd.cu) and of the backward's weight-gradient pass:
// padded shared-memory tiles, the two-stage weight pipeline, the bf16
// tensor-core product (mma.sync m16n8k16, float32 accumulators) and the
// forward pass over one block of rows.  The backward's row pass runs on
// wgmma instead (mlp_wgmma.cuh).
//
// Tiles.  A CTA of 8 warps owns BM = 128 rows.  Its input x (rounded to
// bf16, zero-padded to 256 lanes) and its current activation live in shared
// memory as [128][256] bf16 tiles (X, H), rows padded by 16 bytes so that
// ldmatrix reads 8 rows without bank conflicts.  The warps split the
// (128 x 256) output of a layer as 2 along rows x 4 along columns; each
// holds its 64 x 64 block in registers (acc[4][8][4]).
//
// Weights stream from device memory (they stay in L2: 1.18 MB bf16) through
// a two-stage cp.async pipeline of KC = 64 reduction steps each: rows
// k0..k0+63 of a (in,out) matrix ([k][n], read with ldmatrix.trans).  The
// chunks of a pass follow one fixed sequence, so the next one is always in
// flight while the current one is multiplied.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mlp {

constexpr int W = 256;                  // trunk width
constexpr int DEPTH = 8;                // layers
constexpr int SKIP = DEPTH / 2;         // the input is concatenated into layer SKIP + 1
constexpr int BM = 128;                 // rows per CTA
constexpr int THREADS = 256;            // 8 warps: 2 along rows x 4 along columns
constexpr int KC = 64;                  // reduction steps per pipeline stage
constexpr int LDA = W + 8;              // bf16 pitch of X, H and a weight stage
constexpr int STAGE = KC * LDA;         // bf16 elements of a weight stage
constexpr int CHUNKS = (W / KC) * (DEPTH + 1);   // stages of one pass over the trunk
static_assert(DEPTH == 8 && SKIP == 4, "the chunk sequences below are written for 8 layers");
static_assert(THREADS == W, "one thread per column in the bias-gradient sums");

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                          const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col): exact products,
// float32 sums.
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Matrix of wpack read by chunk group q (4 chunks each) of the forward pass:
// layers 0..5 (layer 5's h-part), then layer 5's x-part (index DEPTH), then 6, 7.
__device__ __forceinline__ int fwd_mat(int q) {
  return q <= SKIP + 1 ? q : (q == SKIP + 2 ? DEPTH : q - 1);
}
// Start the cp.async copies of forward chunk c (rows k0.. of its matrix
// as [k][n]).
__device__ __forceinline__ void load_chunk(bf16* stage, const bf16* w, int c) {
  const bf16* src = w + ((size_t)fwd_mat(c >> 2) * W + (c & 3) * KC) * W;
  for (int i = threadIdx.x; i < KC * (W / 8); i += THREADS) {
    const int r = i / (W / 8), p = i % (W / 8);
    cp_async16(stage + r * LDA + p * 8, src + (size_t)r * W + p * 8);
  }
}

// Wait for chunk c (prefetching chunk c + 1 when c + 1 < total) and make
// it visible to every thread.  Returns its stage.
__device__ __forceinline__ const bf16* next_chunk(bf16* stages, const bf16* w, int c, int total) {
  if (c + 1 < total) load_chunk(stages + ((c + 1) & 1) * STAGE, w, c + 1);
  cp_async_commit();
  cp_async_wait1();
  __syncthreads();
  return stages + (c & 1) * STAGE;
}

// acc (the warp's 64x64 block) += A[:, ka:ka+KC] · stage, with the stage
// [k][n] (forward: rows of W).
__device__ __forceinline__ void mma_stage_kn(float (&acc)[4][8][4], const bf16* A, int ka,
                                             const bf16* B) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp >> 2) * 64, n0 = (warp & 3) * 64;
  const int q = lane >> 3, r = lane & 7;
#pragma unroll
  for (int ks = 0; ks < KC; ks += 16) {
    uint32_t a[4][4], b[8][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      ldsm_x4(a[mt][0], a[mt][1], a[mt][2], a[mt][3],
              A + (m0 + mt * 16 + (q & 1) * 8 + r) * LDA + ka + ks + (q >> 1) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np)
      ldsm_x4_t(b[2 * np][0], b[2 * np][1], b[2 * np + 1][0], b[2 * np + 1][1],
                B + (ks + (q & 1) * 8 + r) * LDA + n0 + np * 16 + (q >> 1) * 8);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mma(acc[mt][nt], a[mt], b[nt]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][8][4]) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// The tile row and column of element pair (mt, nt, half) of this thread's
// accumulators: columns col and col + 1 of that row.
__device__ __forceinline__ int frag_row(int mt, int half) {
  return ((threadIdx.x >> 5) >> 2) * 64 + mt * 16 + ((threadIdx.x & 31) >> 2) + half * 8;
}
__device__ __forceinline__ int frag_col(int nt) {
  return ((threadIdx.x >> 5) & 3) * 64 + nt * 8 + (threadIdx.x & 3) * 2;
}

// Stage x rows row0..row0+BM-1 (float32 (n,din)) into X as bf16 (round to
// nearest even), zero past din and past n.
__device__ __forceinline__ void stage_x(bf16* X, const float* __restrict__ x, int n, int din,
                                        int row0) {
  for (int i = threadIdx.x; i < BM * W; i += THREADS) {
    const int r = i / W, col = i % W, row = row0 + r;
    const float v = (row < n && col < din) ? x[(size_t)row * din + col] : 0.f;
    X[r * LDA + col] = __float2bfloat16_rn(v);
  }
}

// The forward pass over the CTA's rows: for each layer, acc = h·W (+ x·W_x
// at layer SKIP + 1) in float32, then epi(layer, acc) rounds
// relu(acc + b) to bf16 and stores it; post(layer) runs once every thread's
// epilogue is done.
template <typename Epilogue, typename Post>
__device__ __forceinline__ void forward_pass(float (&acc)[4][8][4], const bf16* X, const bf16* H,
                                             bf16* stages, const bf16* w, int total,
                                             Epilogue epi, Post post) {
  load_chunk(stages, w, 0);
  cp_async_commit();
  zero(acc);
  for (int c = 0; c < CHUNKS; ++c) {
    const bf16* st = next_chunk(stages, w, c, total);
    const int q = c >> 2, mat = fwd_mat(q);
    mma_stage_kn(acc, (q == 0 || mat == DEPTH) ? X : H, (c & 3) * KC, st);
    __syncthreads();          // the stage and H are free again
    if ((c & 3) == 3 && mat != SKIP + 1) {
      const int layer = mat == DEPTH ? SKIP + 1 : mat;
      epi(layer, acc);
      __syncthreads();        // the new activation is in H
      post(layer);
      zero(acc);
    }
  }
}

}  // namespace mlp
