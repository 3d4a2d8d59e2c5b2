// Hopper warpgroup (wgmma) pieces of the fused MLP trunk kernels, used by
// the forward (mlp_fwd.cu) and by the backward's two passes (mlp_bwd.cu):
// the 128-byte-swizzled K-major shared-memory tiles and their copies to and
// from device memory, the shared-memory matrix descriptors, wgmma
// m64n256k16 (bf16 operands, float32 accumulators), the fences between the
// generic and the async proxy, a three-stage cp.async weight pipeline, and
// the backward's forward pass over one block of rows (kernel 5 runs its own
// loop, on a ring shared by a cluster: mlp_fwd.cu); and the MN-major form
// of the descriptor and of the product for the backward's weight-gradient
// pass, whose operands are transposed (MN-major below).
//
// Tiles.  A CTA of 256 threads (two warpgroups) owns BM = 128 rows; each
// warpgroup owns 64 of them and all 256 output columns, its accumulator
// 128 float32 a thread (acc[32][4]: the m16n8 fragment tiled over N).  An
// activation tile [128][256] bf16 is four [128][64] blocks, one per 64
// columns; a weight stage is one [256 n][64 k] block.  In a block a row is
// 128 bytes and its 16-byte granule g sits at granule g ^ (row % 8) (the
// canonical K-major layout with 128-byte swizzle), every block 1024-byte
// aligned.  wgmma reads both operands from such blocks: A is 64 rows of the
// activation's block for this k range, B the stage, both K-major, so that
// no operand passes through registers.
//
// Weights.  The forward's product h·W reads W[k][n] as B[n][k]: a forward
// stage is rows n, columns k0..k0+63 of the transposed pack wt = Wᵀ.  The
// backward's product g·Wᵀ reads W[j][n] as B[j][n]: a backward stage is
// columns n0..n0+63 of the pack w itself.  So both are the same copy of a
// [256][64] slice of a (256,256) matrix, with one descriptor form.
//
// Overlap.  wgmma runs asynchronously: mma_chunk issues a chunk's four k16
// steps, then runs the caller's side work (workspace stores, copies) on the
// CUDA cores, then waits.
//
// Proxies.  wgmma reads shared memory through the async proxy.  Every write
// by ordinary stores or cp.async that a wgmma will read is followed, in the
// writing thread, by fence.proxy.async and then a barrier (pipe_next does
// both for every chunk); the accumulator registers are fenced around each
// wgmma batch so that the compiler neither reads them before the wait nor
// moves a write past the issue.

#pragma once

#include "mlp_common.cuh"

namespace mlp {
namespace wg {

constexpr int KB = W / KC;              // 64-column blocks of a row
constexpr int SUB = BM * KC;            // bf16 elements of one [128][64] block
constexpr int TILE = KB * SUB;          // a [128][256] activation tile: 4 blocks
constexpr int STAGE = W * KC;           // a weight stage [256][64]
constexpr int NSTAGE = 3;               // stages in the ring
constexpr size_t TILES_BYTES = (size_t)(2 * TILE + NSTAGE * STAGE) * sizeof(bf16);
static_assert(KC == 64, "a 128-byte swizzle row holds 64 bf16");

// Element (r, c) of a [*][64] block, c < 64.
__device__ __forceinline__ int swz(int r, int c) {
  return r * KC + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}
// Element (r, c) of a [128][256] tile.
__device__ __forceinline__ int tile_at(int r, int c) { return (c >> 6) * SUB + swz(r, c & 63); }

// The rows and columns of this thread's accumulators: acc[j][2·half + e]
// is at row acc_row(half), column acc_col(j) + e.
__device__ __forceinline__ int acc_row(int half) {
  return (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) +
         half * 8;
}
__device__ __forceinline__ int acc_col(int j) { return j * 8 + (threadIdx.x & 3) * 2; }

// Shared-memory matrix descriptor of a K-major block with 128-byte swizzle:
// start address >> 4, LBO 1 (unused for this layout), SBO 1024 bytes (8 rows),
// layout type 1 (B128).  +2 advances it by one k16 step (32 bytes).
__device__ __forceinline__ uint64_t desc(const bf16* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[32][4]) {
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

#define MLP_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d (64x256, this warpgroup) = A·B (+ d where accumulate): A a 64x16 K-major
// block, B 256x16 K-major, by descriptor.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[32][4], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : MLP_D4(0), MLP_D4(1), MLP_D4(2), MLP_D4(3), MLP_D4(4), MLP_D4(5), MLP_D4(6), MLP_D4(7),
        MLP_D4(8), MLP_D4(9), MLP_D4(10), MLP_D4(11), MLP_D4(12), MLP_D4(13), MLP_D4(14),
        MLP_D4(15), MLP_D4(16), MLP_D4(17), MLP_D4(18), MLP_D4(19), MLP_D4(20), MLP_D4(21),
        MLP_D4(22), MLP_D4(23), MLP_D4(24), MLP_D4(25), MLP_D4(26), MLP_D4(27), MLP_D4(28),
        MLP_D4(29), MLP_D4(30), MLP_D4(31)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef MLP_D4

// MN-major operands.  In the weight-gradient pass's Aᵀ·G the reduction
// runs over workspace rows, and a row holds consecutive features: A (M =
// input features) and B (N = output features) are both MN-major.  Such an
// operand lies in [R][64] blocks, R rows of 64 features (128 bytes), the
// granule g of row r at granule g ^ (r % 8): the same 128-byte swizzle
// (swz above) with rows along K.  Its 8-row x 64-feature atoms are 1024
// bytes; the descriptor's SBO is the step from 8 rows to the next 8 (1024
// bytes), its LBO the step from one 64-feature block to the next along MN
// (R·128 bytes).  A k16 step is 16 rows: +2048 bytes, +128 in the start
// address field.
__device__ __forceinline__ uint64_t desc_mn(const bf16* p, uint32_t lbo_bytes) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (64ull << 32) | (1ull << 62);
}
constexpr int MN_K16 = 128;             // desc_mn's advance for 16 rows

#define MLP_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d (64x256, this warpgroup) = A·B (+ d where accumulate): A a 64-feature x
// 16-row MN-major block, B 256 features x 16 rows MN-major, by desc_mn
// descriptors (the transpose flags imm-trans-a and imm-trans-b set).
__device__ __forceinline__ void wgmma_m64n256k16_mn(float (&d)[32][4], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      : MLP_D4(0), MLP_D4(1), MLP_D4(2), MLP_D4(3), MLP_D4(4), MLP_D4(5), MLP_D4(6), MLP_D4(7),
        MLP_D4(8), MLP_D4(9), MLP_D4(10), MLP_D4(11), MLP_D4(12), MLP_D4(13), MLP_D4(14),
        MLP_D4(15), MLP_D4(16), MLP_D4(17), MLP_D4(18), MLP_D4(19), MLP_D4(20), MLP_D4(21),
        MLP_D4(22), MLP_D4(23), MLP_D4(24), MLP_D4(25), MLP_D4(26), MLP_D4(27), MLP_D4(28),
        MLP_D4(29), MLP_D4(30), MLP_D4(31)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef MLP_D4

// acc (this warpgroup's 64 rows x 256) = A[:, k0:k0+64]·B, or += where not
// first: A the [128][64] block of the activation tile for this k range, B a
// weight stage.  Issued as one batch of four k16 steps; side() runs while
// the tensor cores work, then the batch is waited for, or with PENDING = 1
// the batch before it (this one may still run: acc is not to be read until
// a later wait for none).  side() must not touch acc or write what the
// batch reads.
template <int PENDING = 0, typename Side>
__device__ __forceinline__ void mma_chunk(float (&acc)[32][4], const bf16* A, const bf16* B,
                                          bool first, Side side) {
  const uint64_t da = desc(A + (threadIdx.x >> 7) * 64 * KC), db = desc(B);
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < KC / 16; ++k)
    wgmma_m64n256k16(acc, da + 2 * k, db + 2 * k, (first && k == 0) ? 0 : 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  side();
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING) : "memory");
  fence_acc(acc);
}

// Wait for every wgmma batch of this warpgroup still running.
__device__ __forceinline__ void mma_wait_all(float (&acc)[32][4]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
}

// Matrix of wpack read by chunk group q (4 chunks each) of the backward
// walk: 7..0 (layer 5's h-part), then the skip's x-part (for dx).
__device__ __forceinline__ int bwd_mat(int q) { return q < DEPTH ? DEPTH - 1 - q : DEPTH; }

// Start the cp.async copies of chunk c into stage st: c < CHUNKS is forward
// chunk c (columns k0.. of the transposed matrix), c >= CHUNKS backward
// chunk c - CHUNKS (columns n0.. of the matrix itself).
__device__ __forceinline__ void load_stage(bf16* st, const bf16* w, const bf16* wt, int c) {
  const bf16* src = (c < CHUNKS ? wt + (size_t)fwd_mat(c >> 2) * W * W
                                : w + (size_t)bwd_mat((c - CHUNKS) >> 2) * W * W) + (c & 3) * KC;
  for (int i = threadIdx.x; i < W * (KC / 8); i += THREADS) {
    const int r = i >> 3, p = i & 7;
    cp_async16(st + r * KC + (((p ^ r) & 7) << 3), src + (size_t)r * W + p * 8);
  }
}

// The ring: chunk c lives in stage c % NSTAGE and is its own cp.async group,
// issued two chunks ahead.  pipe_start issues chunks 0 and 1.
__device__ __forceinline__ void pipe_start(bf16* stages, const bf16* w, const bf16* wt) {
  load_stage(stages, w, wt, 0);
  cp_async_commit();
  load_stage(stages + STAGE, w, wt, 1);
  cp_async_commit();
}

// Wait for chunk c and make it (and every shared-memory write before this
// call) visible to wgmma in every thread; then, every warpgroup being past
// chunk c - 1, refill its stage with chunk c + 2.  Returns chunk c's stage.
__device__ __forceinline__ const bf16* pipe_next(bf16* stages, const bf16* w, const bf16* wt,
                                                 int c, int total) {
  cp_async_wait1();
  fence_proxy_async();
  __syncthreads();
  if (c + 2 < total) load_stage(stages + ((c + 2) % NSTAGE) * STAGE, w, wt, c + 2);
  cp_async_commit();
  return stages + (c % NSTAGE) * STAGE;
}

// Stage x rows row0..row0+BM-1 (float32 (n,din)) into the first kx blocks
// of the tile X as bf16 (round to nearest even), zero past din and past n:
// one 8-column granule a step, its eight loads independent, one 16-byte
// store.
__device__ __forceinline__ void stage_x(bf16* X, const float* __restrict__ x, int n, int din,
                                        int row0, int kx = KB) {
  const unsigned granules = kx * (KC / 8);   // a row's
  for (unsigned i = threadIdx.x; i < BM * granules; i += THREADS) {
    const int r = i / granules, p = i % granules, row = row0 + r;
    uint32_t u[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = p * 8 + 2 * e;
      const bf162 h = __floats2bfloat162_rn(
          row < n && col < din ? x[(size_t)row * din + col] : 0.f,
          row < n && col + 1 < din ? x[(size_t)row * din + col + 1] : 0.f);
      u[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(X + (p >> 3) * SUB + swz(r, (p & 7) * 8)) =
        make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// Rows STORE_ROWS·part.. of a tile (part < STORE_PARTS) to [BM][W] bf16
// rows of device memory, 16 bytes a thread: each warp writes one whole
// 512-byte row at a time.  A tile goes out in parts, one per chunk, so that
// the stores drain while the tensor cores work.
constexpr int STORE_PARTS = 3;
constexpr int STORE_ROWS = 48;          // a multiple of 8: whole loop trips for every thread
static_assert(STORE_ROWS * (STORE_PARTS - 1) < BM && STORE_ROWS * STORE_PARTS >= BM, "parts");
__device__ __forceinline__ void store_tile(bf16* dst, const bf16* src, int part) {
  const int end = min(BM, (part + 1) * STORE_ROWS) * (W / 8);
  for (int i = part * STORE_ROWS * (W / 8) + threadIdx.x; i < end; i += THREADS) {
    const int r = i >> 5, p = i & 31;
    *reinterpret_cast<uint4*>(dst + (size_t)r * W + p * 8) =
        *reinterpret_cast<const uint4*>(src + (p >> 3) * SUB + swz(r, (p & 7) * 8));
  }
}

// ... and back, as cp.async copies that join the next committed group.
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src) {
  for (int i = threadIdx.x; i < BM * (W / 8); i += THREADS) {
    const int r = i >> 5, p = i & 31;
    cp_async16(dst + (p >> 3) * SUB + swz(r, (p & 7) * 8), src + (size_t)r * W + p * 8);
  }
}

// The forward pass over the CTA's rows (x already written to X, not yet
// fenced): for each layer, acc = h·W (+ x·W_x at layer SKIP + 1) in
// float32, then epi(layer, acc) rounds relu(acc + b) to bf16 and stores
// this thread's elements (into H: each warpgroup reads and writes only its
// own rows of it, so the epilogue needs no barrier before it).
// post(layer, part) runs while chunk part (< STORE_PARTS) of the next
// chunk group multiplies, when every thread's epilogue is in H and before
// the next epilogue rewrites it; post(-1, part) likewise in the first
// group, for x in X.  The last layer gets no post.  On return chunks
// CHUNKS and CHUNKS + 1 are in flight when total > CHUNKS + 1.
template <typename Epilogue, typename Post>
__device__ __forceinline__ void forward_pass(float (&acc)[32][4], const bf16* X, const bf16* H,
                                             bf16* stages, const bf16* w, const bf16* wt,
                                             int total, Epilogue epi, Post post) {
  static_assert(STORE_PARTS < W / KC, "the last chunk of a group is followed by its epilogue");
  pipe_start(stages, w, wt);
  int done = -1;              // the layer whose post is due, or -2
  for (int c = 0; c < CHUNKS; ++c) {
    const bf16* st = pipe_next(stages, w, wt, c, total);
    const int q = c >> 2, mat = fwd_mat(q);
    mma_chunk(acc, ((q == 0 || mat == DEPTH) ? X : H) + (c & 3) * SUB, st,
              (c & 3) == 0 && mat != DEPTH, [&] {
                if (done > -2 && (c & 3) < STORE_PARTS) post(done, c & 3);
              });
    if ((c & 3) == STORE_PARTS - 1) done = -2;
    if ((c & 3) == 3 && mat != SKIP + 1) {
      done = mat == DEPTH ? SKIP + 1 : mat;
      epi(done, acc);
    }
  }
}

}  // namespace wg
}  // namespace mlp
