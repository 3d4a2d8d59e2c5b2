// Fused MLP trunk, backward — CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel dgmesh_tpu/ops/mlp_pallas.py::_bwd_kernel
// (reached through fused_trunk's custom_vjp, _trunk_bwd).
//
// What it computes, for the forward of mlp_fwd.cu and a float32 cotangent
// g (n,256) of its output: the forward is recomputed keeping every layer's
// bf16 activation a_i, then for i = 7..0
//   gm  = g where a_i > 0, else 0          (float32)
//   gmb = bf16(gm)
//   dW[i] = h_inᵀ·gmb  (h_in = x for i = 0, else a_{i-1}),  db[i] = Σ_rows gm
//   at i = 5 also dW[8] = xᵀ·gmb and dx += gmb·W[8]ᵀ
//   g   = gmb·W[i]ᵀ                         (float32)
// and dx += g.  Outputs dx (n,din), dW (9,256,256) and db (8,256), float32,
// dW and db summed over all rows.  Products of bf16 operands are exact and
// summed in float32, as in the TPU kernel; db sums the unrounded gm.
//
// What bounds it on the H100: operations, three times the forward's: the
// recompute, the products with Wᵀ and the weight gradients.  At the main
// path's 479,966 rows and din 93, 1.46 TFLOP: 1.47 ms at the 989 TFLOP/s
// bf16 tensor-core peak.
//
// Design.  The TPU kernel keeps all 8 activations of a 2048-row block and
// the whole dW (2.36 MB float32) resident in VMEM, accumulating dW over a
// sequential grid.  Neither fits a Hopper CTA's 227 KB, and CTAs do not run
// in order.  So the backward is three passes, each deterministic:
//  1. mlp_bwd_rows: one CTA per 128 rows recomputes the forward and walks
//     back, every product on wgmma from shared memory (mlp_wgmma.cuh): two
//     warpgroups of 64 rows x 256 columns, the activation tiles and a
//     three-stage weight ring in 128-byte-swizzled K-major layout, so the
//     tensor cores read both operands without register staging.  It writes
//     its bf16 x, the activations a_0..a_6 and the 8 masked gradients gmb
//     to a workspace of 16 (rows, 256) bf16 buffers (8 KB a row; buffer 0
//     x, 1 + i a_i, 8 + i gmb_i), its dx, and its per-column sums of gm
//     (fixed order: the thread's two rows, a reduce-scatter shuffle tree
//     over the warp's 8 row groups, then the 8 warps in order).  Each tile
//     leaves shared memory as whole 512-byte rows, in parts, while the
//     next chunks multiply.  The mask of layer i is read from shared
//     memory: a_7 is still in H, and a_{i-1} is copied back into the free X
//     tile while layer i's product with Wᵀ runs.  The skip's dx part,
//     gmb_5·W[8]ᵀ, is multiplied last, from gmb_5 copied back into X, into
//     the accumulators that hold layer 0's g, so dx is written once.
//     Floors at 479,966 rows: 18 products of 128x256x256 a CTA, ~1.2 ms of
//     tensor-core time; 3.9 GB of workspace written, ~1.2 ms at 3.35 TB/s;
//     2.3 MB of weight stages a CTA read from L2.  What holds it above them:
//     the epilogues, masks and bias sums run on the CUDA cores while the
//     tensor cores wait, as both warpgroups move in step through one ring
//     and one CTA fills an SM; each chunk's products are waited for before
//     the ring moves on (three stages leave no room for a second batch in
//     flight while the loads stay two chunks ahead).
//  2. mlp_bwd_wgrad: the weight gradients as 9 products Aᵀ·G over the rows
//     (A the workspace's x or a_{e-1}, G its gmb_e), every product on wgmma
//     m64n256k16.  The reduction runs over workspace rows and a row holds
//     consecutive features, so both operands are MN-major: a stage of 64
//     rows lands by cp.async in 128-byte-swizzled [64][64] blocks (rows
//     along K) and wgmma reads them by descriptor with its transpose flags
//     (mlp_wgmma.cuh's desc_mn), no operand through registers.  A CTA
//     computes a 128 x 256 dW tile (two warpgroups of 64 x 256, 128 float32
//     accumulators a thread), so G's rows are read for two halves of A at
//     once, over one of S row splits; a ring of four 48 KB stages, two
//     loading while one multiplies and the one before it finishes, one CTA
//     an SM (three loading ahead with each stage's products waited for was
//     slower; so were TMA loads).  x's lanes past din are zero, so a 128-row
//     tile of dW[0] or dW[8] wholly past din is not computed, and the
//     reduction writes zeros from row 64·ceil(din/64) on.  Those rows are
//     what JAX's kernel and the twin compute as 0·gmb: the same for a
//     finite cotangent, but 0 here where theirs is NaN for a non-finite
//     one; no caller reads them (the trunk's pad backward drops dW rows
//     past din).  S = SMs / jobs row splits (the wrapper's choice,
//     mlp_fused.wgrad_splits: 16 jobs at din <= 128, S = 8, 128 CTAs on
//     132 SMs, one wave), each a whole number of stages, the jobs of a
//     split neighbours in launch order so that L2 serves the second read
//     of G.  Bound at 479,966 rows, din 93: bytes, the 3.81 GB the
//     products need (x's 93 lanes and the other 15 buffers read once, the
//     row blocks' db sums read, dW written; 1.14 ms at 3.35 TB/s) against
//     0.49 TFLOP (0.49 ms at 989 TFLOP/s); the partials add 2 x 17 MB.
//  3. mlp_bwd_reduce_dw / _db: the partials summed in a fixed order.
// No atomics: the result is the same from run to run.  The workspace
// (8 KB a row: 3.9 GB at 479,966 rows) is the price of not holding dW in
// one CTA; rows past n have g = 0, so their gmb rows are zero and add
// nothing to dW or db.

#include "mlp_common.cuh"
#include "mlp_wgmma.cuh"

namespace {

using namespace mlp;

constexpr size_t ROWS_SMEM = wg::TILES_BYTES + 1024;   // + room to align the tiles to 1 KB

// One level of rows_sum8: lanes with bit S keep the upper half of v[0..2M),
// the others the lower half, each adding its partner's copy of it.
template <int S>
__device__ __forceinline__ void rows_sum_level(float (&v)[8], int lane) {
  constexpr int M = S / 4;
  const bool up = lane & S;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const float give = up ? v[k] : v[k + M];
    v[k] = (up ? v[k + M] : v[k]) + __shfl_xor_sync(0xffffffffu, give, S);
  }
}

// v[k], k < 8, summed over the 8 lanes of the warp that share lane & 3 (the
// accumulators' 8 row groups), as a reduce-scatter tree (xor 16, 8, 4):
// returns the sum of element lane >> 2.
__device__ __forceinline__ float rows_sum8(float (&v)[8], int lane) {
  rows_sum_level<16>(v, lane);
  rows_sum_level<8>(v, lane);
  rows_sum_level<4>(v, lane);
  return v[0];
}

__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_rows(const float* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ wt,
             const float* __restrict__ b, const float* __restrict__ gin,
             float* __restrict__ dx, bf16* __restrict__ ws, float* __restrict__ db_part,
             int n, int din) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* X = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  bf16* H = X + wg::TILE;
  bf16* stages = H + wg::TILE;
  const int row0 = blockIdx.x * BM;
  const size_t buf = (size_t)gridDim.x * BM * W;                // one workspace buffer
  bf16* wsr = ws + (size_t)row0 * W;                            // this CTA's rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int TOTAL = 2 * CHUNKS;

  // 1. the forward, keeping x and the activations a_0..a_6 in the workspace
  //    (a_7 stays in H for the first mask of the walk)
  wg::stage_x(X, x, n, din, row0);
  float acc[32][4];
  wg::forward_pass(acc, X, H, stages, w, wt, TOTAL, [&](int layer, float (&a)[32][4]) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = wg::acc_col(j);
      const float b0 = b[layer * W + col], b1 = b[layer * W + col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<bf162*>(H + wg::tile_at(wg::acc_row(half), col)) =
            __floats2bfloat162_rn(relu(a[j][2 * half] + b0),
                                  relu(a[j][2 * half + 1] + b1));
    }
  }, [&](int layer, int part) {
    wg::store_tile(wsr + (1 + layer) * buf, layer < 0 ? X : H, part);
  });

  // 2. the walk back; g lives in acc, in the accumulators' layout, all of
  //    its loads in flight at once.  The mask of layer i comes from shared
  //    memory: a_7 from H, a_{i-1} copied into the free X tile while layer
  //    i's product with Wᵀ runs.  c is the next chunk; chunk c - 1's stage
  //    is idle from the barrier after the mask until pipe_next(c), and holds
  //    the 8 warps' column sums meanwhile.
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wg::acc_row(half);
      const float2 gv = row < n
          ? *reinterpret_cast<const float2*>(gin + (size_t)row * W + wg::acc_col(j))
          : make_float2(0.f, 0.f);
      acc[j][2 * half] = gv.x;
      acc[j][2 * half + 1] = gv.y;
    }
  int c = CHUNKS;
  for (int i = DEPTH - 1; i >= 0; --i) {
    const bf16* act = i == DEPTH - 1 ? H : X;
    float colsum[8];          // the warp's sums, one column per group of 4 j
#pragma unroll
    for (int grp = 0; grp < 8; ++grp) {
      float v[8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = grp * 4 + jj, col = wg::acc_col(j);
        v[2 * jj] = v[2 * jj + 1] = 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int at = wg::tile_at(wg::acc_row(half), col);
          const bf162 a2 = *reinterpret_cast<const bf162*>(act + at);
          const float m0 = __low2float(a2) > 0.f ? acc[j][2 * half] : 0.f;
          const float m1 = __high2float(a2) > 0.f ? acc[j][2 * half + 1] : 0.f;
          v[2 * jj] += m0;
          v[2 * jj + 1] += m1;
          *reinterpret_cast<bf162*>(H + at) = __floats2bfloat162_rn(m0, m1);
        }
      }
      colsum[grp] = rows_sum8(v, lane);
    }
    __syncthreads();          // gmb_i is in H; every warpgroup is past chunk c - 1
    float* dbs = reinterpret_cast<float*>(stages + ((c - 1) % wg::NSTAGE) * wg::STAGE);
    // element lane >> 2 of group grp is column 8·(4·grp + (lane >> 3)) + 2·(lane & 3) + ((lane >> 2) & 1)
#pragma unroll
    for (int grp = 0; grp < 8; ++grp)
      dbs[warp * W + wg::acc_col(grp * 4 + (lane >> 3)) + ((lane >> 2) & 1)] = colsum[grp];
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) s += dbs[k * W + threadIdx.x];
    db_part[((size_t)blockIdx.x * DEPTH + i) * W + threadIdx.x] = s;

    for (int k = 0; k < W / KC; ++k, ++c)       // g = gmb_i · W[i]ᵀ
      wg::mma_chunk(acc, H + k * wg::SUB, wg::pipe_next(stages, w, wt, c, TOTAL), k == 0, [&] {
        // while the chunks multiply: gmb_i out to the workspace in parts,
        // and in the first, the next mask's a_{i-1} (after layer 0, the
        // skip's gmb_5) into X, in the pipeline group of chunk c + 3
        if (k < wg::STORE_PARTS) wg::store_tile(wsr + (DEPTH + i) * buf, H, k);
        if (k == 0) wg::load_tile_async(X, wsr + (i > 0 ? i : DEPTH + SKIP + 1) * buf);
      });
  }
  // dx's skip part, gmb_5 · W[8]ᵀ, added to g in the accumulators
  for (int k = 0; k < W / KC; ++k, ++c)
    wg::mma_chunk(acc, X + k * wg::SUB, wg::pipe_next(stages, w, wt, c, TOTAL), false, [] {});

  // 3. dx, each element by the thread that holds it
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wg::acc_row(half), col = wg::acc_col(j);
      if (row >= n) continue;
      if (col < din) dx[(size_t)row * din + col] = acc[j][2 * half];
      if (col + 1 < din) dx[(size_t)row * din + col + 1] = acc[j][2 * half + 1];
    }
}

constexpr int WG_TILE = 128;            // dW rows a CTA: two warpgroups of 64
constexpr int WG_R = 64;                // workspace rows a stage
// A ring of four stages: while stage c multiplies, stages c + 1 and c + 2
// load and the products of stage c - 1 may still run, so stage c - 2's
// slot takes stage c + 2 (one wgmma batch left pending, cp.async groups
// waited for down to one).
constexpr int WG_RING = 4;              // stages in shared memory
constexpr int WG_LEAD = 2;              // stages loading ahead of the one multiplied
constexpr int WG_BLK = WG_R * KC;       // bf16 of one [R][64] MN-major block
constexpr int WG_STAGE = 6 * WG_BLK;    // A: 2 blocks (128 features), G: 4 (256)
constexpr size_t WGRAD_SMEM = (size_t)WG_RING * WG_STAGE * sizeof(bf16) + 1024;
static_assert(WGRAD_SMEM <= 232448, "shared memory");

// The pass's jobs at input width din: the 128-row tiles of the 9 dW
// matrices in order, two each, but one of dW[0] and dW[8] (A is x, zero
// past din) at din <= 128.
__host__ __device__ constexpr int wgrad_x_tiles(int din) { return din > WG_TILE ? 2 : 1; }
__host__ __device__ constexpr int wgrad_jobs(int din) {
  return 2 * (DEPTH - 1) + 2 * wgrad_x_tiles(din);
}

// Weight gradients: partial[s][e] rows 128·tile .. = A_eᵀ·G_e over split
// s's rows, each warpgroup 64 dW rows x 256 columns on wgmma m64n256k16
// with both operands MN-major (mlp_wgmma.cuh's desc_mn): a stage's A is
// its rows' 128 features of A_e as two [R][64] blocks, its G the rows'
// 256 features of G_e as four, copied by every thread with cp.async into
// the 128-byte-swizzled layout; WG_LEAD stages load while one multiplies,
// and its products run on while the next stage is waited for.  CTA b runs
// job b % jobs over split b / jobs, which owns stages s·stages/splits ..
// (s+1)·stages/splits - 1 (none, for a split past the rows).  A_e is
// buffer e (x, then a_0..a_6) for e < 8 and x for e = 8; G_e buffer 8 + e,
// gmb_5 for e = 8.
__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_wgrad(const bf16* __restrict__ ws, float* __restrict__ dw_part, int npad, int splits,
              int din) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  const int jobs = wgrad_jobs(din);
  const int job = blockIdx.x % jobs, s = blockIdx.x / jobs;
  // job j is tile q % 2 of matrix q / 2, q = j past dW[0]'s lone tile + 1
  const int q = job == 0 ? 0 : job + 2 - wgrad_x_tiles(din), e = q >> 1, tile = q & 1;
  const int stages = npad / WG_R;
  const int st0 = s * stages / splits, nst = (s + 1) * stages / splits - st0;
  const size_t buf = (size_t)npad * W, row0 = (size_t)st0 * WG_R;
  const bf16* A = ws + (size_t)(e < DEPTH ? e : 0) * buf + row0 * W + tile * WG_TILE;
  const bf16* G = ws + (size_t)(DEPTH + (e < DEPTH ? e : SKIP + 1)) * buf + row0 * W;

  // stage c of the split into its slot, as one cp.async group (empty past
  // the split's end, so that the group count stays the stage count)
  const auto load = [&](int c) {
    if (c < nst) {
      bf16* st = ring + (c % WG_RING) * WG_STAGE;
      const bf16* a = A + (size_t)c * WG_R * W;
      const bf16* g = G + (size_t)c * WG_R * W;
      for (int i = threadIdx.x; i < WG_R * (WG_TILE / 8); i += THREADS) {
        const int r = i >> 4, p = i & 15;
        cp_async16(st + (p >> 3) * WG_BLK + wg::swz(r, (p & 7) * 8), a + (size_t)r * W + p * 8);
      }
      for (int i = threadIdx.x; i < WG_R * (W / 8); i += THREADS) {
        const int r = i >> 5, p = i & 31;
        cp_async16(st + (2 + (p >> 3)) * WG_BLK + wg::swz(r, (p & 7) * 8),
                   g + (size_t)r * W + p * 8);
      }
    }
    cp_async_commit();
  };

  // the first stage's first product sets acc (no other instruction writes
  // it while products run: ptxas would serialise them, C7515); a split with
  // no stage writes zeros
  float acc[32][4];
  for (int c = 0; c < WG_LEAD; ++c) load(c);
  for (int c = 0; c < nst; ++c) {
    cp_async_wait1();                   // stage c has landed (this thread's part)
    wg::fence_proxy_async();
    __syncthreads();                    // ... every thread's; stage c + LEAD - RING is multiplied
    load(c + WG_LEAD);
    const bf16* st = ring + (c % WG_RING) * WG_STAGE;
    const uint64_t da = wg::desc_mn(st + (threadIdx.x >> 7) * WG_BLK, WG_BLK * sizeof(bf16));
    const uint64_t db = wg::desc_mn(st + 2 * WG_BLK, WG_BLK * sizeof(bf16));
    wg::fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < WG_R / 16; ++k)
      wg::wgmma_m64n256k16_mn(acc, da + k * wg::MN_K16, db + k * wg::MN_K16, c > 0 || k > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    wg::fence_acc(acc);
  }
  wg::mma_wait_all(acc);
  float* out = dw_part + ((size_t)s * (DEPTH + 1) + e) * W * W + (size_t)tile * WG_TILE * W;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(out + (size_t)wg::acc_row(half) * W + wg::acc_col(j)) =
          nst > 0 ? make_float2(acc[j][2 * half], acc[j][2 * half + 1]) : make_float2(0.f, 0.f);
}

// dW = Σ_s partial[s], s in order, four elements a thread; the rows of
// dW[0] and dW[8] from 64·kx on, kx = ceil(din/64), are written as zeros
// (x's lanes there are zero; see the header for a non-finite cotangent),
// their partials not read.
__global__ void mlp_bwd_reduce_dw(const float* __restrict__ dw_part, float* __restrict__ dw,
                                  int splits, int kx) {
  constexpr size_t total = (size_t)(DEPTH + 1) * W * W;
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= total) return;
  const int e = (int)(i / (W * W)), row = (int)(i / W) % W;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if ((e != 0 && e != DEPTH) || row < kx * KC)
    for (int s = 0; s < splits; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(dw_part + s * total + i);
      v.x += p.x, v.y += p.y, v.z += p.z, v.w += p.w;
    }
  *reinterpret_cast<float4*>(dw + i) = v;
}

// db = Σ_blocks db_part: one CTA per 32 columns of (DEPTH, W); warp k sums
// blocks k, k+8, ... in order, then the 8 warps' sums are added in order.
__global__ void mlp_bwd_reduce_db(const float* __restrict__ db_part, float* __restrict__ db,
                                  int blocks) {
  __shared__ float part[THREADS / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float v = 0.f;
  for (int k = warp; k < blocks; k += THREADS / 32) v += db_part[(size_t)k * DEPTH * W + col];
  part[warp][lane] = v;
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
    for (int k = 0; k < THREADS / 32; ++k) t += part[k][lane];
    db[col] = t;
  }
}

}  // namespace

// The backward in two calls, made in this order on one stream.  All
// tensors contiguous, on the device; each returns the first launch error.
//
// Pass 1: x (n,din) f32, wpack (9,256,256) bf16 and wpackt, its per-matrix
// transpose, bpack (8,256) f32, g (n,256) f32 → dx (n,din) f32, the
// workspace ws (16, ceil(n/128)·128, 256) bf16 and db_part (ceil(n/128),
// 8, 256) f32.
extern "C" int mlp_bwd_rows_launch(const float* x, const void* wpack, const void* wpackt,
                                   const float* bpack, const float* g, float* dx, void* ws,
                                   float* db_part, int n, int din, void* stream) {
  if (n <= 0) return 0;
  if (din <= 0 || din > W) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(mlp_bwd_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)ROWS_SMEM);
  if (e != cudaSuccess) return (int)e;
  mlp_bwd_rows<<<(n + BM - 1) / BM, THREADS, ROWS_SMEM, (cudaStream_t)stream>>>(
      x, static_cast<const bf16*>(wpack), static_cast<const bf16*>(wpackt), bpack, g, dx,
      static_cast<bf16*>(ws), db_part, n, din);
  return (int)cudaGetLastError();
}

// Passes 2 and 3: that workspace and db_part (blocks = ceil(n/128) row
// blocks) at input width din → dw (9,256,256) and db (8,256) f32, through
// the scratch dw_part (splits, 9, 256, 256) f32, of which only the rows the
// pass's jobs cover are written and read.
extern "C" int mlp_bwd_wgrad_launch(const void* ws, const float* db_part, float* dw_part,
                                    float* dw, float* db, int blocks, int splits, int din,
                                    void* stream) {
  if (blocks <= 0) return 0;
  if (splits <= 0 || din <= 0 || din > W) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaFuncSetAttribute(mlp_bwd_wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)WGRAD_SMEM);
  if (e != cudaSuccess) return (int)e;
  mlp_bwd_wgrad<<<splits * wgrad_jobs(din), THREADS, WGRAD_SMEM, st>>>(
      static_cast<const bf16*>(ws), dw_part, blocks * BM, splits, din);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int quads = (DEPTH + 1) * W * W / 4;
  mlp_bwd_reduce_dw<<<(quads + 255) / 256, 256, 0, st>>>(dw_part, dw, splits, (din + KC - 1) / KC);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  mlp_bwd_reduce_db<<<DEPTH * W / 32, THREADS, 0, st>>>(db_part, db, blocks);
  return (int)cudaGetLastError();
}
