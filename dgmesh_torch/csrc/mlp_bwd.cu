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
//  1. mlp_bwd_rows: one CTA per 128 rows (the forward's tiles and weight
//     pipeline, mlp_common.cuh) recomputes the forward and walks back.  It
//     writes its bf16 x, the activations a_0..a_6 and the 8 masked
//     gradients gmb to a workspace of 16 (rows, 256) bf16 buffers (8 KB a
//     row; buffer 0 x, 1 + i a_i, 8 + i gmb_i), its dx, and its per-column
//     sums of gm (fixed order: the thread's rows, a shuffle tree over the
//     warp, the two row-warps in order).  Every tile goes out from shared
//     memory as whole 512-byte rows (store_tile) after the epilogue that
//     made it.  The mask of layer i is read from shared memory: a_7 is
//     still in H, and a_{i-1} is copied back into the free X tile while
//     layer i's product with Wᵀ runs.
//  2. mlp_bwd_wgrad: the weight gradients as 9 products Aᵀ·G over the rows,
//     split into S = 32 row ranges; each CTA computes a 128x128 block of
//     one range with mma.sync and writes it as a float32 partial.
//  3. mlp_bwd_reduce_dw / _db: the partials summed in a fixed order.
// No atomics: the result is the same from run to run.  The workspace
// (8 KB a row: 3.9 GB at 479,966 rows) is the price of not holding dW in
// one CTA; rows past n have g = 0, so their gmb rows are zero and add
// nothing to dW or db.

#include "mlp_common.cuh"

namespace {

using namespace mlp;

constexpr size_t ROWS_SMEM = (size_t)(2 * BM * LDA + 2 * STAGE) * sizeof(bf16)
                             + 2 * W * sizeof(float);

__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_rows(const float* __restrict__ x, const bf16* __restrict__ w,
             const float* __restrict__ b, const float* __restrict__ gin,
             float* __restrict__ dx, bf16* __restrict__ ws, float* __restrict__ db_part,
             int n, int din) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);
  bf16* H = X + BM * LDA;
  bf16* stages = H + BM * LDA;
  float* dbs = reinterpret_cast<float*>(stages + 2 * STAGE);   // [2][W]
  const int row0 = blockIdx.x * BM;
  const size_t buf = (size_t)gridDim.x * BM * W;                // one workspace buffer
  bf16* wsr = ws + (size_t)row0 * W;                            // this CTA's rows
  const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) >> 2;
  constexpr int TOTAL = 2 * CHUNKS;

  // 1. the forward, keeping x and the activations a_0..a_6 in the workspace
  //    (a_7 stays in H for the first mask of the walk)
  stage_x(X, x, n, din, row0);
  __syncthreads();
  store_tile(wsr, X);
  float acc[4][8][4];
  forward_pass(acc, X, H, stages, w, TOTAL, [&](int layer, float (&a)[4][8][4]) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = frag_row(mt, half), col = frag_col(nt);
          *reinterpret_cast<bf162*>(H + row * LDA + col) = __floats2bfloat162_rn(
              fmaxf(a[mt][nt][2 * half] + b[layer * W + col], 0.f),
              fmaxf(a[mt][nt][2 * half + 1] + b[layer * W + col + 1], 0.f));
        }
  }, [&](int layer) {
    if (layer < DEPTH - 1) store_tile(wsr + (1 + layer) * buf, H);
  });

  // 2. the walk back; g lives in acc, in the accumulators' layout.  The mask
  //    of layer i comes from shared memory: a_7 from H, a_{i-1} copied into
  //    the free X tile while layer i's product with Wᵀ runs
  int c = CHUNKS;
  for (int i = DEPTH - 1; i >= 0; --i) {
    const bf16* act = i == DEPTH - 1 ? H : X;
    // one column pair at a time, so that only two column sums are live
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = frag_col(nt);
      bf162 a2[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = frag_row(mt, half);
          a2[mt][half] = *reinterpret_cast<const bf162*>(act + row * LDA + col);
          if (i == DEPTH - 1) {
            const float2 v = row0 + row < n
                ? *reinterpret_cast<const float2*>(gin + (size_t)(row0 + row) * W + col)
                : make_float2(0.f, 0.f);
            acc[mt][nt][2 * half] = v.x;
            acc[mt][nt][2 * half + 1] = v.y;
          }
        }
      float colsum[2] = {0.f, 0.f};
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = frag_row(mt, half);
          const float g0 = acc[mt][nt][2 * half], g1 = acc[mt][nt][2 * half + 1];
          const float m0 = __low2float(a2[mt][half]) > 0.f ? g0 : 0.f;
          const float m1 = __high2float(a2[mt][half]) > 0.f ? g1 : 0.f;
          colsum[0] += m0;
          colsum[1] += m1;
          *reinterpret_cast<bf162*>(H + row * LDA + col) = __floats2bfloat162_rn(m0, m1);
        }
      // db: this thread's 8 rows, then the warp's 8 row groups (shuffle
      // tree), then (below) the two row-warps of a column in order
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = colsum[e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4) dbs[wm * W + col + e] = v;
      }
    }
    __syncthreads();
    db_part[((size_t)blockIdx.x * DEPTH + i) * W + threadIdx.x] =
        dbs[threadIdx.x] + dbs[W + threadIdx.x];
    store_tile(wsr + (DEPTH + i) * buf, H);    // gmb_i

    if (i == SKIP + 1) {        // dx's skip part: gmb · W[8]ᵀ, kept in dx
      zero(acc);
      for (int k = 0; k < W / KC; ++k, ++c) {
        const bf16* st = next_chunk(stages, w, c, TOTAL);
        mma_stage_nk(acc, H, k * KC, st);
        __syncthreads();
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = row0 + frag_row(mt, half), col = frag_col(nt);
            if (row >= n) continue;
            if (col < din) dx[(size_t)row * din + col] = acc[mt][nt][2 * half];
            if (col + 1 < din) dx[(size_t)row * din + col + 1] = acc[mt][nt][2 * half + 1];
          }
    }
    zero(acc);                  // g = gmb · W[i]ᵀ
    for (int k = 0; k < W / KC; ++k, ++c) {
      // a_{i-1} into X, in the pipeline group of the next weight chunk: it
      // has arrived when that chunk has, well before layer i-1's mask
      if (k == 0 && i > 0) load_tile_async(X, wsr + i * buf);
      const bf16* st = next_chunk(stages, w, c, TOTAL);
      mma_stage_nk(acc, H, k * KC, st);
      __syncthreads();
    }
  }

  // 3. dx = (skip part) + g, each element by the thread that wrote it
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + frag_row(mt, half), col = frag_col(nt);
        if (row >= n) continue;
        if (col < din) dx[(size_t)row * din + col] += acc[mt][nt][2 * half];
        if (col + 1 < din) dx[(size_t)row * din + col + 1] += acc[mt][nt][2 * half + 1];
      }
}

// Weight gradients: partial[s][e] = A_eᵀ · G_e over row range s, as 128x128
// blocks.  A_e is buffer e (x, then a_0..a_6) for e < 8 and x for e = 8;
// G_e is gmb_e, and gmb_5 for e = 8.  8 warps as 2 (rows of dW) x 4
// (columns), 64x32 each; 32 rows per stage, two stages.
constexpr int WG_T = 128;              // dW block edge
constexpr int WG_K = 32;               // workspace rows per stage
constexpr int WG_LD = WG_T + 8;        // bf16 pitch

__global__ void __launch_bounds__(THREADS)
mlp_bwd_wgrad(const bf16* __restrict__ ws, float* __restrict__ dw_part, int npad, int splits) {
  __shared__ __align__(16) bf16 sA[2][WG_K * WG_LD];
  __shared__ __align__(16) bf16 sG[2][WG_K * WG_LD];
  const int s = blockIdx.x, tm = blockIdx.y >> 1, tn = blockIdx.y & 1, e = blockIdx.z;
  const size_t buf = (size_t)npad * W;
  const bf16* A = ws + (size_t)(e < DEPTH ? e : 0) * buf + tm * WG_T;
  const bf16* G = ws + (size_t)(DEPTH + (e < DEPTH ? e : SKIP + 1)) * buf + tn * WG_T;
  const int per = ((npad / WG_K + splits - 1) / splits) * WG_K;
  const int r_begin = s * per, r_end = min(npad, r_begin + per);
  const int nch = r_end > r_begin ? (r_end - r_begin) / WG_K : 0;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp >> 2) * 64, n0 = (warp & 3) * 32;
  const int q = lane >> 3, r = lane & 7;
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;

  auto load = [&](int stage, int ch) {
    const size_t row = (size_t)(r_begin + ch * WG_K);
    for (int i = threadIdx.x; i < 2 * WG_K * (WG_T / 8); i += THREADS) {
      const int which = i / (WG_K * (WG_T / 8)), j = i % (WG_K * (WG_T / 8));
      const int rr = j / (WG_T / 8), p = j % (WG_T / 8);
      const bf16* src = (which ? G : A) + (row + rr) * W + p * 8;
      bf16* dst = (which ? sG[stage] : sA[stage]) + rr * WG_LD + p * 8;
      cp_async16(dst, src);
    }
  };
  if (nch > 0) load(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) load((ch + 1) & 1, ch + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const bf16* a_s = sA[ch & 1];
    const bf16* g_s = sG[ch & 1];
#pragma unroll
    for (int ks = 0; ks < WG_K; ks += 16) {
      uint32_t a[4][4], bb[4][2];
      // A operand (dW rows = columns of the activations): stored [k][m]
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4_t(a[mt][0], a[mt][1], a[mt][2], a[mt][3],
                  a_s + (ks + (q >> 1) * 8 + r) * WG_LD + m0 + mt * 16 + (q & 1) * 8);
      // B operand (columns of gmb): stored [k][n]
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_t(bb[2 * np][0], bb[2 * np][1], bb[2 * np + 1][0], bb[2 * np + 1][1],
                  g_s + (ks + (q & 1) * 8 + r) * WG_LD + n0 + np * 16 + (q >> 1) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma(acc[mt][nt], a[mt], bb[nt]);
    }
    __syncthreads();
  }
  float* out = dw_part + ((size_t)s * (DEPTH + 1) + e) * W * W;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = tm * WG_T + m0 + mt * 16 + (lane >> 2) + half * 8;
        const int col = tn * WG_T + n0 + nt * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(out + (size_t)row * W + col) =
            make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
}

// dW = Σ_s partial[s], s in order.
__global__ void mlp_bwd_reduce_dw(const float* __restrict__ dw_part, float* __restrict__ dw,
                                  int splits) {
  const size_t total = (size_t)(DEPTH + 1) * W * W;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += dw_part[s * total + i];
  dw[i] = v;
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

// x (n,din) f32, wpack (9,256,256) bf16, bpack (8,256) f32, g (n,256) f32
// → dx (n,din), dw (9,256,256), db (8,256) f32.  Scratch from the caller:
// ws (16, ceil(n/128)·128, 256) bf16, db_part (ceil(n/128), 8, 256) f32,
// dw_part (splits, 9, 256, 256) f32.  All contiguous, on the device.
// Launches the four passes on `stream`; returns the first launch error.
extern "C" int mlp_bwd_launch(const float* x, const void* wpack, const float* bpack,
                              const float* g, float* dx, float* dw, float* db, void* ws,
                              float* db_part, float* dw_part, int n, int din, int splits,
                              void* stream) {
  if (n <= 0) return 0;
  if (din <= 0 || din > W || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (n + BM - 1) / BM;
  cudaError_t e = cudaFuncSetAttribute(mlp_bwd_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)ROWS_SMEM);
  if (e != cudaSuccess) return (int)e;
  const bf16* w = static_cast<const bf16*>(wpack);
  bf16* wsb = static_cast<bf16*>(ws);
  mlp_bwd_rows<<<blocks, THREADS, ROWS_SMEM, st>>>(x, w, bpack, g, dx, wsb, db_part, n, din);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  mlp_bwd_wgrad<<<dim3(splits, 4, DEPTH + 1), THREADS, 0, st>>>(wsb, dw_part, blocks * BM, splits);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int total = (DEPTH + 1) * W * W;
  mlp_bwd_reduce_dw<<<(total + 255) / 256, 256, 0, st>>>(dw_part, dw, splits);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  mlp_bwd_reduce_db<<<DEPTH * W / 32, THREADS, 0, st>>>(db_part, db, blocks);
  return (int)cudaGetLastError();
}
