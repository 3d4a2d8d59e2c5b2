// Mesh tile shading, analytic backward through rgb and soft — CUDA C++ for
// Hopper (sm_90a).
//
// Replaces the TPU kernel
// dgmesh_tpu/ops/mesh_raster_pallas.py::_shade_bwd_kernel (reached through
// shade_bwd_pallas / make_shade_tiles's custom_vjp).
//
// What it computes, per 16x16 tile and its K binned faces (attrs (T,K,24),
// the forward kernel's layout: 0-5 screen triangle ax,ay,bx,by,cx,cy | 6-8
// clip 1/w | 9 valid | 10-18 corner colours | 19 face id), given the
// cotangents g_rgb (T,P,3) and g_soft (T,P):
//   rgb path (the pixel's z-buffer winner row only): pw_j = q_j/S with
//     q_j = b_j/w_j, S = max(sum q, 1e-12) gated by S >= 1e-12;
//     d colour_j = pw_j g_rgb;  dq_j = (u_j - ubar)/S with u_j = colour_j .
//     g_rgb; d(1/w_j) = dq_j b_j; d b_j = dq_j/w_j → edge functions and the
//     signed area → the six screen coordinates;
//   soft path (every valid row): d signed = -g_soft exp(M)/sigma * s, gated
//     by s <= 1 - 1e-6, through the clipped point-segment distance of the
//     nearest edge, with the clip weights tg (1 inside (0,1), 0.5 at uu = 0
//     or 1, 0 outside) and the nearest-edge picks split 0.5/0.5 at exact d2
//     ties, as jnp.clip and jnp.minimum split their gradients.
// Lanes 9 and 19-23 are written 0; rows that are not valid get exactly 0.
// The gates are those of the plain twin
// (ops/mesh_raster_kernels.py::shade_bwd_ref) operation by operation.
//
// What bounds it on the H100: operations.  The function needs the
// forward's ~118 operations per (pixel, valid face) pair once, ~159 more
// per pair whose soft gradient is not zero (three edges' partials and their
// six sums), and ~117 per pixel with a winner for the rgb path;
// chip_smoke.py counts these on a training step's rows.  The bytes are the
// (T,K,24) rows in and out plus the cotangents: ~250 MB at T=2500, K=512
// (~0.075 ms at 3.35 TB/s).
//
// Design: SPLIT (2) CTAs per tile, in three phases.  The per-row gradient
// is a sum over the tile's pixels, so a thread that owns a row forms it in
// registers.  Both CTAs of a tile repeat the compaction and phase A, and
// each sums half of the valid rows, so a tile at the K cap is two blocks of
// work and the last wave of blocks is shorter; 16x16 tiles run at most 85
// registers a thread, three CTAs an SM.
//   compaction: the tile's valid rows, listed in K order (a ballot and a
//           prefix count per warp, so the list is deterministic); the rows
//           that are not valid are written 0 here, coalesced;
//   phase A, one thread per pixel: the z-buffer winner (a strictly greater
//           1/w wins, so the first maximum in K order), its barycentrics
//           and 1/w, and the soft silhouette's sum of log1p terms M.  In
//           training the forward kernel (shade.cu) has left the winner row
//           and M of each pixel (shade_bwd_res_launch): the winner's
//           barycentrics are recomputed from its row by the forward's own
//           operations, and no row is walked.  Without them
//           (shade_bwd_launch) the forward's walk over the valid rows runs
//           here (rows staged in shared memory in batches of RB and
//           broadcast), with the same results.  Each pixel then leaves its
//           state in shared memory: its winner row (or -1), its soft factor
//           gs = -g_soft e^M / sigma, and its 18 rgb-path contributions to
//           the winner row (six screen coordinates, three 1/w, nine colours);
//   phase B, one thread per valid row of the CTA's half (slots lo + t,
//           lo + t + blockDim, ...): the row's coordinates, edges, squared
//           edge lengths and signed area in registers; the loop over the
//           tile's pixels in row-major order adds the pair's soft-path terms
//           and, at the pixels the row wins, the pixel's rgb contributions
//           to 18 sums in registers.  The sums leave through shared memory
//           as whole 16-byte stores.
// No shuffles, no partial buffers, no atomics: every sum runs in one thread
// in a fixed order, so two launches give the same bits; each CTA writes
// only rows of its own.
// Built with --fmad=false and IEEE division and square root, so d2, uu and
// every tie and gate test round as the twin's separate PyTorch ops do:
// equality tests agree with it exactly.  The four partials of each edge
// that feed no gate multiply by the row's 1/h where the twin divides by h
// (a few ulps apart): at a training step's rows on an H100 those twelve
// divisions a pair took 1.47 of 2.42 ms, far more than the fast path of a
// division costs; their numerators carry e^M, which is tiny where a pixel
// is covered many times over, and such divisions take the slow path.
// NaN: the soft path's clamps and its nearest-edge minimum keep a NaN, as
// the twin's and JAX's do (keep_nan.cuh).  In phase B a row whose corners
// all lie within 2^60 of the origin cannot meet a NaN there (as in
// shade.cu), so it takes fminf/fmaxf, the same bits; any other row takes
// keep_nan.cuh's versions.

#include <cuda_runtime.h>

#include "keep_nan.cuh"

namespace {

constexpr int LANES = 24;   // row width of attrs
constexpr int USED = 19;    // lanes read from the staged rows (0-18)
constexpr int NOUT = 18;    // sums per row: 6 coords, 3 1/w, 9 colours
constexpr int OSTRIDE = NOUT + 1;  // staged sums per row, padded (banks)
constexpr int RB = 32;      // rows per staged batch in phase A
constexpr int SPLIT = 2;    // CTAs per tile, each summing a share of its rows
constexpr float AREA_MIN = 1e-4f;
constexpr float NEG = -3.0e38f;
constexpr float S_MAX = 0.999999f;  // 1 - 1e-6 in float32

constexpr float SAFE = 1.152921504606846976e18f;  // 2^60: a corner this far in is safe

// the edge projections clamped to [0, 1] (tt), the squared distances to the
// three edge segments (d2), the nearer of the first two (m01) and the
// nearest (d2min); KEEP: the clamps and minima keep a NaN
template <bool KEEP>
__device__ __forceinline__ void nearest_edge(const float (&qx)[3], const float (&qy)[3],
                                             const float (&ex)[3], const float (&ey)[3],
                                             const float (&uu)[3], float (&tt)[3],
                                             float (&d2)[3], float& m01, float& d2min) {
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    tt[e] = KEEP ? keep_nan::clamp(uu[e], 0.f, 1.f) : fminf(fmaxf(uu[e], 0.f), 1.f);
    const float dx = qx[e] - tt[e] * ex[e], dy = qy[e] - tt[e] * ey[e];
    d2[e] = dx * dx + dy * dy;
  }
  m01 = KEEP ? keep_nan::min(d2[0], d2[1]) : fminf(d2[0], d2[1]);
  d2min = KEEP ? keep_nan::min(m01, d2[2]) : fminf(m01, d2[2]);
}

// jnp.minimum's gradient share of the first argument
__device__ __forceinline__ float half_split(float a, float b) {
  return a < b ? 1.f : (a == b ? 0.5f : 0.f);
}

// dynamic shared memory, in 4-byte words, for K rows and P pixel threads
__host__ __device__ constexpr size_t smem_words(int K, int P) {
  return (size_t)2 * K            // vrow, rowslot
         + 32                     // per-warp counts of the compaction
         + RB * USED              // phase A's staged rows
         + (size_t)P * (2 + NOUT) // pixel state: winner, gs, 18 rgb terms
         + (size_t)P * OSTRIDE;   // phase B's sums on their way out
}

// MAX_THREADS ≥ blockDim.x; with MIN_BLOCKS resident CTAs per SM
template <int MAX_THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
shade_bwd_kernel(const float* __restrict__ attrs, const float* __restrict__ g_rgb,
                 const float* __restrict__ g_soft, const int* __restrict__ win_in,
                 const float* __restrict__ m_in, float* __restrict__ d_attrs,
                 int K, int tiles_x, int tile_h, int tile_w, int tile0, float sigma) {
  extern __shared__ float smem[];
  const int P = tile_h * tile_w;
  int* vrow = reinterpret_cast<int*>(smem);           // [K] valid rows, K order
  int* rowslot = vrow + K;                            // [K] slot in vrow, or -1
  int* wcnt = rowslot + K;                            // [32]
  float* rows = reinterpret_cast<float*>(wcnt + 32);  // [RB][USED]
  int* pix_win = reinterpret_cast<int*>(rows + RB * USED);  // [P]
  float* pix_gs = reinterpret_cast<float*>(pix_win + P);    // [P]
  float* pix_rgb = pix_gs + P;                        // [NOUT][P]
  float* stage = pix_rgb + NOUT * P;                  // [P][OSTRIDE]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int tile = blockIdx.x / SPLIT, part = blockIdx.x % SPLIT;
  const int ox = ((tile0 + tile) % tiles_x) * tile_w, oy = ((tile0 + tile) / tiles_x) * tile_h;
  const float* a = attrs + (size_t)tile * K * LANES;
  float4* d4 = reinterpret_cast<float4*>(d_attrs + (size_t)tile * K * LANES);

  // compaction: the valid rows in K order
  int nv = 0;
  for (int base = 0; base < K; base += blockDim.x) {
    const int r = base + threadIdx.x;
    const bool v = r < K && a[(size_t)r * LANES + 9] > 0.5f;
    const unsigned m = __ballot_sync(0xffffffffu, v);
    if (lane == 0) wcnt[warp] = __popc(m);
    __syncthreads();
    int before = nv, total = nv;
    for (int w = 0; w < nwarps; ++w) {
      before += w < warp ? wcnt[w] : 0;
      total += wcnt[w];
    }
    const int pos = before + __popc(m & ((1u << lane) - 1u));
    if (r < K) rowslot[r] = v ? pos : -1;
    if (v) vrow[pos] = r;
    nv = total;
    __syncthreads();
  }
  // rows that are not valid: exactly 0 (the tile's CTAs take turns)
  for (int i = threadIdx.x + part * blockDim.x; i < K * (LANES / 4);
       i += SPLIT * blockDim.x)
    if (rowslot[i / (LANES / 4)] < 0) d4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // this CTA's share of the valid rows: slots [lo, hi)
  const int share = (nv + SPLIT - 1) / SPLIT;
  const int lo = part * share, hi = min(nv, lo + share);
  if (lo >= hi) return;

  // phase A, one thread per pixel: the forward's winner and soft sum, read
  // from the forward's residuals or found by its walk over the valid rows
  const int p = threadIdx.x;
  const float px = (float)(ox + p % tile_w) + 0.5f;
  const float py = (float)(oy + p / tile_w) + 0.5f;
  const size_t o = (size_t)tile * P + p;
  const float gr = g_rgb[o * 3 + 0], gg = g_rgb[o * 3 + 1], gb = g_rgb[o * 3 + 2];
  const float gsoft = g_soft[o];
  float best = NEG;
  int win = -1;
  float bw0 = 0.f, bw1 = 0.f, bw2 = 0.f, ww0 = 0.f, ww1 = 0.f, ww2 = 0.f;
  float log_keep = 0.f;
  if (win_in) {
    win = win_in[o];
    log_keep = m_in[o];
    if (win >= 0) {   // inside, so live: the walk's operations on the row
      const float* q = a + (size_t)win * LANES;
      const float ax = q[0], ay = q[1], bx = q[2], by = q[3], cx = q[4], cy = q[5];
      const float e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx);
      const float e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx);
      const float e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax);
      const float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
      bw0 = e0 / area; bw1 = e1 / area; bw2 = e2 / area;
      ww0 = q[6]; ww1 = q[7]; ww2 = q[8];
    }
  }
  for (int base = 0; !win_in && base < nv; base += RB) {
    const int n = min(RB, nv - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * USED; i += blockDim.x) {
      const int row = i / USED, ln = i - row * USED;
      rows[i] = a[(size_t)vrow[base + row] * LANES + ln];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* q = rows + j * USED;
      const float ax = q[0], ay = q[1], bx = q[2], by = q[3], cx = q[4], cy = q[5];
      const float e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx);
      const float e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx);
      const float e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax);
      const float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
      const bool live = fabsf(area) >= AREA_MIN;
      const float as = live ? area : 1.f;
      const float b0 = e0 / as, b1 = e1 / as, b2 = e2 / as;
      const bool inside = (b0 >= 0.f) && (b1 >= 0.f) && (b2 >= 0.f) && live;
      if (inside) {
        const float zi = b0 * q[6] + b1 * q[7] + b2 * q[8];
        if (zi > best) {
          best = zi;
          win = vrow[base + j];
          bw0 = b0; bw1 = b1; bw2 = b2;
          ww0 = q[6]; ww1 = q[7]; ww2 = q[8];
        }
      }
      float d2min = 0.f;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float vx0 = q[2 * e], vy0 = q[2 * e + 1];
        const float vx1 = q[(2 * e + 2) % 6], vy1 = q[(2 * e + 3) % 6];
        const float ex = vx1 - vx0, ey = vy1 - vy0;
        const float qx = px - vx0, qy = py - vy0;
        const float t = keep_nan::clamp(
            (qx * ex + qy * ey) / keep_nan::max(ex * ex + ey * ey, 1e-12f), 0.f, 1.f);
        const float dx = qx - t * ex, dy = qy - t * ey;
        const float d2 = dx * dx + dy * dy;
        d2min = (e == 0) ? d2 : keep_nan::min(d2min, d2);
      }
      const float dist = sqrtf(d2min + 1e-12f);
      const float sd = inside ? -dist : dist;
      const float s = 1.f / (1.f + expf(sd / sigma));
      log_keep += log1pf(-(s > S_MAX ? S_MAX : s));   // s in [+0, 1] or NaN
    }
  }

  // the pixel's state: its winner, its soft factor, its rgb-path terms
  pix_win[p] = win;
  pix_gs[p] = -gsoft * expf(log_keep) / sigma;
  if (win >= 0) {
    const float* w = a + (size_t)win * LANES;
    const float ax = w[0], ay = w[1], bx = w[2], by = w[3], cx = w[4], cy = w[5];
    const float q0 = bw0 * ww0, q1 = bw1 * ww1, q2 = bw2 * ww2;
    const float S_raw = q0 + q1 + q2;
    const float S_live = (S_raw >= 1e-12f) ? 1.f : 0.f;
    const float S = keep_nan::max(S_raw, 1e-12f);
    const float pw0 = q0 / S, pw1 = q1 / S, pw2 = q2 / S;
    const float u0 = w[10] * gr + w[11] * gg + w[12] * gb;
    const float u1 = w[13] * gr + w[14] * gg + w[15] * gb;
    const float u2 = w[16] * gr + w[17] * gg + w[18] * gb;
    const float ubar = pw0 * u0 + pw1 * u1 + pw2 * u2;
    const float dq0 = (u0 - ubar) / S * S_live;
    const float dq1 = (u1 - ubar) / S * S_live;
    const float dq2 = (u2 - ubar) / S * S_live;
    // the winner is inside, so its area is live
    const float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
    const float de0 = dq0 * ww0 / area, de1 = dq1 * ww1 / area, de2 = dq2 * ww2 / area;
    const float d_area = -(de0 * bw0 + de1 * bw1 + de2 * bw2);
    const float v[NOUT] = {
        de1 * (py - cy) + de2 * (by - py) + d_area * (by - cy),
        de1 * (cx - px) + de2 * (px - bx) + d_area * (cx - bx),
        de2 * (py - ay) + de0 * (cy - py) + d_area * (cy - ay),
        de2 * (ax - px) + de0 * (px - cx) + d_area * (ax - cx),
        de0 * (py - by) + de1 * (ay - py) + d_area * (-(by - ay)),
        de0 * (bx - px) + de1 * (px - ax) + d_area * (bx - ax),
        dq0 * bw0, dq1 * bw1, dq2 * bw2,
        pw0 * gr, pw0 * gg, pw0 * gb,
        pw1 * gr, pw1 * gg, pw1 * gb,
        pw2 * gr, pw2 * gg, pw2 * gb};
#pragma unroll
    for (int c = 0; c < NOUT; ++c) pix_rgb[c * P + p] = v[c];
  }
  __syncthreads();

  // phase B, one thread per valid row: its 18 sums over the tile's pixels
  for (int r0 = lo; r0 < hi; r0 += blockDim.x) {
    const int slot = r0 + threadIdx.x;
    if (slot < hi) {
      const int row = vrow[slot];
      const float* q = a + (size_t)row * LANES;
      float vx[3], vy[3], ex[3], ey[3], h[3], hl[3], rh[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        vx[e] = q[2 * e];
        vy[e] = q[2 * e + 1];
      }
#pragma unroll
      for (int e = 0; e < 3; ++e) {   // edge e runs from vertex e to e + 1
        ex[e] = vx[(e + 1) % 3] - vx[e];
        ey[e] = vy[(e + 1) % 3] - vy[e];
        const float h_raw = ex[e] * ex[e] + ey[e] * ey[e];
        h[e] = keep_nan::max(h_raw, 1e-12f);
        hl[e] = (h_raw >= 1e-12f) ? 1.f : 0.f;
        rh[e] = 1.f / h[e];
      }
      const float ax = vx[0], ay = vy[0], bx = vx[1], by = vy[1], cx = vx[2], cy = vy[2];
      const float area_raw = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
      const bool live = fabsf(area_raw) >= AREA_MIN;
      const float area = live ? area_raw : 1.f;
      const bool safe = fabsf(ax) < SAFE && fabsf(ay) < SAFE && fabsf(bx) < SAFE &&
                        fabsf(by) < SAFE && fabsf(cx) < SAFE && fabsf(cy) < SAFE;
      float acc[NOUT];
#pragma unroll
      for (int c = 0; c < NOUT; ++c) acc[c] = 0.f;
      for (int yy = 0; yy < tile_h; ++yy) {
        const float py = (float)(oy + yy) + 0.5f;
        for (int xx = 0; xx < tile_w; ++xx) {
          const int pp = yy * tile_w + xx;
          const float px = (float)(ox + xx) + 0.5f;
          const float e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx);
          const float e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx);
          const float e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax);
          const float b0 = e0 / area, b1 = e1 / area, b2 = e2 / area;
          const bool inside = (b0 >= 0.f) && (b1 >= 0.f) && (b2 >= 0.f) && live;
          // soft path: the nearest edge segment
          float qx[3], qy[3], d2[3], tt[3], uu[3], m01, d2min;
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            qx[e] = px - vx[e];
            qy[e] = py - vy[e];
            uu[e] = (qx[e] * ex[e] + qy[e] * ey[e]) / h[e];
          }
          if (safe) nearest_edge<false>(qx, qy, ex, ey, uu, tt, d2, m01, d2min);
          else nearest_edge<true>(qx, qy, ex, ey, uu, tt, d2, m01, d2min);
          const float w0a = half_split(d2[0], d2[1]);
          const float wm = half_split(m01, d2[2]);
          const float picks[3] = {w0a * wm, (1.f - w0a) * wm, 1.f - wm};
          const float dist = sqrtf(d2min + 1e-12f);
          const float sd = inside ? -dist : dist;
          const float s = 1.f / (1.f + expf(sd / sigma));
          const float sc_live = (s <= S_MAX) ? 1.f : 0.f;
          const float d_signed = pix_gs[pp] * s * sc_live;
          const float d_dist = inside ? -d_signed : d_signed;
          const float d_d2min = d_dist / (2.f * dist);
          if (d_d2min != 0.f) {
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              const float tg = (uu[e] > 0.f && uu[e] < 1.f) ? 1.f
                               : ((uu[e] == 0.f || uu[e] == 1.f) ? 0.5f : 0.f);
              const float d_d2 = d_d2min * picks[e];
              const float dx = qx[e] - tt[e] * ex[e], dy = qy[e] - tt[e] * ey[e];
              const float g2x = d_d2 * 2.f * dx, g2y = d_d2 * 2.f * dy;
              const float dt = -(g2x * ex[e] + g2y * ey[e]);
              const float d_qx = g2x + dt * tg * ex[e] * rh[e];
              const float d_qy = g2y + dt * tg * ey[e] * rh[e];
              const float d_ex =
                  -tt[e] * g2x + dt * tg * (qx[e] - 2.f * ex[e] * uu[e]) * hl[e] * rh[e];
              const float d_ey =
                  -tt[e] * g2y + dt * tg * (qy[e] - 2.f * ey[e] * uu[e]) * hl[e] * rh[e];
              const int v1 = (e + 1) % 3;
              acc[2 * e] += -d_qx - d_ex;
              acc[2 * e + 1] += -d_qy - d_ey;
              acc[2 * v1] += d_ex;
              acc[2 * v1 + 1] += d_ey;
            }
          }
          if (pix_win[pp] == row) {
#pragma unroll
            for (int c = 0; c < NOUT; ++c) acc[c] += pix_rgb[c * P + pp];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < NOUT; ++c) stage[threadIdx.x * OSTRIDE + c] = acc[c];
    }
    __syncthreads();
    // the round's rows leave as whole 16-byte stores: lanes 0-8 ← sums
    // 0-8, lanes 10-18 ← 9-17, lanes 9 and 19-23 ← 0
    const int n = min((int)blockDim.x, hi - r0);
    for (int i = threadIdx.x; i < n * (LANES / 4); i += blockDim.x) {
      const int s = i / (LANES / 4), part = i - s * (LANES / 4);
      const float* st = stage + s * OSTRIDE;
      float out[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = part * 4 + k;
        const int src = c < 9 ? c : (c >= 10 && c < 19 ? c - 1 : -1);
        out[k] = src >= 0 ? st[src] : 0.f;
      }
      d4[(size_t)vrow[r0 + s] * (LANES / 4) + part] = make_float4(out[0], out[1], out[2], out[3]);
    }
    __syncthreads();
  }
}

}  // namespace

namespace {

template <int MAX_THREADS, int MIN_BLOCKS>
int run(const float* attrs, const float* g_rgb, const float* g_soft, const int* win,
        const float* M, float* d_attrs, int T, int K, int tiles_x, int tile_h, int tile_w,
        int tile0, float sigma, void* stream) {
  const auto kernel = shade_bwd_kernel<MAX_THREADS, MIN_BLOCKS>;
  const size_t smem = smem_words(K, tile_h * tile_w) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<T * SPLIT, tile_h * tile_w, smem, (cudaStream_t)stream>>>(
      attrs, g_rgb, g_soft, win, M, d_attrs, K, tiles_x, tile_h, tile_w, tile0, sigma);
  return (int)cudaGetLastError();
}

// 16x16 tiles (P = 256, every shipped config) run with at most 85 registers
// a thread, so three CTAs fit on an SM; larger tiles get one CTA of up to
// 1024 threads
int launch(const float* attrs, const float* g_rgb, const float* g_soft, const int* win,
           const float* M, float* d_attrs, int T, int K, int tiles_x, int tile_h,
           int tile_w, int tile0, float sigma, void* stream) {
  const int P = tile_h * tile_w;
  if (T <= 0 || K <= 0) return 0;
  if (P <= 0 || P > 1024 || P % 32 != 0) return (int)cudaErrorInvalidValue;
  return P <= 256 ? run<256, 3>(attrs, g_rgb, g_soft, win, M, d_attrs, T, K, tiles_x, tile_h,
                                tile_w, tile0, sigma, stream)
                  : run<1024, 1>(attrs, g_rgb, g_soft, win, M, d_attrs, T, K, tiles_x, tile_h,
                                 tile_w, tile0, sigma, stream);
}

}  // namespace

// Every launcher takes tile0: block b of the launch is tile tile0 + b of the
// image (its pixel origin), while it reads and writes row b of the arrays.
// A rank of the multi-device step composites its own block of tiles this way.
extern "C" int takes_tile0() { return 1; }

// attrs (T,K,24), g_rgb (T,P,3), g_soft (T,P) → d_attrs (T,K,24); all
// float32, contiguous, on the device; P = tile_h*tile_w a multiple of 32, at
// most 1024.  Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int shade_bwd_launch(const float* attrs, const float* g_rgb,
                                const float* g_soft, float* d_attrs, int T, int K,
                                int tiles_x, int tile_h, int tile_w, int tile0,
                                float sigma, void* stream) {
  return launch(attrs, g_rgb, g_soft, nullptr, nullptr, d_attrs, T, K, tiles_x, tile_h,
                tile_w, tile0, sigma, stream);
}

// The same, given the forward kernel's residuals: win (T,P) int32, each
// pixel's winner row within its tile or -1, and M (T,P) float32, its sum of
// log1p terms (shade_tiles_launch's win and M for these attrs).
extern "C" int shade_bwd_res_launch(const float* attrs, const float* g_rgb,
                                    const float* g_soft, const int* win, const float* M,
                                    float* d_attrs, int T, int K, int tiles_x,
                                    int tile_h, int tile_w, int tile0, float sigma,
                                    void* stream) {
  return launch(attrs, g_rgb, g_soft, win, M, d_attrs, T, K, tiles_x, tile_h, tile_w,
                tile0, sigma, stream);
}
