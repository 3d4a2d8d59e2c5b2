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
// chip_smoke.py counts these on a training step's rows.  This design
// recomputes the forward in its second walk and reduces 18 values per row
// (5 shuffle steps each) in every warp with a non-zero contribution.  The
// bytes are the (T,K,24) rows in and out plus the cotangents: ~250 MB at
// T=2500, K=512 (~0.075 ms at 3.35 TB/s).
//
// Design: one CTA per tile, one thread per pixel, faces staged in shared
// memory in batches of RB rows and broadcast.
//   walk 1: the forward's loop (shade.cu): the winner (a strictly greater
//           1/w wins, so the first maximum in K order), its barycentrics and
//           1/w, and the soft silhouette's sum of log1p terms M; then the
//           per-pixel rgb-path quantities (pw_j, u_j, ubar, dq_j, S) stay in
//           registers;
//   walk 2: each pixel forms its 18 contributions to each valid row (six
//           screen coordinates, three 1/w, nine colours; the rgb path feeds
//           only its winner row); they are summed across the tile in a fixed
//           order: an xor-shuffle tree within each warp, then one partial per
//           warp in shared memory, summed in warp order.  No atomics, so the
//           result is deterministic; each tile writes only its own rows.
// Built with --fmad=false, so d2, uu and every tie and gate test round as
// the twin's separate PyTorch ops do: equality tests agree with it exactly.
// A simple, correct first kernel; its reductions are the slow part, and
// tuning comes later.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 24;   // row width of attrs
constexpr int USED = 19;    // lanes read from the staged rows (0-18)
constexpr int NOUT = 18;    // contributions per row: 6 coords, 3 1/w, 9 colours
constexpr int RB = 32;      // rows per staged batch
constexpr float AREA_MIN = 1e-4f;
constexpr float NEG = -3.0e38f;
constexpr float S_MAX = 0.999999f;  // 1 - 1e-6 in float32

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// jnp.minimum's gradient share of the first argument
__device__ __forceinline__ float half_split(float a, float b) {
  return a < b ? 1.f : (a == b ? 0.5f : 0.f);
}

__global__ void shade_bwd_kernel(const float* __restrict__ attrs,
                                 const float* __restrict__ g_rgb,
                                 const float* __restrict__ g_soft,
                                 float* __restrict__ d_attrs,
                                 int K, int tiles_x, int tile_h, int tile_w,
                                 float sigma) {
  extern __shared__ float smem[];
  float* rows = smem;                       // [RB][USED]
  float* part = smem + RB * USED;           // [RB][nwarps][NOUT]
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x;
  const int P = tile_h * tile_w;
  const int p = threadIdx.x;
  const float px = (float)((tile % tiles_x) * tile_w + p % tile_w) + 0.5f;
  const float py = (float)((tile / tiles_x) * tile_h + p / tile_w) + 0.5f;
  const float* a = attrs + (size_t)tile * K * LANES;
  float* d = d_attrs + (size_t)tile * K * LANES;
  const size_t o = (size_t)tile * P + p;
  const float gr = g_rgb[o * 3 + 0], gg = g_rgb[o * 3 + 1], gb = g_rgb[o * 3 + 2];
  const float gsoft = g_soft[o];

  // walk 1: the forward's winner and soft sum
  float best = NEG;
  int win = -1;
  float bw0 = 0.f, bw1 = 0.f, bw2 = 0.f, ww0 = 0.f, ww1 = 0.f, ww2 = 0.f;
  float log_keep = 0.f;
  for (int base = 0; base < K; base += RB) {
    const int n = min(RB, K - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * USED; i += blockDim.x) {
      const int row = i / USED, ln = i - row * USED;
      rows[i] = a[(size_t)(base + row) * LANES + ln];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* q = rows + j * USED;
      if (!(q[9] > 0.5f)) continue;
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
          win = base + j;
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
        const float t = fminf(fmaxf((qx * ex + qy * ey) / fmaxf(ex * ex + ey * ey, 1e-12f),
                                    0.f), 1.f);
        const float dx = qx - t * ex, dy = qy - t * ey;
        const float d2 = dx * dx + dy * dy;
        d2min = (e == 0) ? d2 : fminf(d2min, d2);
      }
      const float dist = sqrtf(d2min + 1e-12f);
      const float sd = inside ? -dist : dist;
      const float s = 1.f / (1.f + expf(sd / sigma));
      log_keep += log1pf(-fminf(fmaxf(s, 0.f), S_MAX));
    }
  }

  // the rgb-path quantities of the pixel
  const float q0 = bw0 * ww0, q1 = bw1 * ww1, q2 = bw2 * ww2;
  const float S_raw = q0 + q1 + q2;
  const float S_live = (S_raw >= 1e-12f) ? 1.f : 0.f;
  const float S = fmaxf(S_raw, 1e-12f);
  const float pw0 = q0 / S, pw1 = q1 / S, pw2 = q2 / S;
  float dq0 = 0.f, dq1 = 0.f, dq2 = 0.f;
  if (win >= 0) {
    const float* c = a + (size_t)win * LANES + 10;
    const float u0 = c[0] * gr + c[1] * gg + c[2] * gb;
    const float u1 = c[3] * gr + c[4] * gg + c[5] * gb;
    const float u2 = c[6] * gr + c[7] * gg + c[8] * gb;
    const float ubar = pw0 * u0 + pw1 * u1 + pw2 * u2;
    dq0 = (u0 - ubar) / S * S_live;
    dq1 = (u1 - ubar) / S * S_live;
    dq2 = (u2 - ubar) / S * S_live;
  }
  const float gs = -gsoft * expf(log_keep) / sigma;

  // walk 2: the 18 contributions of each valid row, reduced in a fixed order
  for (int base = 0; base < K; base += RB) {
    const int n = min(RB, K - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * USED; i += blockDim.x) {
      const int row = i / USED, ln = i - row * USED;
      rows[i] = a[(size_t)(base + row) * LANES + ln];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* q = rows + j * USED;
      float* pwp = part + (j * nwarps + warp) * NOUT;
      if (!(q[9] > 0.5f)) {                 // uniform across the block
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < NOUT; ++c) pwp[c] = 0.f;
        }
        continue;
      }
      float v[NOUT];
#pragma unroll
      for (int c = 0; c < NOUT; ++c) v[c] = 0.f;
      const float ax = q[0], ay = q[1], bx = q[2], by = q[3], cx = q[4], cy = q[5];
      const float e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx);
      const float e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx);
      const float e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax);
      const float area_raw = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
      const bool live = fabsf(area_raw) >= AREA_MIN;
      const float area = live ? area_raw : 1.f;
      const float b0 = e0 / area, b1 = e1 / area, b2 = e2 / area;
      const bool inside = (b0 >= 0.f) && (b1 >= 0.f) && (b2 >= 0.f) && live;
      const bool winner = (base + j == win);
      if (winner) {
        const float de0 = dq0 * ww0 / area, de1 = dq1 * ww1 / area, de2 = dq2 * ww2 / area;
        const float d_area = -(de0 * b0 + de1 * b1 + de2 * b2);
        v[0] = de1 * (py - cy) + de2 * (by - py) + d_area * (by - cy);
        v[1] = de1 * (cx - px) + de2 * (px - bx) + d_area * (cx - bx);
        v[2] = de2 * (py - ay) + de0 * (cy - py) + d_area * (cy - ay);
        v[3] = de2 * (ax - px) + de0 * (px - cx) + d_area * (ax - cx);
        v[4] = de0 * (py - by) + de1 * (ay - py) + d_area * (-(by - ay));
        v[5] = de0 * (bx - px) + de1 * (px - ax) + d_area * (bx - ax);
        v[6] = dq0 * bw0;
        v[7] = dq1 * bw1;
        v[8] = dq2 * bw2;
        v[9] = pw0 * gr;  v[10] = pw0 * gg; v[11] = pw0 * gb;
        v[12] = pw1 * gr; v[13] = pw1 * gg; v[14] = pw1 * gb;
        v[15] = pw2 * gr; v[16] = pw2 * gg; v[17] = pw2 * gb;
      }
      // soft path: the nearest edge segment, recomputed
      float d2[3], tt[3], uu[3], h[3], hl[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float vx0 = q[2 * e], vy0 = q[2 * e + 1];
        const float vx1 = q[(2 * e + 2) % 6], vy1 = q[(2 * e + 3) % 6];
        const float ex = vx1 - vx0, ey = vy1 - vy0;
        const float qx = px - vx0, qy = py - vy0;
        const float h_raw = ex * ex + ey * ey;
        h[e] = fmaxf(h_raw, 1e-12f);
        hl[e] = (h_raw >= 1e-12f) ? 1.f : 0.f;
        uu[e] = (qx * ex + qy * ey) / h[e];
        tt[e] = fminf(fmaxf(uu[e], 0.f), 1.f);
        const float dx = qx - tt[e] * ex, dy = qy - tt[e] * ey;
        d2[e] = dx * dx + dy * dy;
      }
      const float m01 = fminf(d2[0], d2[1]);
      const float d2min = fminf(m01, d2[2]);
      const float w0a = half_split(d2[0], d2[1]);
      const float wm = half_split(m01, d2[2]);
      const float picks[3] = {w0a * wm, (1.f - w0a) * wm, 1.f - wm};
      const float dist = sqrtf(d2min + 1e-12f);
      const float sd = inside ? -dist : dist;
      const float s = 1.f / (1.f + expf(sd / sigma));
      const float sc_live = (s <= S_MAX) ? 1.f : 0.f;
      const float d_signed = gs * s * sc_live;
      const float d_dist = inside ? -d_signed : d_signed;
      const float d_d2min = d_dist / (2.f * dist);
      if (d_d2min != 0.f) {
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const float vx0 = q[2 * e], vy0 = q[2 * e + 1];
          const float vx1 = q[(2 * e + 2) % 6], vy1 = q[(2 * e + 3) % 6];
          const float ex = vx1 - vx0, ey = vy1 - vy0;
          const float qx = px - vx0, qy = py - vy0;
          const float tg = (uu[e] > 0.f && uu[e] < 1.f) ? 1.f
                           : ((uu[e] == 0.f || uu[e] == 1.f) ? 0.5f : 0.f);
          const float d_d2 = d_d2min * picks[e];
          const float dx = qx - tt[e] * ex, dy = qy - tt[e] * ey;
          const float g2x = d_d2 * 2.f * dx, g2y = d_d2 * 2.f * dy;
          const float dt = -(g2x * ex + g2y * ey);
          const float d_qx = g2x + dt * tg * ex / h[e];
          const float d_qy = g2y + dt * tg * ey / h[e];
          const float d_ex = -tt[e] * g2x + dt * tg * (qx - 2.f * ex * uu[e]) * hl[e] / h[e];
          const float d_ey = -tt[e] * g2y + dt * tg * (qy - 2.f * ey * uu[e]) * hl[e] / h[e];
          const int v0 = e, v1 = (e + 1) % 3;   // edge v0 → v1
          v[2 * v0] += -d_qx - d_ex;
          v[2 * v0 + 1] += -d_qy - d_ey;
          v[2 * v1] += d_ex;
          v[2 * v1 + 1] += d_ey;
        }
      }
      if (__any_sync(0xffffffffu, winner || d_d2min != 0.f)) {
#pragma unroll
        for (int c = 0; c < NOUT; ++c) v[c] = warp_sum(v[c]);
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < NOUT; ++c) pwp[c] = v[c];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * LANES; i += blockDim.x) {
      const int row = i / LANES, c = i - row * LANES;
      // lanes 0-8 ← contributions 0-8, lanes 10-18 ← 9-17, lanes 9, 19-23 ← 0
      const int src = c < 9 ? c : (c >= 10 && c < 19 ? c - 1 : -1);
      float s = 0.f;
      if (src >= 0) {
        const float* pr = part + row * nwarps * NOUT + src;
        for (int w = 0; w < nwarps; ++w) s += pr[w * NOUT];
      }
      d[(size_t)(base + row) * LANES + c] = s;
    }
  }
}

}  // namespace

// attrs (T,K,24), g_rgb (T,P,3), g_soft (T,P) → d_attrs (T,K,24); all
// float32, contiguous, on the device; P = tile_h*tile_w a multiple of 32, at
// most 1024.  Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int shade_bwd_launch(const float* attrs, const float* g_rgb,
                                const float* g_soft, float* d_attrs, int T, int K,
                                int tiles_x, int tile_h, int tile_w, float sigma,
                                void* stream) {
  const int P = tile_h * tile_w;
  if (T <= 0 || K <= 0) return 0;
  if (P <= 0 || P > 1024 || P % 32 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(RB * USED + RB * (P / 32) * NOUT) * sizeof(float);
  shade_bwd_kernel<<<T, P, smem, (cudaStream_t)stream>>>(
      attrs, g_rgb, g_soft, d_attrs, K, tiles_x, tile_h, tile_w, sigma);
  return (int)cudaGetLastError();
}
