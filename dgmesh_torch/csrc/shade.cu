// Mesh tile shading, forward — CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel dgmesh_tpu/ops/mesh_raster_pallas.py::_shade_kernel
// (reached through shade_tiles_pallas / make_shade_tiles).
//
// What it computes, per 16x16 tile and its K binned faces (attrs (T,K,24)
// float32: 0-5 screen triangle ax,ay,bx,by,cx,cy | 6-8 clip 1/w per corner |
// 9 valid | 10-18 corner colours | 19 face id | 20-23 padding), at pixel
// centres +0.5:
//   edge-function barycentrics divided by the signed area (double-sided),
//   gated by |area| >= AREA_MIN (1e-4); inside = all b >= 0 & valid & live;
//   z-buffer on the maximum interpolated 1/w, first maximum in K order;
//   perspective-correct colour pw_j = b_j/w_j / max(sum, 1e-12);
//   hard coverage, winner face id (0 where no winner), and the SoftRas
//   silhouette 1 - prod(1 - clip(sigmoid(-signed_d/sigma), 0, 1-1e-6)),
//   accumulated as a sum of log1p terms M.
// When asked (training), it also writes each pixel's winner row within the
// tile (-1 where none) and M: the backward kernel (shade_bwd.cu) reads
// them instead of walking the rows again.
// The soft silhouette is computed although the render path does not read
// it: training needs it.
//
// What bounds it on the H100: instruction issue.  Each (pixel, valid face)
// pair needs about 118 float32 operations, three divisions, a square root,
// an exp and a log1p among them (each counted as one); at the main path's
// T=2500, K=512, P=256 with ~17% of the K slots valid that is ~6.4e9
// operations (~0.1 ms at 67 TFLOP/s float32), against ~138 MB of traffic
// (~0.04 ms at 3.35 TB/s).  But 67 TFLOP/s counts a fused multiply-add as
// two operations, and this code, built with --fmad=false, issues none of
// its own; an IEEE division, square root, exp or log1p is a sequence of
// instructions.  A pair costs ~178 instructions (SASS), so the pairs are
// bound by instruction issue; and the valid rows crowd into a few hundred
// tiles at the K cap, three or four of them on an SM.
//
// Design: one CTA per tile, one thread per pixel; each warp covers an 8x4
// block of pixels, so that the gate's shortcut below is taken by whole
// warps.
//   compaction: the tile's valid rows, listed in K order (a ballot and a
//           prefix count per warp, so the list is deterministic); a tile
//           with none walks nothing and writes the no-face outputs;
//   staging: batches of blockDim valid rows, one thread per row: the row's
//           corners and 1/w, and the constants every pixel needs of it,
//           computed once: the edge vectors, each edge's squared length
//           max(ex² + ey², 1e-12), the signed area where it is live (else
//           0), its sign, and the bound below which an edge function is
//           sure to give a negative barycentric (the same operations in
//           the same order as per pixel, so the same bits);
//   walk:   each pixel thread over the staged rows in K order, two rows an
//           iteration (independent work until the sum), keeping its
//           z-buffer winner (a strictly greater 1/w wins, so the first
//           maximum in K order is kept, as the reference's
//           `ismax & cnt < 1.5` does), the winner's barycentrics and 1/w in
//           registers, and the sum M of log1p terms in K order; the
//           winner's colours and face id are read from device memory once
//           at the end.
// The gate's shortcut: the barycentrics b_i = e_i/as are divided only
// where no edge function has the sign opposite to as with |e_i| >= 2^-22.
// Where one has, |as| < 2^128 makes |e_i/as| > 2^-150, so the quotient
// rounds to a negative number, never to -0 (which passes b >= 0): the pair
// is outside, as the division would have found.  A smaller |e_i|, a zero,
// a NaN and an infinite as take the division.  Where sigma is a power of
// two, -sd/sigma is -sd times 1/sigma: the same real number, rounded once,
// so the same bits.  Every output is the bits of the straightforward walk.
// Built with --fmad=false, so every operation rounds like the plain
// PyTorch twin's, and winners agree with it exactly.
// NaN: the soft path's clamps and its nearest-edge minimum keep a NaN, as
// the twin's and JAX's do (a row with a NaN corner makes the tile's soft
// silhouette NaN).  On a row whose corners all lie within 2^60 of the
// origin no NaN can arise there (|e| < 2^61, h < 2^123 and |u| < 2^82 are
// finite), so such rows take fminf/fmaxf as before, the same bits; the
// others (a NaN, an infinite or a huge corner) take keep_nan.cuh's
// versions and the division (lim -inf).  Which of the two a row takes is
// the same for every pixel of the walk, so warps do not diverge on it.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

#include "keep_nan.cuh"

namespace {

constexpr int LANES = 24;   // row width of attrs
constexpr float AREA_MIN = 1e-4f;
constexpr float NEG = -3.0e38f;
constexpr float S_MAX = 0.999999f;  // 1 - 1e-6 in float32
constexpr float SURE_NEG = 2.384185791015625e-07f;  // 2^-22
constexpr int UNROLL = 2;  // rows a walk iteration
constexpr float SAFE = 1.152921504606846976e18f;  // 2^60: a corner this far in is safe

// a staged row: five float4 of shared memory
struct Row {
  float4 ab;    // ax, ay, bx, by
  float4 ce;    // cx, cy, and edge 0 (a→b): ex0, ey0
  float4 ee;    // edge 1 (b→c): ex1, ey1; edge 2 (c→a): ex2, ey2
  float4 h;     // max(ex² + ey², 1e-12) of edges 0-2; the live area or 0
  float4 w;     // 1/w of the corners; lim: sg*e_i <= lim means b_i < 0,
                // -inf on a row that is not safe
};

// the pixel's squared distance to the row's nearest edge segment, edge e
// from corner e; KEEP: its clamps and minimum keep a NaN
template <bool KEEP>
__device__ __forceinline__ float nearest_d2(const float (&qx)[3], const float (&qy)[3],
                                            const float (&ex)[3], const float (&ey)[3],
                                            const float (&hh)[3]) {
  float d2min = 0.f;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float u = (qx[e] * ex[e] + qy[e] * ey[e]) / hh[e];
    const float t = KEEP ? keep_nan::clamp(u, 0.f, 1.f) : fminf(fmaxf(u, 0.f), 1.f);
    const float dx = qx[e] - t * ex[e], dy = qy[e] - t * ey[e];
    const float d2 = dx * dx + dy * dy;
    d2min = (e == 0) ? d2 : (KEEP ? keep_nan::min(d2min, d2) : fminf(d2min, d2));
  }
  return d2min;
}

// MAX_THREADS >= blockDim.x; POW2: sigma is a power of two, inv_sigma 1/sigma
template <int MAX_THREADS, bool POW2>
__global__ void __launch_bounds__(MAX_THREADS)
shade_kernel(const float* __restrict__ attrs, float* __restrict__ rgb_out,
             float* __restrict__ hard_out, float* __restrict__ soft_out,
             float* __restrict__ fid_out, int* __restrict__ win_out,
             float* __restrict__ m_out, int K, int tiles_x, int tile_h, int tile_w,
             int tile0, float sigma, float inv_sigma, bool blocked) {
  extern __shared__ float4 smem[];
  Row* rows = reinterpret_cast<Row*>(smem);                 // [blockDim]
  float* sgn = reinterpret_cast<float*>(rows + blockDim.x); // [blockDim] sign of as
  int* vrow = reinterpret_cast<int*>(sgn + blockDim.x);     // [K] valid rows, K order
  int* wcnt = vrow + K;                                     // [32]

  const int P = tile_h * tile_w;
  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const float* a = attrs + (size_t)tile * K * LANES;

  // this thread's pixel: 8x4 blocks of pixels a warp where the tile allows
  const int g = threadIdx.x;
  int x, y;
  if (blocked) {
    const int wg = g >> 5, per_row = tile_w >> 3;
    x = (wg % per_row) * 8 + (lane & 7);
    y = (wg / per_row) * 4 + (lane >> 3);
  } else {
    x = g % tile_w;
    y = g / tile_w;
  }
  const float px = (float)(((tile0 + tile) % tiles_x) * tile_w + x) + 0.5f;
  const float py = (float)(((tile0 + tile) / tiles_x) * tile_h + y) + 0.5f;

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
    if (v) vrow[before + __popc(m & ((1u << lane) - 1u))] = r;
    nv = total;
    __syncthreads();
  }

  float best = NEG;
  int win = -1;
  float bw0 = 0.f, bw1 = 0.f, bw2 = 0.f, ww0 = 0.f, ww1 = 0.f, ww2 = 0.f;
  bool covered = false;
  float log_keep = 0.f;

  for (int base = 0; base < nv; base += blockDim.x) {
    const int n = min((int)blockDim.x, nv - base);
    __syncthreads();
    if ((int)threadIdx.x < n) {   // stage one row and its constants
      const float4* q4 =
          reinterpret_cast<const float4*>(a + (size_t)vrow[base + threadIdx.x] * LANES);
      const float4 v0 = q4[0], v1 = q4[1];
      const float iw2 = reinterpret_cast<const float*>(q4)[8];
      const float ax = v0.x, ay = v0.y, bx = v0.z, by = v0.w, cx = v1.x, cy = v1.y;
      const float ex0 = bx - ax, ey0 = by - ay, ex1 = cx - bx, ey1 = cy - by;
      const float ex2 = ax - cx, ey2 = ay - cy;
      const float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
      const bool live = fabsf(area) >= AREA_MIN;
      Row r;
      r.ab = v0;
      r.ce = make_float4(cx, cy, ex0, ey0);
      r.ee = make_float4(ex1, ey1, ex2, ey2);
      r.h = make_float4(keep_nan::max(ex0 * ex0 + ey0 * ey0, 1e-12f),
                        keep_nan::max(ex1 * ex1 + ey1 * ey1, 1e-12f),
                        keep_nan::max(ex2 * ex2 + ey2 * ey2, 1e-12f), live ? area : 0.f);
      // a row that is not safe never takes the shortcut (an infinite area
      // would not: e/inf may be -0; a safe row's area is finite)
      const bool safe = fabsf(ax) < SAFE && fabsf(ay) < SAFE && fabsf(bx) < SAFE &&
                        fabsf(by) < SAFE && fabsf(cx) < SAFE && fabsf(cy) < SAFE;
      r.w = make_float4(v1.z, v1.w, iw2, safe ? -SURE_NEG : -INFINITY);
      rows[threadIdx.x] = r;
      sgn[threadIdx.x] = area > 0.f ? 1.f : -1.f;
    }
    __syncthreads();
#pragma unroll UNROLL
    for (int j = 0; j < n; ++j) {
      const Row& r = rows[j];
      const float4 ab = r.ab, ce = r.ce, ee = r.ee, h = r.h;
      const float qax = px - ab.x, qay = py - ab.y;
      const float qbx = px - ab.z, qby = py - ab.w;
      const float qcx = px - ce.x, qcy = py - ce.y;
      const float as = h.w;
      bool inside = false;
      float b0 = 0.f, b1 = 0.f, b2 = 0.f;
      if (as != 0.f) {   // live: the same for every pixel of the row
        const float e0 = ee.x * qby - ee.y * qbx;   // (cx-bx)(py-by) - (cy-by)(px-bx)
        const float e1 = ee.z * qcy - ee.w * qcx;   // (ax-cx)(py-cy) - (ay-cy)(px-cx)
        const float e2 = ce.z * qay - ce.w * qax;   // (bx-ax)(py-ay) - (by-ay)(px-ax)
        const float s = sgn[j], lim = r.w.w;
        if (!(e0 * s <= lim || e1 * s <= lim || e2 * s <= lim)) {
          b0 = e0 / as; b1 = e1 / as; b2 = e2 / as;
          inside = (b0 >= 0.f) && (b1 >= 0.f) && (b2 >= 0.f);
        }
      }
      if (inside) {
        covered = true;
        const float4 w = r.w;
        const float zi = b0 * w.x + b1 * w.y + b2 * w.z;
        if (zi > best) {
          best = zi;
          win = vrow[base + j];
          bw0 = b0; bw1 = b1; bw2 = b2;
          ww0 = w.x; ww1 = w.y; ww2 = w.z;
        }
      }
      // signed distance to the nearest edge segment; edge e from corner e
      const float qx[3] = {qax, qbx, qcx}, qy[3] = {qay, qby, qcy};
      const float ex[3] = {ce.z, ee.x, ee.z}, ey[3] = {ce.w, ee.y, ee.w};
      const float hh[3] = {h.x, h.y, h.z};
      float d2min = nearest_d2<false>(qx, qy, ex, ey, hh);
      if (r.w.w == -INFINITY) d2min = nearest_d2<true>(qx, qy, ex, ey, hh);   // not safe
      const float d = sqrtf(d2min + 1e-12f);
      const float sd = inside ? -d : d;
      const float xs = POW2 ? -sd * inv_sigma : -sd / sigma;
      const float s = 1.f / (1.f + expf(-xs));
      // s is in [+0, 1] or NaN: fminf(fmaxf(s, 0), S_MAX)'s bits, NaN kept
      log_keep += log1pf(-(s > S_MAX ? S_MAX : s));
    }
  }

  if (g < P) {
    const size_t o = (size_t)tile * P + y * tile_w + x;
    float cr = 0.f, cg = 0.f, cb = 0.f, f = 0.f;
    if (win >= 0) {
      float pw0 = bw0 * ww0, pw1 = bw1 * ww1, pw2 = bw2 * ww2;
      const float norm = keep_nan::max(pw0 + pw1 + pw2, 1e-12f);
      pw0 = pw0 / norm; pw1 = pw1 / norm; pw2 = pw2 / norm;
      const float* w = a + (size_t)win * LANES;
      cr = pw0 * w[10] + pw1 * w[13] + pw2 * w[16];
      cg = pw0 * w[11] + pw1 * w[14] + pw2 * w[17];
      cb = pw0 * w[12] + pw1 * w[15] + pw2 * w[18];
      f = w[19];
    }
    rgb_out[o * 3 + 0] = cr;
    rgb_out[o * 3 + 1] = cg;
    rgb_out[o * 3 + 2] = cb;
    hard_out[o] = covered ? 1.f : 0.f;
    soft_out[o] = 1.f - expf(log_keep);
    fid_out[o] = f;
    if (win_out) {
      win_out[o] = win;
      m_out[o] = log_keep;
    }
  }
}

}  // namespace

// Every launcher takes tile0: block b of the launch is tile tile0 + b of the
// image (its pixel origin), while it reads and writes row b of the arrays.
// A rank of the multi-device step composites its own block of tiles this way.
extern "C" int takes_tile0() { return 1; }

// attrs (T,K,24) → rgb (T,P,3), hard, soft, fid (T,P) float32 and, where
// win and M are not null, the residuals win (T,P) int32 and M (T,P)
// float32; contiguous, on the device, attrs 16-byte aligned.  Launches on
// `stream`; returns cudaGetLastError() of the launch.
extern "C" int shade_tiles_launch(const float* attrs, float* rgb, float* hard,
                                  float* soft, float* fid, int* win, float* M,
                                  int T, int K,
                                  int tiles_x, int tile_h, int tile_w, int tile0,
                                  float sigma, void* stream) {
  const int P = tile_h * tile_w;
  if (T <= 0 || K <= 0) return 0;
  if (P <= 0 || P > 1024) return (int)cudaErrorInvalidValue;
  // one thread per pixel, in whole warps
  const int threads = (P + 31) / 32 * 32;
  const bool blocked = tile_w % 8 == 0 && tile_h % 4 == 0;
  // 1/sigma where sigma is a power of two with a normal reciprocal
  int ex = 0;
  const bool pow2 = std::frexp(sigma, &ex) == 0.5f && ex >= -124 && ex <= 126;
  const size_t smem = (size_t)threads * (sizeof(Row) + sizeof(float))
                      + ((size_t)K + 32) * sizeof(int);
  const auto kernel = threads <= 256
      ? (pow2 ? &shade_kernel<256, true> : &shade_kernel<256, false>)
      : (pow2 ? &shade_kernel<1024, true> : &shade_kernel<1024, false>);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<T, threads, smem, (cudaStream_t)stream>>>(attrs, rgb, hard, soft, fid, win, M, K,
                                                     tiles_x, tile_h, tile_w, tile0, sigma,
                                                     pow2 ? 1.f / sigma : 0.f, blocked);
  return (int)cudaGetLastError();
}
