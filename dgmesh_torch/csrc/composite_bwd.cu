// Gaussian splat tile compositing, analytic backward — CUDA C++ for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// dgmesh_tpu/ops/splat_pallas.py::_composite_bwd_kernel (reached through
// composite_bwd_pallas / make_composite_tiles's custom_vjp).
//
// What it computes, per 16x16 tile and its K depth-sorted Gaussian rows
// (attrs (T,K,16) float32, the forward kernel's layout: 0,1 mean2d | 2-4
// conic | 5 opacity | 6-8 rgb | 9 valid), given the cotangents g_rgb (T,P,3)
// and g_alpha (T,P) of the forward's outputs:
//   dc_i  = sum_p w_i g_rgb                      (w_i = alpha_i T_i)
//   da_i  = u_i T_i - (suffix_i - g_A T_fin) / (1 - alpha_i),
//           u_i = c_i . g_rgb, suffix_i = sum_{k>i} u_k w_k
//   and da_i through alpha = o exp(power) to d mean2d, d conic, d opacity.
// da is gated by live = ok & (o exp(power) < 0.99), exactly as the Pallas
// kernel and its plain twin (ops/splat_kernels.py::composite_bwd_ref) gate
// it; rows that are not valid get exactly zero; lanes 9-15 are written 0.
//
// What bounds it on the H100: the function needs the forward's 16
// operations per (pixel, valid row) pair once, ~20 more per pair that
// passes the alpha tests (the transmittance, u, the suffix, d rgb) and ~34
// more where alpha is below its clamp (d alpha, the six partials), with
// their sums over the tile; chip_smoke.py counts these on a training
// step's rows.  This design pays the alpha tests and the transmittance
// twice, once per walk, and its shuffle trees cost 5 steps per value.  The
// bytes are the (T,K,16) rows in and out plus the cotangents: ~130 MB at
// T=2500, K=384 (~0.04 ms at 3.35 TB/s).
//
// Design: one CTA per tile, one thread per pixel, rows staged in shared
// memory in batches of RB and broadcast to the pixel threads.
//   walk 1: the forward's front-to-back loop in log space (kernel 1's
//           formula, exp(S_i - log1p(-alpha_i)), no early termination), for
//           T_fin and the pixel's total sum_k u_k w_k;
//   walk 2: the same loop again, with the running sum of u_k w_k giving
//           suffix_i = total - incl_i; each pixel forms its nine partials
//           for the row; they are summed across the tile in a fixed order
//           (xor-shuffle tree within each warp, then one partial per warp in
//           shared memory, summed in warp order).  No atomics: the result is
//           deterministic, and each tile writes only its own rows.
// Built with --fmad=false, so every gate (ok, live) is decided on the same
// rounded values as the twin's separate PyTorch ops.
// A simple, correct first kernel: no tensor cores, no TMA; tuning comes later.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 16;   // row width of attrs
constexpr int USED = 10;    // lanes read by the kernel
constexpr int NOUT = 9;     // lanes 0-8 of d_attrs carry gradient
constexpr int RB = 32;      // rows per staged batch
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void composite_bwd_kernel(const float* __restrict__ attrs,
                                     const float* __restrict__ g_rgb,
                                     const float* __restrict__ g_alpha,
                                     float* __restrict__ d_attrs,
                                     int K, int tiles_x, int tile_h, int tile_w) {
  extern __shared__ float smem[];
  float* rows = smem;                       // [RB][USED]
  float* part = smem + RB * USED;           // [RB][nwarps][NOUT]
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x;
  const int P = tile_h * tile_w;
  const int p = threadIdx.x;
  const float px = (float)((tile % tiles_x) * tile_w + p % tile_w);
  const float py = (float)((tile / tiles_x) * tile_h + p / tile_w);
  const float* a = attrs + (size_t)tile * K * LANES;
  float* d = d_attrs + (size_t)tile * K * LANES;
  const size_t o = (size_t)tile * P + p;
  const float gr = g_rgb[o * 3 + 0], gg = g_rgb[o * 3 + 1], gb = g_rgb[o * 3 + 2];
  const float ga = g_alpha[o];

  // walk 1: T_fin and the total of u_k w_k
  float S = 0.f, tot = 0.f;
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
      const float dx = q[0] - px;
      const float dy = q[1] - py;
      const float power = -0.5f * (q[2] * dx * dx + q[4] * dy * dy) - q[3] * dx * dy;
      const float al = fminf(ALPHA_MAX, q[5] * expf(power));
      if (!((power <= 0.f) && (al >= ALPHA_MIN))) continue;
      const float l = log1pf(-al);
      const float incl = S + l;
      const float w = al * expf(incl - l);
      const float u = q[6] * gr + q[7] * gg + q[8] * gb;
      tot += u * w;
      S = incl;
    }
  }
  const float t_fin = expf(S);

  // walk 2: per-row partials, reduced across the tile in a fixed order
  S = 0.f;
  float inc = 0.f;
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
      float* pw = part + (j * nwarps + warp) * NOUT;
      if (!(q[9] > 0.5f)) {                 // uniform across the block
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < NOUT; ++c) pw[c] = 0.f;
        }
        continue;
      }
      float v[NOUT];
#pragma unroll
      for (int c = 0; c < NOUT; ++c) v[c] = 0.f;
      const float dx = q[0] - px;
      const float dy = q[1] - py;
      const float power = -0.5f * (q[2] * dx * dx + q[4] * dy * dy) - q[3] * dx * dy;
      const float expp = expf(power);
      const float raw = q[5] * expp;
      const float al = fminf(ALPHA_MAX, raw);
      const bool ok = (power <= 0.f) && (al >= ALPHA_MIN);
      if (ok) {
        const float l = log1pf(-al);
        const float incl = S + l;
        const float trans = expf(incl - l);
        const float w = al * trans;
        const float u = q[6] * gr + q[7] * gg + q[8] * gb;
        inc += u * w;
        const float suffix = tot - inc;
        if (raw < ALPHA_MAX) {
          const float d_al = u * trans - (suffix - ga * t_fin) / (1.f - al);
          const float d_pow = d_al * al;
          v[0] = d_pow * (-(q[2] * dx + q[3] * dy));
          v[1] = d_pow * (-(q[4] * dy + q[3] * dx));
          v[2] = d_pow * (-0.5f * dx * dx);
          v[3] = d_pow * (-dx * dy);
          v[4] = d_pow * (-0.5f * dy * dy);
          v[5] = d_al * expp;
        }
        v[6] = w * gr;
        v[7] = w * gg;
        v[8] = w * gb;
        S = incl;
      }
      if (__any_sync(0xffffffffu, ok)) {
#pragma unroll
        for (int c = 0; c < NOUT; ++c) v[c] = warp_sum(v[c]);
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < NOUT; ++c) pw[c] = v[c];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * LANES; i += blockDim.x) {
      const int row = i / LANES, c = i - row * LANES;
      float s = 0.f;
      if (c < NOUT) {
        const float* pr = part + row * nwarps * NOUT + c;
        for (int w = 0; w < nwarps; ++w) s += pr[w * NOUT];
      }
      d[(size_t)(base + row) * LANES + c] = s;
    }
  }
}

}  // namespace

// attrs (T,K,16), g_rgb (T,P,3), g_alpha (T,P) → d_attrs (T,K,16); all
// float32, contiguous, on the device; P = tile_h*tile_w a multiple of 32, at
// most 1024.  Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int composite_bwd_launch(const float* attrs, const float* g_rgb,
                                    const float* g_alpha, float* d_attrs, int T,
                                    int K, int tiles_x, int tile_h, int tile_w,
                                    void* stream) {
  const int P = tile_h * tile_w;
  if (T <= 0 || K <= 0) return 0;
  if (P <= 0 || P > 1024 || P % 32 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(RB * USED + RB * (P / 32) * NOUT) * sizeof(float);
  composite_bwd_kernel<<<T, P, smem, (cudaStream_t)stream>>>(
      attrs, g_rgb, g_alpha, d_attrs, K, tiles_x, tile_h, tile_w);
  return (int)cudaGetLastError();
}
