// Gaussian splat tile compositing, forward — CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel dgmesh_tpu/ops/splat_pallas.py::_composite_kernel
// (reached through composite_tiles_pallas / make_composite_tiles).
//
// What it computes, per 16x16 tile and its K depth-sorted Gaussian rows
// (attrs (T,K,16) float32: 0,1 mean2d | 2-4 conic | 5 opacity | 6-8 rgb |
// 9 valid | 10-15 padding):
//   alpha_i = min(0.99, o_i * exp(power_i)), kept where power_i <= 0,
//             alpha_i >= 1/255 and the row is valid (else 0);
//   T_i     = exp(S_i - log1p(-alpha_i)), S_i = sum_{j<=i} log1p(-alpha_j)
//             (the reference's log-space exclusive transmittance);
//   rgb     = sum_i alpha_i T_i c_i,   alpha = 1 - exp(S_K);
// and, when asked (a non-null S), S_K itself: the backward kernel
// (composite_bwd.cu) takes T_fin = exp(S_K) and, with rgb, the pixel's
// total sum_i u_i w_i = g_rgb . rgb from it instead of walking the rows
// once more.
// Pixel centres are integer (splat convention).  There is no early
// termination: the JAX reference has none, and parity depends on it.  The
// background blend stays outside (dgmesh_torch/ops/splat.py::composite).
//
// What bounds it on the H100: memory traffic at the main path's rows, and
// operations as tiles fill.  The (T,K,16) rows plus the outputs are ~72 MB
// at T=2500, K=384 (~0.021 ms at 3.35 TB/s).  Each (pixel, valid row) pair
// costs 16 float32 operations for the alpha test and 11 more when it passes
// (an exp or log1p counted as one); with ~19% of the K slots valid that is
// ~0.8e9 operations (~0.013 ms at the 67 TFLOP/s float32 peak), and with
// every slot valid it would be ~7e9 (~0.1 ms).
//
// Design: one CTA per tile, one thread per pixel.  Rows are staged in shared
// memory in batches of blockDim rows (10 of the 16 lanes each), so every row
// is read from device memory once and broadcast to the 256 pixel threads;
// each thread walks its rows front to back keeping S and the rgb sum in
// registers.  A row that is invalid or whose alpha is zeroed leaves S and rgb
// unchanged (log1p(-0) = 0), so the loop skips it — the result is the same
// as the reference's, bit for bit in the arithmetic that remains.
// A simple, correct first kernel: no tensor cores, no TMA; tuning comes later.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 16;   // row width of attrs
constexpr int USED = 10;    // lanes read by the kernel
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;

__global__ void composite_kernel(const float* __restrict__ attrs,
                                 float* __restrict__ rgb_out,
                                 float* __restrict__ alpha_out,
                                 float* __restrict__ s_out,
                                 int K, int tiles_x, int tile_h, int tile_w) {
  extern __shared__ float rows[];  // [blockDim.x][USED]
  const int tile = blockIdx.x;
  const int P = tile_h * tile_w;
  const int p = threadIdx.x;       // pixel, row-major within the tile
  const float px = (float)((tile % tiles_x) * tile_w + p % tile_w);
  const float py = (float)((tile / tiles_x) * tile_h + p / tile_w);
  const float* a = attrs + (size_t)tile * K * LANES;

  float S = 0.f, r = 0.f, g = 0.f, b = 0.f;
  for (int base = 0; base < K; base += blockDim.x) {
    const int n = min((int)blockDim.x, K - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * USED; i += blockDim.x) {
      const int row = i / USED, lane = i - row * USED;
      rows[i] = a[(size_t)(base + row) * LANES + lane];
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
      r += w * q[6];
      g += w * q[7];
      b += w * q[8];
      S = incl;
    }
  }
  if (p < P) {
    const size_t o = (size_t)tile * P + p;
    rgb_out[o * 3 + 0] = r;
    rgb_out[o * 3 + 1] = g;
    rgb_out[o * 3 + 2] = b;
    alpha_out[o] = 1.f - expf(S);
    if (s_out) s_out[o] = S;
  }
}

}  // namespace

// attrs (T,K,16) → rgb (T,P,3), alpha (T,P) and, where S is not null, each
// pixel's log-transmittance S (T,P); all float32, contiguous, on the device.
// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int composite_tiles_launch(const float* attrs, float* rgb, float* alpha,
                                      float* S, int T, int K, int tiles_x, int tile_h,
                                      int tile_w, void* stream) {
  const int P = tile_h * tile_w;
  if (T <= 0 || K <= 0) return 0;
  if (P <= 0 || P > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)P * USED * sizeof(float);
  composite_kernel<<<T, P, smem, (cudaStream_t)stream>>>(attrs, rgb, alpha, S, K,
                                                         tiles_x, tile_h, tile_w);
  return (int)cudaGetLastError();
}
