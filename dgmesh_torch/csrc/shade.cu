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
// What bounds it on the H100: operations.  Each (pixel, valid face) pair
// costs about 118 float32 operations, three divisions, a square root, an exp
// and a log1p among them (each counted as one).  At the main path's
// T=2500, K=512, P=256 with ~17% of the K slots valid that is ~6.4e9
// operations (~0.1 ms at 67 TFLOP/s float32), against ~138 MB of traffic
// (~0.04 ms at 3.35 TB/s).
//
// Design: one CTA per tile, one thread per pixel; faces are staged in shared
// memory in batches of blockDim rows (20 of the 24 lanes) and broadcast to
// every pixel thread.  Each thread keeps its z-buffer winner (strictly
// greater 1/w wins, so the first maximum in K order is kept, as the
// reference's `ismax & cnt < 1.5` does) and the winner's barycentrics and
// 1/w in registers, and reads the winner's colours and face id from device
// memory once at the end.  Invalid rows contribute nothing to any output, so
// the loop skips them.  Built with --fmad=false so every operation rounds
// like the plain PyTorch twin's, and winners agree with it exactly.
// A simple, correct first kernel; tuning comes later.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 24;   // row width of attrs
constexpr int USED = 20;    // lanes read by the kernel
constexpr float AREA_MIN = 1e-4f;
constexpr float NEG = -3.0e38f;
constexpr float S_MAX = 0.999999f;  // 1 - 1e-6 in float32

__global__ void shade_kernel(const float* __restrict__ attrs,
                             float* __restrict__ rgb_out,
                             float* __restrict__ hard_out,
                             float* __restrict__ soft_out,
                             float* __restrict__ fid_out,
                             int* __restrict__ win_out,
                             float* __restrict__ m_out,
                             int K, int tiles_x, int tile_h, int tile_w,
                             float sigma) {
  extern __shared__ float rows[];  // [blockDim.x][USED]
  const int tile = blockIdx.x;
  const int P = tile_h * tile_w;
  const int p = threadIdx.x;
  const float px = (float)((tile % tiles_x) * tile_w + p % tile_w) + 0.5f;
  const float py = (float)((tile / tiles_x) * tile_h + p / tile_w) + 0.5f;
  const float* a = attrs + (size_t)tile * K * LANES;

  float best = NEG;
  int win = -1;
  float bw0 = 0.f, bw1 = 0.f, bw2 = 0.f, ww0 = 0.f, ww1 = 0.f, ww2 = 0.f;
  bool covered = false;
  float log_keep = 0.f;

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
        covered = true;
        const float zi = b0 * q[6] + b1 * q[7] + b2 * q[8];
        if (zi > best) {
          best = zi;
          win = base + j;
          bw0 = b0; bw1 = b1; bw2 = b2;
          ww0 = q[6]; ww1 = q[7]; ww2 = q[8];
        }
      }
      // signed distance to the nearest edge segment
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
      const float d = sqrtf(d2min + 1e-12f);
      const float sd = inside ? -d : d;
      const float x = -sd / sigma;
      const float s = 1.f / (1.f + expf(-x));
      log_keep += log1pf(-fminf(fmaxf(s, 0.f), S_MAX));
    }
  }

  if (p < P) {
    const size_t o = (size_t)tile * P + p;
    float r = 0.f, g = 0.f, b = 0.f, f = 0.f;
    if (win >= 0) {
      float pw0 = bw0 * ww0, pw1 = bw1 * ww1, pw2 = bw2 * ww2;
      const float norm = fmaxf(pw0 + pw1 + pw2, 1e-12f);
      pw0 = pw0 / norm; pw1 = pw1 / norm; pw2 = pw2 / norm;
      const float* w = a + (size_t)win * LANES;
      r = pw0 * w[10] + pw1 * w[13] + pw2 * w[16];
      g = pw0 * w[11] + pw1 * w[14] + pw2 * w[17];
      b = pw0 * w[12] + pw1 * w[15] + pw2 * w[18];
      f = w[19];
    }
    rgb_out[o * 3 + 0] = r;
    rgb_out[o * 3 + 1] = g;
    rgb_out[o * 3 + 2] = b;
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

// attrs (T,K,24) → rgb (T,P,3), hard, soft, fid (T,P) float32 and, where
// win and M are not null, the residuals win (T,P) int32 and M (T,P)
// float32; contiguous, on the device.  Launches on `stream`; returns
// cudaGetLastError() of the launch.
extern "C" int shade_tiles_launch(const float* attrs, float* rgb, float* hard,
                                  float* soft, float* fid, int* win, float* M,
                                  int T, int K,
                                  int tiles_x, int tile_h, int tile_w,
                                  float sigma, void* stream) {
  const int P = tile_h * tile_w;
  if (T <= 0 || K <= 0) return 0;
  if (P <= 0 || P > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)P * USED * sizeof(float);
  shade_kernel<<<T, P, smem, (cudaStream_t)stream>>>(attrs, rgb, hard, soft, fid, win, M,
                                                     K, tiles_x, tile_h, tile_w, sigma);
  return (int)cudaGetLastError();
}
