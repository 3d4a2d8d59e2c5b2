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
// What bounds it on the H100: bytes.  The (T,K,16) rows in and out, the
// cotangents and the forward's residuals are ~143 MB at T=2500, K=384
// (~0.043 ms at 3.35 TB/s); the operations the function needs (the
// forward's 16 a (pixel, valid row) pair, ~20 more where alpha passes its
// tests, ~34 more below its clamp; chip_smoke.py counts them on a training
// step's rows) take less at the 67 TFLOP/s float32 peak.  The time goes to
// the per-pixel walk front to back, which cannot be split across rows, and
// to the per-row sums over the tile's pixels.
//
// Design: one CTA per tile, one thread per pixel, in four steps.
//   compaction: the tile's valid rows, listed in K order (a ballot and a
//           prefix count per warp, so the list is deterministic); the rows
//           that are not valid are written 0 here, coalesced; a tile with
//           no valid row is done;
//   totals: each pixel's T_fin and sum_k u_k w_k.  In training the forward
//           kernel (composite.cu) has left each pixel's log-transmittance S
//           and its rgb (composite_bwd_res_launch): T_fin = exp(S) and the
//           total is g_rgb . rgb, the same sum in another order.  Without
//           them (composite_bwd_launch) the forward's walk over the valid
//           rows runs first, as the twin's cumsum does;
//   phase A, one thread per pixel, over a batch of RB valid rows staged in
//           shared memory: the forward's front-to-back step in log space
//           (kernel 1's formula, exp(S_i - log1p(-alpha_i)), no early
//           termination) with the running sum of u_k w_k giving suffix_i;
//           each pixel leaves, per row, d alpha e^power and w in shared
//           memory as one float2 (zeros where the pair does not pass);
//   phase B, P/RB threads per row of the batch: each sums the row's
//           gradients over RB consecutive pixels (row-major) in registers,
//           recomputing dx and dy from the pixel index and d power as
//           (d alpha e^power) o.  The mean and conic partials are linear in
//           the sums of d power times dx, dy, dx^2, dx dy and dy^2, so it
//           keeps those five and applies the row's conic once; then per row
//           and lane the P/RB partial sums are added in segment order and
//           the row leaves as four 16-byte stores.  With RB rows a batch,
//           one thread a row would leave all but RB of the P threads idle
//           while it walks P pixels (2x slower on a training step's rows).
// No shuffles, no atomics: every sum runs in a fixed order, so two launches
// give the same bits; each CTA writes only its own tile's rows.
// Built with --fmad=false, so every gate (ok, live) is decided on the same
// rounded values as the twin's separate PyTorch ops.  d power = (d alpha
// e^power) o where the twin takes d alpha (o e^power), and the conic is
// applied to the moment sums, not pair by pair: the same sums, rounded in
// another order.

#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int LANES = 16;   // row width of attrs
constexpr int ROWW = 9;     // lanes of a staged row: mean2d, conic, opacity, rgb
constexpr int NOUT = 9;     // lanes 0-8 of d_attrs carry gradient
constexpr int RB = 16;      // valid rows per batch; also pixels per phase-B segment
constexpr int PSTRIDE = RB + 1;  // per-pixel words of the pair buffers (banks)
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;

// dynamic shared memory, in 4-byte words, for K rows and P pixel threads
__host__ __device__ constexpr size_t smem_words(int K, int P) {
  return (size_t)4 * P              // g_rgb per pixel, as float4
         + (size_t)2 * P * PSTRIDE  // d alpha e^power and w per (pixel, row), float2
         + (size_t)P * NOUT         // phase B's partial sums: (P/RB) x NOUT x RB
         + RB * ROWW                // the batch's staged rows
         + (size_t)2 * K            // vrow, rowslot
         + 32;                      // per-warp counts of the compaction
}

template <int MAX_THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
composite_bwd_kernel(const float* __restrict__ attrs, const float* __restrict__ g_rgb,
                     const float* __restrict__ g_alpha, const float* __restrict__ rgb_in,
                     const float* __restrict__ s_in, float* __restrict__ d_attrs,
                     int K, int tiles_x, int tile_h, int tile_w, int tile0) {
  extern __shared__ float smem[];
  const int P = tile_h * tile_w;
  float4* gpix = reinterpret_cast<float4*>(smem);     // [P] g_rgb, 0
  float2* pdw = reinterpret_cast<float2*>(gpix + P);  // [P][PSTRIDE] (d alpha e^power, w)
  float* part = reinterpret_cast<float*>(pdw + P * PSTRIDE);  // [P/RB][NOUT][RB]
  float* rows = part + P * NOUT;                      // [RB][ROWW]
  int* vrow = reinterpret_cast<int*>(rows + RB * ROWW);  // [K] valid rows, K order
  int* rowslot = vrow + K;                            // [K] slot in vrow, or -1
  int* wcnt = rowslot + K;                            // [32]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int tile = blockIdx.x;
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
  // rows that are not valid: exactly 0
  for (int i = threadIdx.x; i < K * (LANES / 4); i += blockDim.x)
    if (rowslot[i / (LANES / 4)] < 0) d4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (nv == 0) return;

  const int p = threadIdx.x;
  const float px = (float)(ox + p % tile_w);
  const float py = (float)(oy + p / tile_w);
  const size_t o = (size_t)tile * P + p;
  const float gr = g_rgb[o * 3 + 0], gg = g_rgb[o * 3 + 1], gb = g_rgb[o * 3 + 2];
  const float ga = g_alpha[o];
  gpix[p] = make_float4(gr, gg, gb, 0.f);

  // totals: T_fin and sum_k u_k w_k, from the forward's residuals or its walk
  float S = 0.f, tot = 0.f;
  if (s_in) {
    S = s_in[o];
    tot = rgb_in[o * 3 + 0] * gr + rgb_in[o * 3 + 1] * gg + rgb_in[o * 3 + 2] * gb;
  }
  for (int base = 0; !s_in && base < nv; base += RB) {
    const int n = min(RB, nv - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * ROWW; i += blockDim.x) {
      const int row = i / ROWW, ln = i - row * ROWW;
      rows[i] = a[(size_t)vrow[base + row] * LANES + ln];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* q = rows + j * ROWW;
      const float dx = q[0] - px;
      const float dy = q[1] - py;
      const float power = -0.5f * (q[2] * dx * dx + q[4] * dy * dy) - q[3] * dx * dy;
      const float raw = q[5] * expf(power);
      const float al = raw > ALPHA_MAX ? ALPHA_MAX : raw;   // a NaN stays NaN and fails
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

  // the batches of valid rows: phase A per pixel, phase B per row
  const int seg = threadIdx.x / RB, r_own = threadIdx.x % RB;   // phase B's share
  S = 0.f;
  float inc = 0.f;
  __syncthreads();   // the walk above is done with `rows`
  for (int base = 0; base < nv; base += RB) {
    const int n = min(RB, nv - base);
    // `rows` was last read by the previous batch's phase B, before its
    // barrier; `part` is written again only after this batch's next two
    for (int i = threadIdx.x; i < n * ROWW; i += blockDim.x) {
      const int row = i / ROWW, ln = i - row * ROWW;
      rows[i] = a[(size_t)vrow[base + row] * LANES + ln];
    }
    __syncthreads();
    // phase A: this pixel's step through the batch's rows, front to back
    float2* my_dw = pdw + p * PSTRIDE;
    for (int j = 0; j < n; ++j) {
      const float* q = rows + j * ROWW;
      const float dx = q[0] - px;
      const float dy = q[1] - py;
      const float power = -0.5f * (q[2] * dx * dx + q[4] * dy * dy) - q[3] * dx * dy;
      const float expp = expf(power);
      const float raw = q[5] * expp;
      const float al = raw > ALPHA_MAX ? ALPHA_MAX : raw;
      float de = 0.f, w = 0.f;
      if ((power <= 0.f) && (al >= ALPHA_MIN)) {
        const float l = log1pf(-al);
        const float incl = S + l;
        const float trans = expf(incl - l);
        w = al * trans;
        const float u = q[6] * gr + q[7] * gg + q[8] * gb;
        inc += u * w;
        if (raw < ALPHA_MAX) {
          const float suffix = tot - inc;
          const float d_al = u * trans - (suffix - ga * t_fin) / (1.f - al);
          de = d_al * expp;
        }
        S = incl;
      }
      my_dw[j] = make_float2(de, w);
    }
    __syncthreads();
    // phase B: row r_own's nine sums over the pixels of segment `seg`
    if (r_own < n) {
      const float* q = rows + r_own * ROWW;
      const float mx = q[0], my = q[1], ca = q[2], cb = q[3], cc = q[4], op = q[5];
      // sums of d power times dx, dy and their products: the six partials
      // are linear in them (v0 = -(ca sum dp dx + cb sum dp dy), ...)
      float m1 = 0.f, m2 = 0.f, m3 = 0.f, m4 = 0.f, m5 = 0.f;
      float acc[NOUT];
#pragma unroll
      for (int c = 0; c < NOUT; ++c) acc[c] = 0.f;
      const int p0 = seg * RB;
      int xx = p0 % tile_w, yy = p0 / tile_w;
      float fx = (float)(ox + xx);
      float dy = my - (float)(oy + yy);
      for (int k = 0; k < RB; ++k) {
        const int pp = p0 + k;
        const float2 dw = pdw[pp * PSTRIDE + r_own];
        const float4 g = gpix[pp];
        const float dx = mx - fx;
        const float d_pow = dw.x * op;
        const float ax = d_pow * dx, ay = d_pow * dy;
        m1 += ax;
        m2 += ay;
        m3 += ax * dx;
        m4 += ax * dy;
        m5 += ay * dy;
        acc[5] += dw.x;
        acc[6] += dw.y * g.x;
        acc[7] += dw.y * g.y;
        acc[8] += dw.y * g.z;
        fx += 1.f;
        if (++xx == tile_w) {
          xx = 0;
          ++yy;
          fx = (float)ox;
          dy = my - (float)(oy + yy);
        }
      }
      acc[0] = -(ca * m1 + cb * m2);
      acc[1] = -(cc * m2 + cb * m1);
      acc[2] = -0.5f * m3;
      acc[3] = -m4;
      acc[4] = -0.5f * m5;
      // a row with a mean, conic or opacity that is not finite has no pair
      // below the clamp (its power or o e^power is NaN or infinite), so its
      // d power is 0 at every pixel, as in the twin; the sums above took
      // 0 times NaN or inf there
      if (!(isfinite(mx) && isfinite(my) && isfinite(ca) && isfinite(cb) && isfinite(cc)
            && isfinite(op)))
        acc[0] = acc[1] = acc[2] = acc[3] = acc[4] = 0.f;
#pragma unroll
      for (int c = 0; c < NOUT; ++c) part[(seg * NOUT + c) * RB + r_own] = acc[c];
    }
    __syncthreads();
    // the batch's rows leave as whole 16-byte stores: lane c of row r is the
    // sum of its segments' partials in segment order; lanes 9-15 are 0
    const int nseg = blockDim.x / RB;
    for (int i = threadIdx.x; i < n * (LANES / 4); i += blockDim.x) {
      const int r = i / (LANES / 4), q4 = i - r * (LANES / 4);
      float out[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = q4 * 4 + k;
        float s = 0.f;
        if (c < NOUT)
          for (int sg = 0; sg < nseg; ++sg) s += part[(sg * NOUT + c) * RB + r];
        out[k] = s;
      }
      d4[(size_t)vrow[base + r] * (LANES / 4) + q4] = make_float4(out[0], out[1], out[2], out[3]);
    }
  }
}

template <int MAX_THREADS, int MIN_BLOCKS>
int run(const float* attrs, const float* g_rgb, const float* g_alpha, const float* rgb,
        const float* S, float* d_attrs, int T, int K, int tiles_x, int tile_h, int tile_w,
        int tile0, void* stream) {
  const auto kernel = composite_bwd_kernel<MAX_THREADS, MIN_BLOCKS>;
  const size_t smem = smem_words(K, tile_h * tile_w) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<T, tile_h * tile_w, smem, (cudaStream_t)stream>>>(
      attrs, g_rgb, g_alpha, rgb, S, d_attrs, K, tiles_x, tile_h, tile_w, tile0);
  return (int)cudaGetLastError();
}

// 16x16 tiles (P = 256, every shipped config) run with at most 64 registers
// a thread, so four CTAs (51 KB of shared memory each at K = 384) fit on an
// SM; larger tiles get one CTA of up to 1024 threads
int launch(const float* attrs, const float* g_rgb, const float* g_alpha, const float* rgb,
           const float* S, float* d_attrs, int T, int K, int tiles_x, int tile_h,
           int tile_w, int tile0, void* stream) {
  const int P = tile_h * tile_w;
  if (T <= 0 || K <= 0) return 0;
  if (P <= 0 || P > 1024 || P % 32 != 0) return (int)cudaErrorInvalidValue;
  return P <= 256 ? run<256, 4>(attrs, g_rgb, g_alpha, rgb, S, d_attrs, T, K, tiles_x,
                                tile_h, tile_w, tile0, stream)
                  : run<1024, 1>(attrs, g_rgb, g_alpha, rgb, S, d_attrs, T, K, tiles_x,
                                 tile_h, tile_w, tile0, stream);
}

}  // namespace

// Every launcher takes tile0: block b of the launch is tile tile0 + b of the
// image (its pixel origin), while it reads and writes row b of the arrays.
// A rank of the multi-device step composites its own block of tiles this way.
extern "C" int takes_tile0() { return 1; }

// attrs (T,K,16), g_rgb (T,P,3), g_alpha (T,P) → d_attrs (T,K,16); all
// float32, contiguous, on the device; P = tile_h*tile_w a multiple of 32, at
// most 1024.  Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int composite_bwd_launch(const float* attrs, const float* g_rgb,
                                    const float* g_alpha, float* d_attrs, int T,
                                    int K, int tiles_x, int tile_h, int tile_w,
                                    int tile0, void* stream) {
  return launch(attrs, g_rgb, g_alpha, nullptr, nullptr, d_attrs, T, K, tiles_x, tile_h,
                tile_w, tile0, stream);
}

// The same, given the forward kernel's rgb (T,P,3) and residual S (T,P),
// each pixel's log-transmittance (composite_tiles_launch's outputs for these
// attrs), so the rows are walked once.
extern "C" int composite_bwd_res_launch(const float* attrs, const float* g_rgb,
                                        const float* g_alpha, const float* rgb,
                                        const float* S, float* d_attrs, int T, int K,
                                        int tiles_x, int tile_h, int tile_w, int tile0,
                                        void* stream) {
  return launch(attrs, g_rgb, g_alpha, rgb, S, d_attrs, T, K, tiles_x, tile_h, tile_w,
                tile0, stream);
}

// How many CTAs of the kernel that launch() picks for K rows and a
// tile_h x tile_w tile fit on one SM, by the runtime's occupancy calculator
// (registers, threads and the launch's dynamic shared memory); a CUDA error
// comes back negated.
extern "C" int composite_bwd_ctas_per_sm(int K, int tile_h, int tile_w) {
  const int P = tile_h * tile_w;
  if (K <= 0 || P <= 0 || P > 1024 || P % 32 != 0) return -(int)cudaErrorInvalidValue;
  const auto kernel = P <= 256 ? composite_bwd_kernel<256, 4> : composite_bwd_kernel<1024, 1>;
  const size_t smem = smem_words(K, P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, P, smem);
  return err == cudaSuccess ? n : -(int)err;
}
