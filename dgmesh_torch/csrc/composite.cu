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
// What bounds it on the H100: the per-pair arithmetic of the tiles full at
// the K cap, each warp walking its rows one after the other.  The
// (T,K,16) rows plus the outputs are ~72 MB at T=2500, K=384 (~0.021 ms at
// 3.35 TB/s).  A (pixel, valid row) pair costs 16 float32 operations for
// the alpha gate and 11 more when it passes (an exp or log1p counted as
// one): ~0.84e9 at render view 0's rows (~0.013 ms at the 67 TFLOP/s
// float32 peak).  As instructions a row's gate is ~35 a warp and its
// accumulation ~51 (the library expf and log1pf sequences), and the 450
// full tiles of view 0 hold 96% of its valid rows.  On an H100 80GB HBM3 at
// 700 W this kernel takes ~0.11 ms at view 0's rows against the 0.23 ms of
// the design before it (every slot staged and walked by every pixel);
// PERF.md has the parts' worth.
//
// Design: one CTA per tile, one thread per pixel, each warp an 8x4 block
// of pixels where the tile allows (else row-major pixels; a last warp may
// be partial).
//   compaction: the tile's valid rows, listed in K order (a ballot and a
//           prefix count per warp, so the list is deterministic); a tile
//           with none walks nothing and writes rgb 0, alpha 0 and S 0;
//   staging: batches of blockDim valid rows, one thread per row: lanes 0-8
//           as two float4 loads and one float, and the row's gate box
//           (below), into shared memory;
//   walk:   each warp lists, 32 rows at a time (a ballot), the staged rows
//           whose gate box meets its block of pixels, and walks them front
//           to back two an iteration: both rows' gates, then each row's
//           step, applied where its gate passes; S and the rgb sum stay in
//           registers.  A row the warp does not list, or whose alpha is
//           zeroed, leaves S and rgb unchanged (log1p(-0) = 0), so every
//           output is the bits of the straightforward walk: the pair's
//           operations are those of the reference, in its order.
// More CTAs an SM were slower (registers capped for 5, 6 or 8), as were
// fewer (3 or 2), four rows an iteration and batches of 2 x blockDim rows.
// The gate box: an axis-aligned box, in pixel coordinates, that holds every
// pixel where the float32 gate can pass (o e^power >= 1/255 as rounded
// here).  With the conic [[a, b], [b, c]] positive definite and
// |b| <= (1 - 2^-10) sqrt(ac), the rounded power is at most
// -(1/2 - 2^-12) Q(d) (Q the conic's quadratic form of the rounded offset
// d): the eight roundings of its operations are each within 2^-24, and
// a dx^2 + c dy^2 <= 2^10 Q.  So a pixel passes only where
// Q(d) <= R2 = (ln(o / (1/255)) + 2^-20) / (1/2 - 2^-11), the 2^-20 for
// expf's 2 ulp, the product's rounding and underflow; and Q(d) <= R2 keeps
// |dx| <= sqrt(R2 c / det) and |dy| <= sqrt(R2 a / det).  The box is
// computed in double with outward rounding, then rounded outward to float;
// o <= 0 or below 1/255 by more than the margin gives an empty box.  A row
// with a mean, conic or opacity that is not finite, a conic not so
// conditioned, or o > 2^20 (where e^power may underflow) gets an unbounded
// box: its pairs all take the gate.
// Built with --fmad=false, so every operation rounds like the plain
// PyTorch twin's.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int LANES = 16;   // row width of attrs
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr double RHO2_MAX = (1.0 - 0x1p-10) * (1.0 - 0x1p-10);  // exact in double
constexpr double GATE_SLACK = 0x1p-20;  // expf's 2 ulp, o * e's rounding, underflow
constexpr double HALF_LESS = 0.5 - 0x1p-11;  // below 1/2 - 2^-12, the power's bound
constexpr float O_MAX = 1048576.0f;     // 2^20

// a staged row: four float4 of shared memory
struct Row {
  float4 mc;   // mean x, y; conic a, b
  float4 co;   // conic c, opacity, red, green
  float4 bl;   // blue (y, z, w unused)
  float4 box;  // gate box: x from, x to, y from, y to
};

// the box of pixels where the row's gate can pass (design note above)
__device__ float4 gate_box(float mx, float my, float ca, float cb, float cc, float o) {
  const float4 all = make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
  const float4 none = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
  if (!(isfinite(mx) && isfinite(my) && isfinite(ca) && isfinite(cb) && isfinite(cc)
        && isfinite(o)))
    return all;
  if (o <= 0.f) return none;   // o e^power <= 0: the gate fails everywhere
  if (o > O_MAX || !(ca > 0.f && cc > 0.f)) return all;
  const double a = ca, b = cb, c = cc;
  const double ac = a * c, bb = b * b;                  // both exact
  if (!(bb <= __dmul_rd(RHO2_MAX, ac))) return all;     // |b| <= (1 - 2^-10) sqrt(ac)
  const double lead = __dadd_ru(log((double)o / (double)ALPHA_MIN), GATE_SLACK);
  if (lead < 0.0) return none;
  const double r2 = __ddiv_ru(lead, HALF_LESS);
  const double det = __dsub_rd(ac, bb);                 // > 0
  const double hx = __dsqrt_ru(__dmul_ru(r2, __ddiv_ru(c, det)));
  const double hy = __dsqrt_ru(__dmul_ru(r2, __ddiv_ru(a, det)));
  // the offset is rounded once (a factor within 1 +- 2^-24) before the
  // power sees it: widen by 2^-20 of the half-width and 2^-20 of a pixel
  const double ex = __dadd_ru(__dmul_ru(hx, 1.0 + 0x1p-20), 0x1p-20);
  const double ey = __dadd_ru(__dmul_ru(hy, 1.0 + 0x1p-20), 0x1p-20);
  return make_float4(__double2float_rd(__dsub_rd(mx, ex)), __double2float_ru(__dadd_ru(mx, ex)),
                     __double2float_rd(__dsub_rd(my, ey)), __double2float_ru(__dadd_ru(my, ey)));
}

// a (pixel, row) pair past the gate: alpha, the row's colour, and whether
// the gate passes
struct Pair {
  float al, cr, cg, cb;
  bool pass;
};

// the reference's gate, its operations in its order
__device__ __forceinline__ Pair gate(const Row& q, float px, float py) {
  const float4 mc = q.mc, co = q.co;
  const float dx = mc.x - px;
  const float dy = mc.y - py;
  const float power = -0.5f * (mc.z * dx * dx + co.x * dy * dy) - mc.w * dx * dy;
  const float raw = co.y * expf(power);
  const float al = raw > ALPHA_MAX ? ALPHA_MAX : raw;   // a NaN stays NaN and fails
  return {al, co.z, co.w, q.bl.x, (power <= 0.f) && (al >= ALPHA_MIN)};
}

// the reference's front-to-back step where the pair passes; S and the rgb
// sum are kept as they are where it does not
__device__ __forceinline__ void accumulate(const Pair& p, float& S, float& r, float& g,
                                           float& b) {
  const float l = log1pf(-p.al);
  const float incl = S + l;
  const float w = p.al * expf(incl - l);
  if (p.pass) {
    r += w * p.cr;
    g += w * p.cg;
    b += w * p.cb;
    S = incl;
  }
}

// MAX_THREADS >= blockDim.x
template <int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
composite_kernel(const float* __restrict__ attrs, float* __restrict__ rgb_out,
                 float* __restrict__ alpha_out, float* __restrict__ s_out,
                 int K, int tiles_x, int tile_h, int tile_w, int tile0, bool blocked) {
  extern __shared__ float4 smem[];
  Row* rows = reinterpret_cast<Row*>(smem);              // [blockDim]
  int* vrow = reinterpret_cast<int*>(rows + blockDim.x);  // [K] valid rows, K order
  int* wcnt = vrow + K;                                   // [32]

  const int P = tile_h * tile_w;
  const int tile = blockIdx.x;
  const int g = threadIdx.x;
  const int warp = g >> 5, lane = g & 31;
  const int nwarps = blockDim.x >> 5;
  const float* a = attrs + (size_t)tile * K * LANES;

  // this thread's pixel: 8x4 blocks of pixels a warp where the tile allows
  int x, y;
  if (blocked) {
    const int per_row = tile_w >> 3;
    x = (warp % per_row) * 8 + (lane & 7);
    y = (warp / per_row) * 4 + (lane >> 3);
  } else {
    x = g % tile_w;
    y = g / tile_w;
  }
  const int ox = ((tile0 + tile) % tiles_x) * tile_w, oy = ((tile0 + tile) / tiles_x) * tile_h;
  const float px = (float)(ox + x);
  const float py = (float)(oy + y);
  // the warp's block: the bounding box of its lanes' pixels
  const bool has = g < P;
  const float wx0 = (float)(ox + __reduce_min_sync(0xffffffffu, has ? x : INT_MAX));
  const float wx1 = (float)(ox + __reduce_max_sync(0xffffffffu, has ? x : INT_MIN));
  const float wy0 = (float)(oy + __reduce_min_sync(0xffffffffu, has ? y : INT_MAX));
  const float wy1 = (float)(oy + __reduce_max_sync(0xffffffffu, has ? y : INT_MIN));

  // compaction: the valid rows in K order
  int nv = 0;
  for (int base = 0; base < K; base += blockDim.x) {
    const int k = base + g;
    const bool v = k < K && a[(size_t)k * LANES + 9] > 0.5f;
    const unsigned m = __ballot_sync(0xffffffffu, v);
    if (lane == 0) wcnt[warp] = __popc(m);
    __syncthreads();
    int before = nv, total = nv;
    for (int w = 0; w < nwarps; ++w) {
      before += w < warp ? wcnt[w] : 0;
      total += wcnt[w];
    }
    if (v) vrow[before + __popc(m & ((1u << lane) - 1u))] = k;
    nv = total;
    __syncthreads();
  }

  float S = 0.f, r = 0.f, gr = 0.f, b = 0.f;
  for (int base = 0; base < nv; base += blockDim.x) {
    const int n = min((int)blockDim.x, nv - base);
    __syncthreads();
    if (g < n) {   // stage one row and its gate box
      const float4* q4 = reinterpret_cast<const float4*>(a + (size_t)vrow[base + g] * LANES);
      const float4 u = q4[0], v = q4[1];
      const float blue = reinterpret_cast<const float*>(q4)[8];
      Row row;
      row.mc = u;
      row.co = v;
      row.bl = make_float4(blue, 0.f, 0.f, 0.f);
      row.box = gate_box(u.x, u.y, u.z, u.w, v.x, v.y);
      rows[g] = row;
    }
    __syncthreads();
    for (int c = 0; c < n; c += 32) {
      // the warp's rows of these 32: those whose gate box meets its block
      bool meets = false;
      if (c + lane < n) {
        const float4 box = rows[c + lane].box;
        meets = !(wx1 < box.x || wx0 > box.y || wy1 < box.z || wy0 > box.w);
      }
      unsigned m = __ballot_sync(0xffffffffu, meets);
      while (m) {   // two rows an iteration (the second may be none)
        const int j0 = c + __ffs(m) - 1;
        m &= m - 1u;
        const bool two = m != 0u;
        const int j1 = two ? c + __ffs(m) - 1 : j0;
        m &= m - 1u;
        Pair p0 = gate(rows[j0], px, py), p1 = gate(rows[j1], px, py);
        p1.pass = p1.pass && two;
        accumulate(p0, S, r, gr, b);
        accumulate(p1, S, r, gr, b);
      }
    }
  }
  if (has) {
    const size_t o = (size_t)tile * P + y * tile_w + x;
    rgb_out[o * 3 + 0] = r;
    rgb_out[o * 3 + 1] = gr;
    rgb_out[o * 3 + 2] = b;
    alpha_out[o] = 1.f - expf(S);
    if (s_out) s_out[o] = S;
  }
}

}  // namespace

// Every launcher takes tile0: block b of the launch is tile tile0 + b of the
// image (its pixel origin), while it reads and writes row b of the arrays.
// A rank of the multi-device step composites its own block of tiles this way.
extern "C" int takes_tile0() { return 1; }

// attrs (T,K,16) → rgb (T,P,3), alpha (T,P) and, where S is not null, each
// pixel's log-transmittance S (T,P); all float32, contiguous, on the device,
// attrs 16-byte aligned.  Launches on `stream`; returns cudaGetLastError()
// of the launch.
extern "C" int composite_tiles_launch(const float* attrs, float* rgb, float* alpha,
                                      float* S, int T, int K, int tiles_x, int tile_h,
                                      int tile_w, int tile0, void* stream) {
  const int P = tile_h * tile_w;
  if (T <= 0 || K <= 0) return 0;
  if (P <= 0 || P > 1024) return (int)cudaErrorInvalidValue;
  // one thread per pixel, in whole warps
  const int threads = (P + 31) / 32 * 32;
  const bool blocked = tile_w % 8 == 0 && tile_h % 4 == 0;
  const size_t smem = (size_t)threads * sizeof(Row) + ((size_t)K + 32) * sizeof(int);
  const auto kernel = threads <= 256 ? &composite_kernel<256> : &composite_kernel<1024>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<T, threads, smem, (cudaStream_t)stream>>>(attrs, rgb, alpha, S, K, tiles_x, tile_h,
                                                     tile_w, tile0, blocked);
  return (int)cudaGetLastError();
}
