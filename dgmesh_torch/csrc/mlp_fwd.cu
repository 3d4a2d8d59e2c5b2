// Fused MLP trunk, forward — CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel dgmesh_tpu/ops/mlp_pallas.py::_fwd_kernel
// (reached through fused_trunk / _trunk_fwd_impl).
//
// What it computes, for rows x (n, din) float32, din <= 256, read as if
// zero-padded to 256 lanes and rounded to bf16 (nearest even):
//   h_0 = x;  for layer i = 0..7:
//     y   = h_i · W[i]  (+ x · W[8] at layer 5, the skip's x-part)
//     h_{i+1} = bf16(relu(y + b[i]))
//   out = h_8 as float32, (n, 256).
// wpack (9,256,256) bf16, (in,out) per layer; bpack (8,256) float32.  The
// products of bf16 operands are exact and summed in float32 (tensor-core
// mma with float32 accumulators); the bias add and ReLU are float32, then
// one rounding to bf16, as in the TPU kernel.  Only the order of the float32
// sums differs from the plain twin, so an activation may round to the
// neighbouring bf16 value now and then.
//
// What bounds it on the H100: operations.  A row costs 2·(7·256² + 2·din·256)
// flops (the padded lanes need none); at the main path's 479,966 rows and
// din 93 that is 0.49 TFLOP, 0.49 ms at the 989 TFLOP/s bf16 tensor-core
// peak, against 0.20 ms for the 670 MB of rows in and out at 3.35 TB/s.
//
// Design: one CTA of 8 warps per 128 rows keeps the rows' bf16 input and
// activation in shared memory (mlp_common.cuh) through all 8 layers, so the
// only device-memory traffic is x in, the output, and the weights streamed
// from L2 through a two-stage cp.async pipeline.  The ragged last block is
// zero-padded in shared memory and not written back.  A simple, correct
// first kernel: mma.sync, not wgmma/TMA; one CTA per SM.

#include "mlp_common.cuh"

namespace {

using namespace mlp;

constexpr size_t SMEM_BYTES = (size_t)(2 * BM * LDA + 2 * STAGE) * sizeof(bf16);

__global__ void __launch_bounds__(THREADS, 1)
mlp_fwd_kernel(const float* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ b, float* __restrict__ out, int n, int din) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);
  bf16* H = X + BM * LDA;
  bf16* stages = H + BM * LDA;
  const int row0 = blockIdx.x * BM;

  stage_x(X, x, n, din, row0);
  float acc[4][8][4];
  forward_pass(acc, X, H, stages, w, CHUNKS, [&](int layer, float (&a)[4][8][4]) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = frag_row(mt, half), col = frag_col(nt);
          const bf162 h = __floats2bfloat162_rn(
              fmaxf(a[mt][nt][2 * half] + b[layer * W + col], 0.f),
              fmaxf(a[mt][nt][2 * half + 1] + b[layer * W + col + 1], 0.f));
          if (layer < DEPTH - 1) {
            *reinterpret_cast<bf162*>(H + row * LDA + col) = h;
          } else if (row0 + row < n) {
            *reinterpret_cast<float2*>(out + (size_t)(row0 + row) * W + col) =
                make_float2(__low2float(h), __high2float(h));
          }
        }
  }, [](int) {});
}

}  // namespace

// x (n,din) f32, wpack (9,256,256) bf16, bpack (8,256) f32 → out (n,256) f32;
// contiguous, on the device.  Launches on `stream`; returns the launch's
// cudaError_t.
extern "C" int mlp_fwd_launch(const float* x, const void* wpack, const float* bpack,
                              float* out, int n, int din, void* stream) {
  if (n <= 0) return 0;
  if (din <= 0 || din > W) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  mlp_fwd_kernel<<<(n + BM - 1) / BM, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, static_cast<const bf16*>(wpack), bpack, out, n, din);
  return (int)cudaGetLastError();
}
