// Shared pieces of the fused MLP trunk kernels (mlp_fwd.cu, mlp_bwd.cu,
// mlp_wgmma.cuh): the trunk's shape, the order in which the forward reads
// the packed matrices, and the cp.async copies.  Every product of both
// kernels runs on wgmma (mlp_wgmma.cuh).
//
// A CTA of 8 warps (two warpgroups) owns BM = 128 rows; the weights of a
// pass stream in stages of KC = 64 reduction steps.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mlp {

constexpr int W = 256;                  // trunk width
constexpr int DEPTH = 8;                // layers
constexpr int SKIP = DEPTH / 2;         // the input is concatenated into layer SKIP + 1
constexpr int BM = 128;                 // rows per CTA
constexpr int THREADS = 256;            // 8 warps, two warpgroups
constexpr int KC = 64;                  // reduction steps per pipeline stage
constexpr int CHUNKS = (W / KC) * (DEPTH + 1);   // stages of one pass over the trunk
static_assert(DEPTH == 8 && SKIP == 4, "the chunk sequences below are written for 8 layers");
static_assert(THREADS == W, "one thread per column in the bias-gradient sums");

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

// ReLU as jnp.maximum(v, 0) and torch.relu compute it: a NaN stays NaN (so
// a diverged row stays visible downstream), -0 and every v < 0 give +0.
// fmaxf(v, 0) would turn a NaN into 0.
__device__ __forceinline__ float relu(float v) { return v <= 0.f ? 0.f : v; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Matrix of wpack read by chunk group q (4 chunks each) of the forward pass:
// layers 0..5 (layer 5's h-part), then layer 5's x-part (index DEPTH), then 6, 7.
__device__ __forceinline__ int fwd_mat(int q) {
  return q <= SKIP + 1 ? q : (q == SKIP + 2 ? DEPTH : q - 1);
}

}  // namespace mlp
