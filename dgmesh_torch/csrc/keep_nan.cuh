// Clamps and a minimum that keep a NaN, as jnp.clip, jnp.maximum,
// jnp.minimum and their torch twins (torch.clamp, torch.minimum) do; fminf
// and fmaxf return the other operand and so drop it.  On every other input
// each gives fminf/fmaxf's bits.  Shared by the mesh shade kernels
// (shade.cu, shade_bwd.cu).

#pragma once

namespace keep_nan {

// max(v, lo), NaN kept
__device__ __forceinline__ float max(float v, float lo) { return v != v ? v : fmaxf(v, lo); }

// min(max(v, lo), hi), NaN kept
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// min(a, b), a NaN of either kept
__device__ __forceinline__ float min(float a, float b) {
  return (b < a || b != b) ? b : a;
}

}  // namespace keep_nan
