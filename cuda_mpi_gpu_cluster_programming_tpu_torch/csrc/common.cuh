// Shared helpers for the port's kernels: fp32/bf16/int8 load, fp32/bf16 store,
// the pools' max rule and step.
//
// Every kernel computes in fp32 and touches its element type only at the
// load (to_f32, exact for all three types) and at the single store
// (from_f32). __float2bfloat16 rounds to nearest even, as JAX's
// astype(bfloat16) does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace port {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// The pools' max rule, jnp.maximum's: v takes over from the running best
// when it is greater, or a NaN (so a NaN propagates; fmaxf would drop it),
// or +0.0 over a best of -0.0 (JAX's max orders -0.0 below +0.0). So a
// window's value does not depend on its tap order, bar which of two NaNs'
// payloads is kept: the later tap's.
__device__ __forceinline__ bool takes_max(float v, float best) {
  return v > best || v != v || (__float_as_uint(v) == 0u && __float_as_uint(best) == 0x80000000u);
}

// One step of the pools' window max, taps taken in (fy, fx) order from tap
// (0, 0), by takes_max. The winning element itself is kept and stored, so
// bf16 needs no conversion back.
template <typename T>
__device__ __forceinline__ void max_step(T& best, float& best_f, T v) {
  const float vf = to_f32(v);
  if (takes_max(vf, best_f)) {
    best = v;
    best_f = vf;
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

inline int blocks_for(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

}  // namespace port
