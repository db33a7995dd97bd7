// Shared helpers for the port's kernels: fp32/bf16 load and store.
//
// Every kernel computes in fp32 and touches its element type only at the
// load (to_f32) and at the single store (from_f32). __float2bfloat16 rounds
// to nearest even, as JAX's astype(bfloat16) does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace port {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

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

inline int blocks_for(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

}  // namespace port
