// Cross-channel local response normalisation on NHWC tensors.
//
// Replaces the TPU kernel _lrn_kernel (cuda_mpi_gpu_cluster_programming_tpu/
// ops/pallas_kernels.py). out[c] = x[c] / (k + a * sum_{j in win(c)} x[j]^2)^beta
// with win(c) = [max(0, c - size/2), min(C - 1, c + size/2)]: the window is
// cut at the channel edges and not renormalised. `a` is alpha or alpha/size;
// the caller folds that choice in. On the TPU the window sum is a banded 0/1
// matmul, a workaround for slicing the lane axis; here each thread simply
// reads its channel neighbours.
//
// Bound on the H100: bytes (about 14 operations per element against 8 bytes
// moved in fp32). Design: one thread per element, channels fastest, so the
// 5 neighbour reads of a warp fall in the same cache lines as its own.
// All arithmetic is fp32 whatever the element type, rounded step by step
// (__fmul_rn/__fadd_rn keep nvcc from fusing into FMAs), so the plain
// PyTorch version's shifted adds give the same sums. One cast at the store.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
lrn_kernel(const T* __restrict__ x, T* __restrict__ y, long long total, int C,
           int size, float a, float beta, float k) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % C);
  const T* row = x + (i - c);
  const int half = size / 2;
  const int lo = c - half < 0 ? 0 : c - half;
  const int hi = c + half > C - 1 ? C - 1 : c + half;
  float s = 0.f;
  for (int j = lo; j <= hi; ++j) {
    const float v = port::to_f32(row[j]);
    s = __fadd_rn(s, __fmul_rn(v, v));
  }
  const float scale = __fadd_rn(k, __fmul_rn(a, s));
  y[i] = port::from_f32<T>(__fdiv_rn(port::to_f32(row[c]), powf(scale, beta)));
}

template <typename T>
int launch(const void* x, void* y, long long total, int C, int size, float a,
           float beta, float k, void* stream) {
  lrn_kernel<T><<<port::blocks_for(total, THREADS), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), total, C, size, a, beta, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lrn_f32(const void* x, void* y, long long total, int C, int size,
                       float a, float beta, float k, void* stream) {
  return launch<float>(x, y, total, C, size, a, beta, k, stream);
}

extern "C" int lrn_bf16(const void* x, void* y, long long total, int C,
                        int size, float a, float beta, float k, void* stream) {
  return launch<port::bf16>(x, y, total, C, size, a, beta, k, stream);
}

// The library's one error-message entry point (shared by all three kernels).
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
