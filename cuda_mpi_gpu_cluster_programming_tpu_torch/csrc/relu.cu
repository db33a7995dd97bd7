// Standalone elementwise ReLU, any shape, fp32 or bf16.
//
// Replaces the inline kernel of relu_pallas (cuda_mpi_gpu_cluster_programming_tpu/
// ops/pallas_kernels.py), jnp.maximum(x, 0): NaN stays NaN with its bits,
// -0.0 becomes +0.0, everything else not above 0 becomes +0.0. fmaxf(x, 0)
// would drop the NaN, and x < 0 ? 0 : x would keep -0.0, so the test is
// written out on the bits: NaN or above 0 keeps x, else +0. The conv kernels
// fuse their ReLU; this one exists for the unfused launch sequence.
//
// Bound on the H100: bytes (one read and one write per element, no
// arithmetic to speak of). Design: one launch, a grid-stride loop over
// 16-byte chunks (4 fp32 or 8 bf16 values per load and store) when both
// pointers are 16-byte aligned, then the ragged tail element by element; an
// unaligned pointer goes element by element throughout.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // enough resident blocks to fill the card; the loop strides the rest

// On the raw bits, so that no compiler rewrites the select into a max that
// swaps a NaN's payload for the canonical one: keep x when it is NaN
// (magnitude above the infinity's) or above 0 (sign clear, magnitude not 0).
__device__ __forceinline__ float relu1(float x) {
  const unsigned u = __float_as_uint(x);
  const unsigned mag = u & 0x7fffffffu;
  return __uint_as_float(mag > 0x7f800000u || (!(u >> 31) && mag != 0u) ? u : 0u);
}

__device__ __forceinline__ port::bf16 relu1(port::bf16 x) {
  const unsigned short u = __bfloat16_as_ushort(x);
  const unsigned mag = u & 0x7fffu;
  return __ushort_as_bfloat16(mag > 0x7f80u || (!(u >> 15) && mag != 0u) ? u : static_cast<unsigned short>(0));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
relu_kernel(const T* __restrict__ x, T* __restrict__ y, long long total, long long chunks) {
  constexpr int PER = sizeof(uint4) / sizeof(T);
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (long long i = first; i < chunks; i += stride) {
    uint4 c = xv[i];
    T* e = reinterpret_cast<T*>(&c);
#pragma unroll
    for (int j = 0; j < PER; ++j) e[j] = relu1(e[j]);
    yv[i] = c;
  }
  for (long long i = chunks * PER + first; i < total; i += stride) y[i] = relu1(x[i]);
}

template <typename T>
int launch(const void* x, void* y, long long total, void* stream) {
  constexpr long long PER = sizeof(uint4) / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % sizeof(uint4) == 0;
  const long long chunks = aligned ? total / PER : 0;
  const long long tail = total - chunks * PER;
  const long long work = chunks > tail ? chunks : tail;
  const long long blocks = (work + THREADS - 1) / THREADS;
  relu_kernel<T><<<static_cast<int>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(static_cast<const T*>(x), static_cast<T*>(y), total, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int relu_f32(const void* x, void* y, long long total, void* stream) {
  return launch<float>(x, y, total, stream);
}

extern "C" int relu_bf16(const void* x, void* y, long long total, void* stream) {
  return launch<port::bf16>(x, y, total, stream);
}
