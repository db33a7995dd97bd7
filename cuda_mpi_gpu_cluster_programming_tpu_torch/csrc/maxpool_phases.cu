// VALID window x window / stride max-pool over a stride-phase stack: the
// "phases" pool body.
//
// Replaces the TPU kernel _pool_kernel behind _maxpool_phases
// (cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py). Its operand
// is the phase stack the wrapper packs (ops/packing.py, bitwise the JAX
// package's _pool_phases):
//   xph (s*s, N, hp, wp, C), phase r*s + p = x[:, r::s, p::s, :], cropped or
//   zero-padded to hp = Ho + (window-1)/s rows and wp = Wo + (window-1)/s
//   columns (the padding is never read).
// Tap (fy, fx) of output (oy, ox) is phase (fy%s)*s + fx%s at
// (oy + fy/s, ox + fx/s): unit-stride windows, as the TPU needed. On this
// card the stack only costs an extra pass over the input; the variant stays
// because the tuner sweeps it.
//
// Bound on the H100: bytes. Design: maxpool.cu's: one thread per output,
// channels fastest (coalesced taps), the taps in (fy, fx) order starting from
// tap (0, 0), the first of equal values kept and a NaN winning, the winning
// element stored as is. So the result is bitwise maxpool2d's.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
maxpool_phases_kernel(const T* __restrict__ xph, T* __restrict__ y, int N, int hp, int wp, int C,
                      int window, int s, int Ho, int Wo) {
  const long long total = static_cast<long long>(N) * Ho * Wo * C;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % C);
  long long r = i / C;
  const int ox = static_cast<int>(r % Wo);
  r /= Wo;
  const int oy = static_cast<int>(r % Ho);
  const long long n = r / Ho;
  const long long phase = static_cast<long long>(N) * hp * wp * C;  // elements per phase
  const T* base = xph + ((n * hp + oy) * wp + ox) * C + c;
  T best = base[0];
  float bf = port::to_f32(best);
  for (int fy = 0; fy < window; ++fy) {
    for (int fx = 0; fx < window; ++fx) {
      const T v = base[((fy % s) * s + fx % s) * phase +
                       (static_cast<long long>(fy / s) * wp + fx / s) * C];
      const float vf = port::to_f32(v);
      if (vf > bf || vf != vf) {
        best = v;
        bf = vf;
      }
    }
  }
  y[i] = best;
}

template <typename T>
int launch(const void* xph, void* y, int N, int hp, int wp, int C, int window, int s, int Ho, int Wo,
           void* stream) {
  const long long total = static_cast<long long>(N) * Ho * Wo * C;
  maxpool_phases_kernel<T><<<port::blocks_for(total, THREADS), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xph), static_cast<T*>(y), N, hp, wp, C, window, s, Ho, Wo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int maxpool_phases_f32(const void* xph, void* y, int N, int hp, int wp, int C, int window,
                                  int s, int Ho, int Wo, void* stream) {
  return launch<float>(xph, y, N, hp, wp, C, window, s, Ho, Wo, stream);
}

extern "C" int maxpool_phases_bf16(const void* xph, void* y, int N, int hp, int wp, int C, int window,
                                   int s, int Ho, int Wo, void* stream) {
  return launch<port::bf16>(xph, y, N, hp, wp, C, window, s, Ho, Wo, stream);
}
