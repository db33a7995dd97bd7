// VALID window x window / stride max-pool on NHWC tensors.
//
// Replaces the TPU kernel _axis_pool_kernel (cuda_mpi_gpu_cluster_programming_tpu/
// ops/pallas_kernels.py), which the TPU runs twice per pool (an H pass, then a
// W pass after a transpose: the separable "sep2" lowering). That split was a
// layout workaround for the TPU's vector unit; here one 2-D pass computes the
// same window max. Max is exact, so the result is bitwise the same.
//
// The window is a rectangle (wh x ww taps, strides sh and sw) so that the
// same kernel also runs the W-only stage (1 x window) that follows a conv
// whose hpool epilogue already took the H-axis max (the TPU's
// maxpool_pallas_w): the two stages give bitwise the 2-D pass's result.
//
// Bound on the H100: bytes (9 compares per output against 4.6 bytes moved
// per output in fp32). Design: one thread per output element, channels
// fastest, so a warp reads 32 neighbouring channels of one input pixel per
// tap (coalesced); the 9 taps of neighbouring outputs overlap, and those
// re-reads are served by L1/L2, not device memory.
// The max propagates NaN, as jnp.maximum does (fmaxf would drop it), and
// stores the winning element itself, so bf16 needs no conversion back.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
maxpool2d_kernel(const T* __restrict__ x, T* __restrict__ y, int N, int H,
                 int W, int C, int wh, int ww, int sh, int sw, int Ho, int Wo) {
  const long long total = static_cast<long long>(N) * Ho * Wo * C;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % C);
  long long r = i / C;
  const int ox = static_cast<int>(r % Wo);
  r /= Wo;
  const int oy = static_cast<int>(r % Ho);
  const long long n = r / Ho;
  const T* base =
      x + ((n * H + static_cast<long long>(oy) * sh) * W +
           static_cast<long long>(ox) * sw) * C + c;
  T best = base[0];
  float bf = port::to_f32(best);
  for (int fy = 0; fy < wh; ++fy) {
    for (int fx = 0; fx < ww; ++fx) {
      const T v = base[(static_cast<long long>(fy) * W + fx) * C];
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
int launch(const void* x, void* y, int N, int H, int W, int C, int wh, int ww,
           int sh, int sw, int Ho, int Wo, void* stream) {
  const long long total = static_cast<long long>(N) * Ho * Wo * C;
  maxpool2d_kernel<T><<<port::blocks_for(total, THREADS), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), N, H, W, C, wh, ww, sh, sw,
      Ho, Wo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A wh x ww window with strides sh (rows) and sw (columns).
extern "C" int maxpool2d_f32(const void* x, void* y, int N, int H, int W, int C,
                             int wh, int ww, int sh, int sw, int Ho, int Wo,
                             void* stream) {
  return launch<float>(x, y, N, H, W, C, wh, ww, sh, sw, Ho, Wo, stream);
}

extern "C" int maxpool2d_bf16(const void* x, void* y, int N, int H, int W,
                              int C, int wh, int ww, int sh, int sw, int Ho,
                              int Wo, void* stream) {
  return launch<port::bf16>(x, y, N, H, W, C, wh, ww, sh, sw, Ho, Wo, stream);
}
