// VALID window x window / stride max-pool over a space-to-depth repack: the
// "s2d128" pool of the pool A/B (python -m <port>.pool_ab).
//
// Replaces the TPU kernel _s2d_pool_kernel behind pool_s2d128
// (scripts/pool_ab.py). Its operand is the repack the wrapper makes
// (ops/packing.py, bitwise the JAX package's _space_to_depth) after padding
// C with zeros to cp, a multiple of 128:
//   xs (N, hs, ws, s*s*cp), xs[n, a, b, (r*s + p)*cp + c] = x[n, a*s + r, b*s + p, c],
//   hs = Ho + (window-1)/s, ws = Wo + (window-1)/s.
// Tap (fy, fx) of output (i, j) is channel block ph = (fy%s)*s + fx%s of s2d
// pixel (i + fy/s, j + fx/s). On the TPU the multiple of 128 made each block a
// lane-aligned static slice; here it keeps every block's channel vectors
// 16-byte aligned, so each tap is one vector load.
//
// Bound on the H100: bytes (9 compares per output). Design: one thread per
// output pixel and 16-byte channel vector (4 fp32 or 8 bf16 lanes), channels
// fastest, one flat grid, so a warp's load of one tap covers 512 contiguous
// bytes; the taps in (fy, fx) order from tap (0, 0), each lane through
// common.cuh's max_step, so the result is bitwise maxpool2d's. The cropped C
// channels are written directly (the TPU kernel wrote cp and the host
// cropped; the values are the same): one vector store when C is a multiple of
// the vector width, else lane by lane. window and stride are runtime ints.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
maxpool_s2d_kernel(const T* __restrict__ xs, T* __restrict__ y, int N, int hs, int ws, int cp, int C,
                   int window, int s, int Ho, int Wo) {
  constexpr int VEC = sizeof(uint4) / sizeof(T);
  const int cv = (C + VEC - 1) / VEC;  // channel vectors per output pixel
  const long long total = static_cast<long long>(N) * Ho * Wo * cv;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c0 = static_cast<int>(i % cv) * VEC;
  long long r = i / cv;
  const int ox = static_cast<int>(r % Wo);
  r /= Wo;
  const int oy = static_cast<int>(r % Ho);
  const long long n = r / Ho;
  const long long depth = static_cast<long long>(s) * s * cp;  // elements per s2d pixel
  const T* base = xs + ((n * hs + oy) * ws + ox) * depth + c0;

  // lanes past C read the zero padding (c0 + VEC <= cp) and are never stored
  const uint4 first = *reinterpret_cast<const uint4*>(base);
  const T* fe = reinterpret_cast<const T*>(&first);
  T best[VEC];
  float bf[VEC];
#pragma unroll
  for (int l = 0; l < VEC; ++l) {
    best[l] = fe[l];
    bf[l] = port::to_f32(fe[l]);
  }
  for (int fy = 0; fy < window; ++fy) {
    for (int fx = 0; fx < window; ++fx) {
      const long long off = (static_cast<long long>(fy / s) * ws + fx / s) * depth +
                            static_cast<long long>((fy % s) * s + fx % s) * cp;
      const uint4 v = *reinterpret_cast<const uint4*>(base + off);
      const T* ve = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int l = 0; l < VEC; ++l) port::max_step(best[l], bf[l], ve[l]);
    }
  }

  T* out = y + ((n * Ho + oy) * Wo + ox) * C + c0;
  if (C % VEC == 0) {
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int l = 0; l < VEC; ++l) oe[l] = best[l];
    *reinterpret_cast<uint4*>(out) = o;
  } else {
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      if (c0 + l < C) out[l] = best[l];
    }
  }
}

template <typename T>
int launch(const void* xs, void* y, int N, int hs, int ws, int cp, int C, int window, int s, int Ho, int Wo,
           void* stream) {
  constexpr int VEC = sizeof(uint4) / sizeof(T);
  // the vector loads need a 16-byte aligned operand and channel blocks; the vector store an aligned output
  if (reinterpret_cast<uintptr_t>(xs) % sizeof(uint4) != 0 || cp % VEC != 0 || C > cp ||
      (C % VEC == 0 && reinterpret_cast<uintptr_t>(y) % sizeof(uint4) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(N) * Ho * Wo * ((C + VEC - 1) / VEC);
  maxpool_s2d_kernel<T><<<port::blocks_for(total, THREADS), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xs), static_cast<T*>(y), N, hs, ws, cp, C, window, s, Ho, Wo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int maxpool_s2d_f32(const void* xs, void* y, int N, int hs, int ws, int cp, int C, int window, int s,
                               int Ho, int Wo, void* stream) {
  return launch<float>(xs, y, N, hs, ws, cp, C, window, s, Ho, Wo, stream);
}

extern "C" int maxpool_s2d_bf16(const void* xs, void* y, int N, int hs, int ws, int cp, int C, int window, int s,
                                int Ho, int Wo, void* stream) {
  return launch<port::bf16>(xs, y, N, hs, ws, cp, C, window, s, Ho, Wo, stream);
}
