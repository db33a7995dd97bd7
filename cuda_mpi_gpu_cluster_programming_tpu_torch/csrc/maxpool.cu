// VALID wh x ww / (sh, sw) max-pool on NHWC tensors.
//
// Replaces the TPU kernel _axis_pool_kernel (cuda_mpi_gpu_cluster_programming_tpu/
// ops/pallas_kernels.py), which the TPU runs twice per pool (an H pass, then a
// W pass after a transpose: the separable "sep2" lowering). That split was a
// layout workaround for the TPU's vector unit; here one 2-D pass computes the
// same window max. Max is exact, so the result is bitwise the same.
//
// The window is a rectangle so that the same kernel also runs the W-only
// stage (1 x window) that follows a conv whose hpool epilogue already took
// the H-axis max (the TPU's maxpool_pallas_w): the two stages give bitwise the
// 2-D pass's result.
//
// Bound on the H100: bytes (9 compares per output against 4.6 bytes moved
// per output in fp32). Design: a thread owns one 16-byte vector of channels
// (4 fp32 or 8 bf16; the VEC = 1 instance takes a C or a pointer the vectors
// do not fit) of one output column, and walks a band of BAND output rows
// down it. For the main path's windows (3x3/2, and the 1x3/(1,2) W stage) the
// window is a template, held in registers: the next output row loads only
// its new input rows (at 3x3/2, 7 of the band's 9 row loads), so each input
// vector is loaded about 1.75 times instead of 2.25, the re-reads served by
// L1. Every other window runs a runtime-window instance, one output a thread.
// Index arithmetic is 32-bit, once per thread; loads and stores are 16 bytes.
//
// The max itself: order keys, one integer max a fp32 lane or one __vmaxs2
// for two bf16 lanes, and a window that holds a NaN takes the rule on its
// taps read again (pool_keys.cuh, shared with maxpool_s2d.cu and
// maxpool_phases.cu). So the result is bitwise the plain version's for every
// input.
#include "pool_keys.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BAND = 3;  // output rows a thread walks in the template instances

// The taps of a window of a NHWC input whose tap (0, 0) is at p, for rule_window.
template <typename T>
struct GridTaps {
  const T* p;
  size_t row;
  int C;
  __device__ __forceinline__ const T* operator()(int fy, int fx) const { return p + fy * row + fx * C; }
};

// grid: one thread per (image, band of output rows, output column, channel vector), vector fastest
template <typename T, int VEC, int WH, int WW, int SH, int SW>
__global__ void __launch_bounds__(THREADS)
maxpool_band_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W, int C, int Ho, int Wo,
                    int bands, int total) {
  using R = Raw<T, VEC>;
  constexpr int N = R::N;
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int nv = C / VEC;
  const int v = t % nv;
  int r = t / nv;
  const int ox = r % Wo;
  r /= Wo;
  const int band = r % bands;
  const int n = r / bands;
  const int oy0 = band * BAND;
  const int rows = min(BAND, Ho - oy0);
  const size_t in_row = static_cast<size_t>(W) * C;
  const T* src = x + (static_cast<size_t>(n) * H + oy0 * SH) * in_row + ox * SW * C + v * VEC;
  T* dst = y + ((static_cast<size_t>(n) * Ho + oy0) * Wo + ox) * C + v * VEC;
  constexpr int KEEP = SH < WH ? WH - SH : 0;  // window rows an output row shares with the next

  // the window's keys; every index into win is a compile-time constant, so it lives in registers
  unsigned win[WH][WW][N];
#pragma unroll
  for (int i = 0; i < BAND; ++i) {
    if (i < rows) {
#pragma unroll
      for (int fy = 0; fy < KEEP; ++fy) {
#pragma unroll
        for (int fx = 0; fx < WW; ++fx) {
#pragma unroll
          for (int k = 0; k < N; ++k) {
            if (i > 0) win[fy][fx][k] = win[fy + SH][fx][k];
          }
        }
      }
#pragma unroll
      for (int fy = 0; fy < WH; ++fy) {
        if (i == 0 || fy >= KEEP) {
#pragma unroll
          for (int fx = 0; fx < WW; ++fx) {
            R::load(src + static_cast<size_t>(i * SH + fy) * in_row + fx * C, win[fy][fx]);
            to_keys<R>(win[fy][fx]);
          }
        }
      }
      unsigned out[N];
      bool any_nan = false;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        unsigned hi = win[0][0][k], lo = hi;
#pragma unroll
        for (int fy = 0; fy < WH; ++fy) {
#pragma unroll
          for (int fx = 0; fx < WW; ++fx) {
            hi = R::kmax(hi, win[fy][fx][k]);
            lo = R::kmin(lo, win[fy][fx][k]);
          }
        }
        out[k] = R::key(hi);
        any_nan |= R::has_nan(hi, lo);
      }
      if (any_nan) {
        rule_window<R, VEC>(GridTaps<T>{src + static_cast<size_t>(i * SH) * in_row, in_row, C}, WH, WW,
                            dst + static_cast<size_t>(i) * Wo * C, VEC);
      } else {
        R::store(dst + static_cast<size_t>(i) * Wo * C, out);
      }
    }
  }
}

// Any other window: one thread per (image, output row, output column, channel vector), vector fastest.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
maxpool_any_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W, int C, int wh, int ww, int sh,
                   int sw, int Ho, int Wo, int total) {
  using R = Raw<T, VEC>;
  constexpr int N = R::N;
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int nv = C / VEC;
  const int v = t % nv;
  int r = t / nv;
  const int ox = r % Wo;
  r /= Wo;
  const int oy = r % Ho;
  const int n = r / Ho;
  const T* src = x + ((static_cast<size_t>(n) * H + oy * sh) * W + ox * sw) * C + v * VEC;
  unsigned hi[N], lo[N], cur[N];
  R::load(src, hi);
  to_keys<R>(hi);
#pragma unroll
  for (int k = 0; k < N; ++k) lo[k] = hi[k];
  for (int fy = 0; fy < wh; ++fy) {
    for (int fx = 0; fx < ww; ++fx) {
      R::load(src + (static_cast<size_t>(fy) * W + fx) * C, cur);
      to_keys<R>(cur);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        hi[k] = R::kmax(hi[k], cur[k]);
        lo[k] = R::kmin(lo[k], cur[k]);
      }
    }
  }
  bool any_nan = false;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    any_nan |= R::has_nan(hi[k], lo[k]);
    hi[k] = R::key(hi[k]);
  }
  if (any_nan) {
    rule_window<R, VEC>(GridTaps<T>{src, static_cast<size_t>(W) * C, C}, wh, ww, y + static_cast<size_t>(t) * VEC, VEC);
  } else {
    R::store(y + static_cast<size_t>(t) * VEC, hi);
  }
}

template <typename T, int VEC>
int launch_vec(const void* xp, void* yp, int N, int H, int W, int C, int wh, int ww, int sh, int sw, int Ho,
               int Wo, cudaStream_t stream) {
  if (C % VEC != 0 || (VEC > 1 && !(port::aligned16(xp) && port::aligned16(yp)))) return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xp);
  T* y = static_cast<T*>(yp);
  const int bands = (Ho + BAND - 1) / BAND;
  const bool pool3 = wh == 3 && ww == 3 && sh == 2 && sw == 2;
  const bool wstage = wh == 1 && ww == 3 && sh == 1 && sw == 2;
  const long long total = static_cast<long long>(N) * (pool3 || wstage ? bands : Ho) * Wo * (C / VEC);
  if (total >= (1LL << 31)) return cudaErrorInvalidValue;  // the 32-bit thread index
  const int blocks = port::blocks_for(total, THREADS), n = static_cast<int>(total);
  if (pool3) {
    maxpool_band_kernel<T, VEC, 3, 3, 2, 2><<<blocks, THREADS, 0, stream>>>(x, y, H, W, C, Ho, Wo, bands, n);
  } else if (wstage) {
    maxpool_band_kernel<T, VEC, 1, 3, 1, 2><<<blocks, THREADS, 0, stream>>>(x, y, H, W, C, Ho, Wo, bands, n);
  } else {
    maxpool_any_kernel<T, VEC><<<blocks, THREADS, 0, stream>>>(x, y, H, W, C, wh, ww, sh, sw, Ho, Wo, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// vec: the channel-vector width the wrapper chose (ops/cuda_kernels.py vector_width): 16 / sizeof(T) or 1
template <typename T>
int launch(const void* x, void* y, int N, int H, int W, int C, int wh, int ww, int sh, int sw, int Ho, int Wo,
           int vec, void* stream) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const auto st = static_cast<cudaStream_t>(stream);
  if (vec == V) return launch_vec<T, V>(x, y, N, H, W, C, wh, ww, sh, sw, Ho, Wo, st);
  if (vec == 1) return launch_vec<T, 1>(x, y, N, H, W, C, wh, ww, sh, sw, Ho, Wo, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// A wh x ww window with strides sh (rows) and sw (columns).
extern "C" int maxpool2d_f32(const void* x, void* y, int N, int H, int W, int C, int wh, int ww, int sh, int sw,
                             int Ho, int Wo, int vec, void* stream) {
  return launch<float>(x, y, N, H, W, C, wh, ww, sh, sw, Ho, Wo, vec, stream);
}

extern "C" int maxpool2d_bf16(const void* x, void* y, int N, int H, int W, int C, int wh, int ww, int sh, int sw,
                              int Ho, int Wo, int vec, void* stream) {
  return launch<port::bf16>(x, y, N, H, W, C, wh, ww, sh, sw, Ho, Wo, vec, stream);
}
