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
// The max itself: the rule (common.cuh takes_max, taps in (fy, fx) order from
// tap (0, 0)) costs several instructions a lane, which at 8 bf16 lanes to 16
// bytes would bound the kernel by issue rather than bytes. So each loaded
// word is turned once into order keys: a float's bits with the magnitude
// flipped where the sign is set, which as a signed integer orders every
// non-NaN value as the rule does, -0.0 below +0.0, and is its own inverse.
// Then a tap costs one integer max a fp32 lane, or one for two bf16 lanes
// (__vmaxs2 on 16-bit halves), and one min: the window's largest key is the
// rule's value bit for bit, unless the window holds a NaN (a positive NaN's
// key lies above +inf's, a negative NaN's below -inf's, so the min and max
// keys show it). Such a vector takes the rule itself on its taps read again,
// which keeps the later NaN's payload as the plain version does. So the
// result is bitwise the plain version's for every input.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BAND = 3;  // output rows a thread walks in the template instances

// Order keys of fp32 bits (one lane a word): the magnitude flipped where the sign is set.
__device__ __forceinline__ unsigned key32(unsigned b) {
  return b ^ (static_cast<unsigned>(static_cast<int>(b) >> 31) & 0x7fffffffu);
}

// Order keys of two bf16 a word, each half as key32 does on 16 bits (its own inverse too).
__device__ __forceinline__ unsigned key16x2(unsigned w) { return w ^ (((w >> 15) & 0x00010001u) * 0x7fffu); }

// A channel vector as 32-bit words: one fp32 value a word for fp32 (VEC 4 or
// 1) and for the scalar bf16 instance (the bf16 bits shifted up 16: its
// exact fp32 value), two bf16 a word for the 8-lane bf16 vector. key, kmax,
// kmin and has_nan work on the words' order keys; lane reads a value back.
template <typename T, int VEC>
struct Raw {
  static constexpr int N = VEC;  // words
  static_assert(VEC == 4 || VEC == 1, "fp32 lanes");
  static __device__ __forceinline__ void load(const T* p, unsigned (&w)[N]) {
    if constexpr (VEC == 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else if constexpr (sizeof(T) == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    } else {
      w[0] = static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16;
    }
  }
  static __device__ __forceinline__ void store(T* p, const unsigned (&w)[N]) {
    if constexpr (VEC == 4) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<unsigned*>(p) = w[0];
    } else {
      *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(w[0] >> 16);
    }
  }
  static __device__ __forceinline__ unsigned key(unsigned w) { return key32(w); }
  static __device__ __forceinline__ unsigned kmax(unsigned a, unsigned b) {
    return static_cast<unsigned>(max(static_cast<int>(a), static_cast<int>(b)));
  }
  static __device__ __forceinline__ unsigned kmin(unsigned a, unsigned b) {
    return static_cast<unsigned>(min(static_cast<int>(a), static_cast<int>(b)));
  }
  // the largest key above +inf's or the smallest below -inf's: a NaN among the taps
  static __device__ __forceinline__ bool has_nan(unsigned hi, unsigned lo) {
    return static_cast<int>(hi) > 0x7f800000 || static_cast<int>(lo) < static_cast<int>(0x807fffffu);
  }
  static __device__ __forceinline__ float lane(const unsigned (&w)[N], int l) { return __uint_as_float(w[l]); }
  static __device__ __forceinline__ void set_lanes(unsigned (&w)[N], const float (&f)[VEC]) {
#pragma unroll
    for (int l = 0; l < VEC; ++l) w[l] = __float_as_uint(f[l]);
  }
};

template <>
struct Raw<port::bf16, 8> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const port::bf16* p, unsigned (&w)[N]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
  static __device__ __forceinline__ void store(port::bf16* p, const unsigned (&w)[N]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ unsigned key(unsigned w) { return key16x2(w); }
  static __device__ __forceinline__ unsigned kmax(unsigned a, unsigned b) { return __vmaxs2(a, b); }
  static __device__ __forceinline__ unsigned kmin(unsigned a, unsigned b) { return __vmins2(a, b); }
  static __device__ __forceinline__ bool has_nan(unsigned hi, unsigned lo) {
    return static_cast<short>(hi) > 0x7f80 || static_cast<short>(hi >> 16) > 0x7f80 ||
           static_cast<short>(lo) < static_cast<short>(0x807f) || static_cast<short>(lo >> 16) < static_cast<short>(0x807f);
  }
  static __device__ __forceinline__ float lane(const unsigned (&w)[N], int l) {
    return __uint_as_float(l % 2 ? w[l / 2] & 0xffff0000u : w[l / 2] << 16);
  }
  static __device__ __forceinline__ void set_lanes(unsigned (&w)[N], const float (&f)[8]) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      w[k] = (__float_as_uint(f[2 * k]) >> 16) | (__float_as_uint(f[2 * k + 1]) & 0xffff0000u);
    }
  }
};

// The keys of a loaded vector, and back (the key is its own inverse).
template <class R, int N>
__device__ __forceinline__ void to_keys(unsigned (&w)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) w[k] = R::key(w[k]);
}

// The rule itself over a window whose top-left tap is at p (a NaN among its
// taps, so rare), stored at dst: the taps read again in (fy, fx) order from
// tap (0, 0). Out of line, so that its registers do not weigh on the rest.
template <class R, int VEC, typename T>
__device__ __noinline__ void rule_window(const T* p, size_t in_row, int C, int wh, int ww, T* dst) {
  unsigned cur[R::N];
  float best[VEC];
  R::load(p, cur);
#pragma unroll
  for (int l = 0; l < VEC; ++l) best[l] = R::lane(cur, l);
  for (int fy = 0; fy < wh; ++fy) {
    for (int fx = 0; fx < ww; ++fx) {
      R::load(p + fy * in_row + fx * C, cur);
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        const float v = R::lane(cur, l);
        if (port::takes_max(v, best[l])) best[l] = v;
      }
    }
  }
  R::set_lanes(cur, best);
  R::store(dst, cur);
}

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
        rule_window<R, VEC>(src + static_cast<size_t>(i * SH) * in_row, in_row, C, WH, WW,
                            dst + static_cast<size_t>(i) * Wo * C);
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
    rule_window<R, VEC>(src, static_cast<size_t>(W) * C, C, wh, ww, y + static_cast<size_t>(t) * VEC);
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
