// The max-pools' order keys, their word view of a channel vector and their
// NaN rescue, shared by maxpool.cu, maxpool_s2d.cu and maxpool_phases.cu;
// and the pool body of the two whose operand holds stride phases
// (maxpool_s2d.cu's space-to-depth repack, maxpool_phases.cu's phase stack).
//
// The rule (common.cuh takes_max, taps in (fy, fx) order from tap (0, 0))
// costs several instructions a lane, which at 8 bf16 lanes to 16 bytes
// would bound a pool by issue rather than bytes. So each loaded word is
// turned once into order keys: a float's bits with the magnitude flipped
// where the sign is set, which as a signed integer orders every non-NaN
// value as the rule does, -0.0 below +0.0, and is its own inverse. Then a
// tap costs one integer max a fp32 lane, or one for two bf16 lanes
// (__vmaxs2 on 16-bit halves), and one min: the window's largest key is the
// rule's value bit for bit, unless the window holds a NaN (a positive NaN's
// key lies above +inf's, a negative NaN's below -inf's, so the min and max
// keys show it). Such a vector takes the rule itself on its taps read again
// (rule_window, out of line), which keeps the later NaN's payload as the
// plain versions do. So a pool's result is bitwise its plain version's for
// every input.
#pragma once

#include "common.cuh"

namespace {

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

// The first `lanes` lanes of a vector stored at p: one store when that is the
// whole vector at an aligned address, else lane by lane, on the bits (so a
// NaN keeps its payload).
template <class R, int VEC, typename T>
__device__ __forceinline__ void store_lanes(T* p, const unsigned (&w)[R::N], int lanes) {
  if (lanes == VEC && (VEC == 1 || (reinterpret_cast<uintptr_t>(p) & 15) == 0)) {
    R::store(p, w);
    return;
  }
#pragma unroll
  for (int l = 0; l < VEC; ++l) {  // constant indices into w: it stays in registers
    if (l < lanes) {
      const unsigned b = __float_as_uint(R::lane(w, l));
      if constexpr (sizeof(T) == 4) {
        reinterpret_cast<unsigned*>(p)[l] = b;
      } else {
        reinterpret_cast<unsigned short*>(p)[l] = static_cast<unsigned short>(b >> 16);
      }
    }
  }
}

// The rule itself over a window whose taps taps(fy, fx) returns (a NaN among
// them, so rare), the first `lanes` lanes stored at dst: the taps read again
// in (fy, fx) order from tap (0, 0). Out of line, so that its registers do
// not weigh on the rest.
template <class R, int VEC, typename T, class Taps>
__device__ __noinline__ void rule_window(Taps taps, int wh, int ww, T* dst, int lanes) {
  unsigned cur[R::N];
  float best[VEC];
  R::load(taps(0, 0), cur);
#pragma unroll
  for (int l = 0; l < VEC; ++l) best[l] = R::lane(cur, l);
  for (int fy = 0; fy < wh; ++fy) {
    for (int fx = 0; fx < ww; ++fx) {
      R::load(taps(fy, fx), cur);
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        const float v = R::lane(cur, l);
        if (port::takes_max(v, best[l])) best[l] = v;
      }
    }
  }
  R::set_lanes(cur, best);
  store_lanes<R, VEC>(dst, cur, lanes);
}

// ------------------------------------------------------- pools over stride phases

// An operand of s*s stride phases of a NHWC input, and the pool's output.
// Tap (fy, fx) of output (oy, ox), channel c, of image n lies at
//   n*image + ((fy%s)*s + fx%s)*phase + (oy + fy/s)*row + (ox + fx/s)*col + c.
// maxpool_s2d.cu: the (N, hs, ws, s*s*cp) repack (phase: cp, col: s*s*cp,
// row: ws*col, image: hs*row), pooled into C <= cp channels; maxpool_phases.cu:
// the (s*s, N, hp, wp, C) stack (col: C, row: wp*C, image: hp*row, phase:
// N*image). Every offset fits 32 bits (the wrappers check).
struct PhaseOperand {
  int image, phase, row, col;
  int C, Ho, Wo;  // output channels, rows, columns
};

// The taps of a window whose tap (0, 0) is at p, for rule_window.
template <typename T>
struct PhaseTaps {
  const T* p;
  int s, phase, row, col;
  __device__ __forceinline__ const T* operator()(int fy, int fx) const {
    return p + ((fy % s) * s + fx % s) * phase + (fy / s) * row + (fx / s) * col;
  }
};

constexpr int PHASE_BAND = 3;  // output rows a thread walks in the template instance

// Thread t of a WIN x WIN / S pool over phases: one channel vector of VEC lanes
// (the last one of a pixel cut at C) of one output column, walking a band of
// PHASE_BAND output rows; t runs over (image, band, column, vector), vector
// fastest. The window's keys live in registers; tap (fy + S, fx) of one output
// row is tap (fy, fx) of the next, so after the first row a row loads only its
// taps with fy >= WIN - S (at 3x3/2: rows fy = 1, 2, 6 of the 9 taps, read
// from the phase rows r = 1 of its own row and r = 0 of the next).
template <typename T, int VEC, int WIN, int S>
__device__ __forceinline__ void phase_pool_band(const T* x, T* y, const PhaseOperand& g, int bands, int t) {
  using R = Raw<T, VEC>;
  constexpr int N = R::N;
  constexpr int KEEP = S < WIN ? WIN - S : 0;  // window rows an output row shares with the next
  const int nv = (g.C + VEC - 1) / VEC;
  const int v = t % nv;
  int r = t / nv;
  const int ox = r % g.Wo;
  r /= g.Wo;
  const int band = r % bands;
  const int n = r / bands;
  const int oy0 = band * PHASE_BAND;
  const int rows = min(PHASE_BAND, g.Ho - oy0);
  const int lanes = min(VEC, g.C - v * VEC);
  const T* src = x + n * g.image + oy0 * g.row + ox * g.col + v * VEC;
  T* dst = y + ((n * g.Ho + oy0) * g.Wo + ox) * g.C + v * VEC;

  unsigned win[WIN][WIN][N];  // every index a compile-time constant: registers
#pragma unroll
  for (int i = 0; i < PHASE_BAND; ++i) {
    if (i < rows) {
#pragma unroll
      for (int fy = 0; fy < KEEP; ++fy) {
#pragma unroll
        for (int fx = 0; fx < WIN; ++fx) {
#pragma unroll
          for (int k = 0; k < N; ++k) {
            if (i > 0) win[fy][fx][k] = win[fy + S][fx][k];
          }
        }
      }
#pragma unroll
      for (int fy = 0; fy < WIN; ++fy) {
        if (i == 0 || fy >= KEEP) {
#pragma unroll
          for (int fx = 0; fx < WIN; ++fx) {
            R::load(src + i * g.row + ((fy % S) * S + fx % S) * g.phase + (fy / S) * g.row + (fx / S) * g.col,
                    win[fy][fx]);
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
        for (int fy = 0; fy < WIN; ++fy) {
#pragma unroll
          for (int fx = 0; fx < WIN; ++fx) {
            hi = R::kmax(hi, win[fy][fx][k]);
            lo = R::kmin(lo, win[fy][fx][k]);
          }
        }
        out[k] = R::key(hi);
        any_nan |= R::has_nan(hi, lo);
      }
      if (any_nan) {
        rule_window<R, VEC>(PhaseTaps<T>{src + i * g.row, S, g.phase, g.row, g.col}, WIN, WIN, dst + i * g.Wo * g.C,
                            lanes);
      } else {
        store_lanes<R, VEC>(dst + i * g.Wo * g.C, out, lanes);
      }
    }
  }
}

// Thread t of any other window / stride over phases: one output and channel
// vector; t runs over (image, output row, column, vector), vector fastest.
template <typename T, int VEC>
__device__ __forceinline__ void phase_pool_any(const T* x, T* y, const PhaseOperand& g, int window, int s, int t) {
  using R = Raw<T, VEC>;
  constexpr int N = R::N;
  const int nv = (g.C + VEC - 1) / VEC;
  const int v = t % nv;
  int r = t / nv;
  const int ox = r % g.Wo;
  r /= g.Wo;
  const int oy = r % g.Ho;
  const int n = r / g.Ho;
  const int lanes = min(VEC, g.C - v * VEC);
  const PhaseTaps<T> taps{x + n * g.image + oy * g.row + ox * g.col + v * VEC, s, g.phase, g.row, g.col};
  T* dst = y + ((n * g.Ho + oy) * g.Wo + ox) * g.C + v * VEC;
  unsigned hi[N], lo[N], cur[N];
  R::load(taps(0, 0), hi);
  to_keys<R>(hi);
#pragma unroll
  for (int k = 0; k < N; ++k) lo[k] = hi[k];
  for (int fy = 0; fy < window; ++fy) {
    for (int fx = 0; fx < window; ++fx) {
      R::load(taps(fy, fx), cur);
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
    rule_window<R, VEC>(taps, window, window, dst, lanes);
  } else {
    store_lanes<R, VEC>(dst, hi, lanes);
  }
}

}  // namespace
