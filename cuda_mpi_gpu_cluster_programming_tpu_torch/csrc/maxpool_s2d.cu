// VALID window x window / stride max-pool over a space-to-depth repack: the
// "s2d128" pool of the pool A/B (python -m <port>.pool_ab), and the repack.
//
// Replaces the TPU kernel _s2d_pool_kernel behind pool_s2d128
// (scripts/pool_ab.py), and that function's pad and repack (XLA ops there).
// The operand is the TPU lowering's, which is what the A/B measures: C
// zero-padded to cp, a multiple of 128, then the repack
//   xs (N, hs, ws, s*s*cp), xs[n, a, b, (r*s + p)*cp + c] = x[n, a*s + r, b*s + p, c],
//   hs = Ho + (window-1)/s, ws = Wo + (window-1)/s,
// zero past C, H or W (ops/packing.py, bitwise the JAX package's
// _space_to_depth). Tap (fy, fx) of output (i, j) is channel block
// (fy%s)*s + fx%s of s2d pixel (i + fy/s, j + fx/s). On the TPU the multiple
// of 128 made each block a lane-aligned static slice; here it keeps every
// block's channel vectors 16-byte aligned.
//
// Bound on the H100: bytes, in both kernels.
// - s2d_pool_pack_kernel writes xs in one pass, x read once and xs written
//   once: a thread a 16-byte vector of xs (4 fp32 or 8 bf16), xs order, so
//   the stores are coalesced and the loads run along x's rows (the span of
//   xs at (n, a, b, r) is one run of s*C elements of input row a*s + r).
//   A C or a pointer the vectors do not fit takes the VEC = 1 instance.
// - The pool reads xs once from memory, the re-reads served by L1: a thread
//   owns a 16-byte channel vector of one output column and walks a band of
//   output rows (pool_keys.cuh phase_pool_band). At 3x3/2 output row i reads
//   s2d rows i and i + 1, row i + 1 only in its r = 0 blocks, which the next
//   output row reads again: a band of B rows loads 9 + 6(B - 1) vectors, not
//   9B. The max is an integer max of order keys with the NaN rescue
//   (pool_keys.cuh), so the result is bitwise the plain version's and
//   maxpool2d's. Lanes past C read the zero padding and are not stored (the
//   TPU kernel wrote cp and the host cropped; the values are the same).
//   Every other window runs a runtime-window instance, one output a thread.
#include "pool_keys.cuh"

namespace {

constexpr int THREADS = 256;

// grid: one thread per VEC elements of xs, in xs order
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
s2d_pool_pack_kernel(const T* __restrict__ x, T* __restrict__ xs, unsigned H, unsigned W, unsigned C, unsigned hs,
                     unsigned ws, unsigned s, unsigned cp, unsigned total) {
  const unsigned t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const unsigned nvp = cp / VEC;  // vectors per channel block
  const unsigned c0 = t % nvp * VEC;
  unsigned r = t / nvp;
  const unsigned ph = r % (s * s);
  r /= s * s;
  const unsigned b = r % ws;
  r /= ws;
  const unsigned a = r % hs;
  const unsigned n = r / hs;
  const unsigned row = a * s + ph / s, col = b * s + ph % s;
  const bool inside = row < H && col < W && c0 < C;  // c0 < C: the whole vector (C % VEC == 0)
  const T* src = x + ((n * H + row) * W + col) * C + c0;
  if constexpr (VEC > 1) {
    reinterpret_cast<uint4*>(xs)[t] = inside ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0, 0, 0, 0);
  } else if constexpr (sizeof(T) == 4) {
    reinterpret_cast<unsigned*>(xs)[t] = inside ? __ldg(reinterpret_cast<const unsigned*>(src)) : 0u;
  } else {
    reinterpret_cast<unsigned short*>(xs)[t] =
        inside ? __ldg(reinterpret_cast<const unsigned short*>(src)) : static_cast<unsigned short>(0);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
maxpool_s2d_band_kernel(const T* __restrict__ xs, T* __restrict__ y, PhaseOperand g, int bands, int total) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t < total) phase_pool_band<T, VEC, 3, 2>(xs, y, g, bands, t);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
maxpool_s2d_any_kernel(const T* __restrict__ xs, T* __restrict__ y, PhaseOperand g, int window, int s, int total) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t < total) phase_pool_any<T, VEC>(xs, y, g, window, s, t);
}

template <typename T, int VEC>
int pack_vec(const void* x, void* xs, int N, int H, int W, int C, int hs, int ws, int s, int cp,
             cudaStream_t stream) {
  if (cp % VEC != 0 || C > cp || (VEC > 1 && (C % VEC != 0 || !(port::aligned16(x) && port::aligned16(xs))))) {
    return cudaErrorInvalidValue;
  }
  const long long total = static_cast<long long>(N) * hs * ws * s * s * cp / VEC;
  if (total * VEC >= (1LL << 31) || static_cast<long long>(N) * H * W * C >= (1LL << 31)) {
    return cudaErrorInvalidValue;  // the 32-bit index
  }
  s2d_pool_pack_kernel<T, VEC><<<port::blocks_for(total, THREADS), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(xs), H, W, C, hs, ws, s, cp, static_cast<unsigned>(total));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pack(const void* x, void* xs, int N, int H, int W, int C, int hs, int ws, int s, int cp, int vec,
         void* stream) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const auto st = static_cast<cudaStream_t>(stream);
  if (vec == V) return pack_vec<T, V>(x, xs, N, H, W, C, hs, ws, s, cp, st);
  if (vec == 1) return pack_vec<T, 1>(x, xs, N, H, W, C, hs, ws, s, cp, st);
  return cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* xs, void* y, int N, int hs, int ws, int cp, int C, int window, int s, int Ho, int Wo,
           void* stream) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  // the vector loads need a 16-byte aligned operand and channel blocks (a store off alignment goes lane by lane)
  if (!port::aligned16(xs) || cp % VEC != 0 || C > cp) return cudaErrorInvalidValue;
  const int depth = s * s * cp;
  const PhaseOperand g{hs * ws * depth, cp, ws * depth, depth, C, Ho, Wo};
  const bool pool3 = window == 3 && s == 2;
  const int bands = (Ho + PHASE_BAND - 1) / PHASE_BAND;
  const long long total = static_cast<long long>(N) * (pool3 ? bands : Ho) * Wo * ((C + VEC - 1) / VEC);
  if (static_cast<long long>(N) * hs * ws * depth >= (1LL << 31)) return cudaErrorInvalidValue;  // 32-bit offsets
  const auto st = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(xs);
  T* out = static_cast<T*>(y);
  const int blocks = port::blocks_for(total, THREADS), n = static_cast<int>(total);
  if (pool3) {
    maxpool_s2d_band_kernel<T, VEC><<<blocks, THREADS, 0, st>>>(x, out, g, bands, n);
  } else {
    maxpool_s2d_any_kernel<T, VEC><<<blocks, THREADS, 0, st>>>(x, out, g, window, s, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: the vector width the wrapper chose (ops/cuda_kernels.py vector_width): 16 / sizeof(T) or 1
extern "C" int s2d_pool_pack_f32(const void* x, void* xs, int N, int H, int W, int C, int hs, int ws, int s, int cp,
                                 int vec, void* stream) {
  return pack<float>(x, xs, N, H, W, C, hs, ws, s, cp, vec, stream);
}

extern "C" int s2d_pool_pack_bf16(const void* x, void* xs, int N, int H, int W, int C, int hs, int ws, int s, int cp,
                                  int vec, void* stream) {
  return pack<port::bf16>(x, xs, N, H, W, C, hs, ws, s, cp, vec, stream);
}

extern "C" int maxpool_s2d_f32(const void* xs, void* y, int N, int hs, int ws, int cp, int C, int window, int s,
                               int Ho, int Wo, void* stream) {
  return launch<float>(xs, y, N, hs, ws, cp, C, window, s, Ho, Wo, stream);
}

extern "C" int maxpool_s2d_bf16(const void* xs, void* y, int N, int hs, int ws, int cp, int C, int window, int s,
                                int Ho, int Wo, void* stream) {
  return launch<port::bf16>(xs, y, N, hs, ws, cp, C, window, s, Ho, Wo, stream);
}
