// VALID window x window / stride max-pool over a stride-phase stack: the
// "phases" pool body, and the stack.
//
// Replaces the TPU kernel _pool_kernel behind _maxpool_phases
// (cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py), and its
// _pool_phases (XLA ops there). The operand is the TPU lowering's, which is
// what the pool A/B and the tuner measure:
//   xph (s*s, N, hp, wp, C), phase r*s + p = x[:, r::s, p::s, :], cropped or
//   zero-padded to hp = Ho + (window-1)/s rows and wp = Wo + (window-1)/s
//   columns (ops/packing.py pool_phases, bitwise the JAX package's).
// Tap (fy, fx) of output (oy, ox) is phase (fy%s)*s + fx%s at
// (oy + fy/s, ox + fx/s): unit-stride windows, as the TPU needed.
//
// Bound on the H100: bytes, in both kernels.
// - pool_phases_pack_kernel writes xph in one pass, x read once and xph
//   written once: a thread a 16-byte vector of xph (4 fp32 or 8 bf16), xph
//   order, so the stores are coalesced and each load is one pixel's channel
//   vector. A C or a pointer the vectors do not fit takes the VEC = 1 instance.
// - The pool (pool_keys.cuh phase_pool_band) has maxpool.cu's shape: a
//   thread owns a 16-byte channel vector (VEC = 1 where C or a pointer does
//   not fit) of one output column and walks a band of output rows, the 3x3/2
//   window's keys in registers. Output row oy reads row oy of phases (0, .)
//   and (1, .), and row oy + 1 of phases (0, .) only, which the next output
//   row reads again: a band of B rows loads 9 + 6(B - 1) vectors, not 9B.
//   The max is an integer max of order keys with the NaN rescue
//   (pool_keys.cuh), so the result is bitwise the plain version's and
//   maxpool2d's. Every other window runs a runtime-window instance, one
//   output a thread.
#include "pool_keys.cuh"

namespace {

constexpr int THREADS = 256;

// grid: one thread per VEC elements of xph, in xph order
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
pool_phases_pack_kernel(const T* __restrict__ x, T* __restrict__ xph, unsigned N, unsigned H, unsigned W,
                        unsigned C, unsigned hp, unsigned wp, unsigned s, unsigned total) {
  const unsigned t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const unsigned nv = C / VEC;
  const unsigned c0 = t % nv * VEC;
  unsigned r = t / nv;
  const unsigned j = r % wp;
  r /= wp;
  const unsigned i = r % hp;
  r /= hp;
  const unsigned n = r % N;
  const unsigned ph = r / N;
  const unsigned row = i * s + ph / s, col = j * s + ph % s;
  const bool inside = row < H && col < W;
  const T* src = x + ((n * H + row) * W + col) * C + c0;
  if constexpr (VEC > 1) {
    reinterpret_cast<uint4*>(xph)[t] = inside ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0, 0, 0, 0);
  } else if constexpr (sizeof(T) == 4) {
    reinterpret_cast<unsigned*>(xph)[t] = inside ? __ldg(reinterpret_cast<const unsigned*>(src)) : 0u;
  } else {
    reinterpret_cast<unsigned short*>(xph)[t] =
        inside ? __ldg(reinterpret_cast<const unsigned short*>(src)) : static_cast<unsigned short>(0);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
maxpool_phases_band_kernel(const T* __restrict__ xph, T* __restrict__ y, PhaseOperand g, int bands, int total) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t < total) phase_pool_band<T, VEC, 3, 2>(xph, y, g, bands, t);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
maxpool_phases_any_kernel(const T* __restrict__ xph, T* __restrict__ y, PhaseOperand g, int window, int s,
                          int total) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t < total) phase_pool_any<T, VEC>(xph, y, g, window, s, t);
}

template <typename T, int VEC>
int pack_vec(const void* x, void* xph, int N, int H, int W, int C, int hp, int wp, int s, cudaStream_t stream) {
  if (C % VEC != 0 || (VEC > 1 && !(port::aligned16(x) && port::aligned16(xph)))) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(s) * s * N * hp * wp * C / VEC;
  if (total * VEC >= (1LL << 31) || static_cast<long long>(N) * H * W * C >= (1LL << 31)) {
    return cudaErrorInvalidValue;  // the 32-bit index
  }
  pool_phases_pack_kernel<T, VEC><<<port::blocks_for(total, THREADS), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(xph), N, H, W, C, hp, wp, s, static_cast<unsigned>(total));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_vec(const void* xph, void* y, int N, int hp, int wp, int C, int window, int s, int Ho, int Wo,
               cudaStream_t stream) {
  if (C % VEC != 0 || (VEC > 1 && !(port::aligned16(xph) && port::aligned16(y)))) return cudaErrorInvalidValue;
  if (static_cast<long long>(s) * s * N * hp * wp * C >= (1LL << 31)) return cudaErrorInvalidValue;  // 32-bit offsets
  const int image = hp * wp * C;
  const PhaseOperand g{image, N * image, wp * C, C, C, Ho, Wo};
  const bool pool3 = window == 3 && s == 2;
  const int bands = (Ho + PHASE_BAND - 1) / PHASE_BAND;
  const long long total = static_cast<long long>(N) * (pool3 ? bands : Ho) * Wo * (C / VEC);
  const T* x = static_cast<const T*>(xph);
  T* out = static_cast<T*>(y);
  const int blocks = port::blocks_for(total, THREADS), n = static_cast<int>(total);
  if (pool3) {
    maxpool_phases_band_kernel<T, VEC><<<blocks, THREADS, 0, stream>>>(x, out, g, bands, n);
  } else {
    maxpool_phases_any_kernel<T, VEC><<<blocks, THREADS, 0, stream>>>(x, out, g, window, s, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// vec: the vector width the wrapper chose (ops/cuda_kernels.py vector_width): 16 / sizeof(T) or 1
template <typename T>
int pack(const void* x, void* xph, int N, int H, int W, int C, int hp, int wp, int s, int vec, void* stream) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const auto st = static_cast<cudaStream_t>(stream);
  if (vec == V) return pack_vec<T, V>(x, xph, N, H, W, C, hp, wp, s, st);
  if (vec == 1) return pack_vec<T, 1>(x, xph, N, H, W, C, hp, wp, s, st);
  return cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* xph, void* y, int N, int hp, int wp, int C, int window, int s, int Ho, int Wo, int vec,
           void* stream) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const auto st = static_cast<cudaStream_t>(stream);
  if (vec == V) return launch_vec<T, V>(xph, y, N, hp, wp, C, window, s, Ho, Wo, st);
  if (vec == 1) return launch_vec<T, 1>(xph, y, N, hp, wp, C, window, s, Ho, Wo, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int pool_phases_pack_f32(const void* x, void* xph, int N, int H, int W, int C, int hp, int wp, int s,
                                    int vec, void* stream) {
  return pack<float>(x, xph, N, H, W, C, hp, wp, s, vec, stream);
}

extern "C" int pool_phases_pack_bf16(const void* x, void* xph, int N, int H, int W, int C, int hp, int wp, int s,
                                     int vec, void* stream) {
  return pack<port::bf16>(x, xph, N, H, W, C, hp, wp, s, vec, stream);
}

extern "C" int maxpool_phases_f32(const void* xph, void* y, int N, int hp, int wp, int C, int window, int s, int Ho,
                                  int Wo, int vec, void* stream) {
  return launch<float>(xph, y, N, hp, wp, C, window, s, Ho, Wo, vec, stream);
}

extern "C" int maxpool_phases_bf16(const void* xph, void* y, int N, int hp, int wp, int C, int window, int s, int Ho,
                                   int Wo, int vec, void* stream) {
  return launch<port::bf16>(xph, y, N, hp, wp, C, window, s, Ho, Wo, vec, stream);
}
