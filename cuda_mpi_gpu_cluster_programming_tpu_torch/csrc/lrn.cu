// Cross-channel local response normalisation on NHWC tensors.
//
// Replaces the TPU kernel _lrn_kernel (cuda_mpi_gpu_cluster_programming_tpu/
// ops/pallas_kernels.py). out[c] = x[c] / (k + a * sum_{j in win(c)} x[j]^2)^beta
// with win(c) = [max(0, c - size/2), min(C - 1, c + size/2)]: the window is
// cut at the channel edges and not renormalised. `a` is alpha or alpha/size;
// the caller folds that choice in. On the TPU the window sum is a banded 0/1
// matmul, a workaround for slicing the lane axis; here the sums read squares
// from shared memory.
//
// Bound on the H100: bytes (about 14 operations per element against 8 bytes
// moved in fp32), once the powf and the divide are paid. Design: a block
// takes a tile of pixels x a chunk of up to CHUNK channels (lrn2, C = 256:
// the whole pixel, 4 pixels in fp32, 8 in bf16). Its threads load the tile's
// channels, and the window's halo beside the chunk, in 16-byte vectors (4
// fp32 or 8 bf16; the VEC = 1 instance takes a C or a pointer the vectors do
// not fit) and write each square once, as fp32, to shared memory. Then a
// thread owns one vector of one pixel: at size 5 (lrn2's, HALF 2) it reads
// the squares of its channels and their halo as three 16-byte vectors a
// lane's worth apart (conflict-free; a scalar read a channel would hit each
// bank 4 (fp32) or 8 (bf16) times), sums each channel's window in registers,
// divides, and stores 16 bytes (its x vector read again, from L1); other
// sizes read the squares one by one. All arithmetic is fp32 whatever the
// element type, rounded step by step (__fmul_rn/__fadd_rn keep nvcc from
// fusing into FMAs), each sum in the order j = lo..hi from 0, then powf and
// __fdiv_rn: operations in an order that keeps the bits chip_smoke.py's
// POOL_LRN_SHA256 holds, and whose sums the plain PyTorch version's shifted
// adds repeat. One cast at the store.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 1024;  // output channels a block normalises, at most
constexpr int PAD = 8;       // floats of slack each side of a pixel's squares: the vector reads' halo

// VEC neighbouring elements of T as fp32 lanes: one 16-byte access when VEC
// fills 16 bytes (4 fp32, 8 bf16; the pointer 16-byte aligned), one element
// when VEC is 1. A bf16's fp32 value is its bits shifted up 16 (exact); store
// rounds an fp32 result once, as port::from_f32.
template <typename T, int VEC>
struct Lanes;

template <>
struct Lanes<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Lanes<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[1]) { f[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float (&f)[1]) { *p = f[0]; }
};

__device__ __forceinline__ unsigned bf16_bits_rn(float v) {
  return static_cast<unsigned>(__bfloat16_as_ushort(port::from_f32<port::bf16>(v)));
}

template <>
struct Lanes<port::bf16, 8> {
  static __device__ __forceinline__ void load(const port::bf16* p, float (&f)[8]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(port::bf16* p, const float (&f)[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bf16_bits_rn(f[2 * i]) | (bf16_bits_rn(f[2 * i + 1]) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Lanes<port::bf16, 1> {
  static __device__ __forceinline__ void load(const port::bf16* p, float (&f)[1]) {
    f[0] = __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
  }
  static __device__ __forceinline__ void store(port::bf16* p, const float (&f)[1]) {
    *p = port::from_f32<port::bf16>(f[0]);
  }
};

// grid: (pixel tiles of `pix` pixels, channel chunks of `chunk` channels). HALF: 2 at size 5, lrn2's (the
// squares in registers), else -1 (any size, read one by one).
template <typename T, int VEC, int HALF>
__global__ void __launch_bounds__(THREADS)
lrn_kernel(const T* __restrict__ x, T* __restrict__ y, int P, int C, int chunk, int pix, int size, float a,
           float beta, float k) {
  extern __shared__ __align__(16) float sq[];  // [pix][PAD + width + PAD]: channels s_lo .. s_lo + width - 1
  const int half = HALF >= 0 ? HALF : size / 2;
  const int p0 = blockIdx.x * pix;
  const int np = min(pix, P - p0);
  const int c_lo = blockIdx.y * chunk;
  const int c_hi = min(C, c_lo + chunk);
  // the squares the chunk's windows read, widened to whole vectors (C is a multiple of VEC)
  const int s_lo = max(0, c_lo - half) / VEC * VEC;
  const int s_hi = min(C, (c_hi + half + VEC - 1) / VEC * VEC);
  const int width = s_hi - s_lo;
  const int stride = width + 2 * PAD;
  const int sv = width / VEC;
  const T* xt = x + static_cast<size_t>(p0) * C;
  T* yt = y + static_cast<size_t>(p0) * C;

  for (int i = threadIdx.x; i < np * sv; i += THREADS) {
    const int p = i / sv, j = i - p * sv;
    float f[VEC];
    Lanes<T, VEC>::load(xt + static_cast<size_t>(p) * C + s_lo + j * VEC, f);
    float* dst = sq + p * stride + PAD + j * VEC;
#pragma unroll
    for (int l = 0; l < VEC; ++l) f[l] = __fmul_rn(f[l], f[l]);
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int l = 0; l < VEC; l += 4) *reinterpret_cast<float4*>(dst + l) = make_float4(f[l], f[l + 1], f[l + 2], f[l + 3]);
    } else {
#pragma unroll
      for (int l = 0; l < VEC; ++l) dst[l] = f[l];
    }
  }
  __syncthreads();

  const int ov = (c_hi - c_lo) / VEC;
  for (int i = threadIdx.x; i < np * ov; i += THREADS) {
    const int p = i / ov;
    const int c0 = c_lo + (i - p * ov) * VEC;
    const int base = p * stride + PAD - s_lo;  // sq[base + j]: channel j's square
    float f[VEC], s[VEC];
    Lanes<T, VEC>::load(xt + static_cast<size_t>(p) * C + c0, f);
    if constexpr (HALF >= 0) {
      // the squares of channels c0 - Q .. c0 + VEC - 1 + Q; those past the tile are slack, never summed
      constexpr int Q = VEC > 1 ? VEC : HALF;
      float q[VEC + 2 * Q];
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int e = 0; e < VEC + 2 * Q; e += 4) {
          const float4 v = *reinterpret_cast<const float4*>(sq + base + c0 - Q + e);
          q[e] = v.x;
          q[e + 1] = v.y;
          q[e + 2] = v.z;
          q[e + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC + 2 * Q; ++e) q[e] = sq[base + c0 - Q + e];
      }
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        s[l] = 0.f;
#pragma unroll
        for (int d = -HALF; d <= HALF; ++d) {
          const int j = c0 + l + d;
          if (j >= 0 && j < C) s[l] = __fadd_rn(s[l], q[Q + l + d]);
        }
      }
    } else {
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        const int c = c0 + l;
        const int lo = c - half < 0 ? 0 : c - half;
        const int hi = c + half > C - 1 ? C - 1 : c + half;
        s[l] = 0.f;
        for (int j = lo; j <= hi; ++j) s[l] = __fadd_rn(s[l], sq[base + j]);
      }
    }
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      const float scale = __fadd_rn(k, __fmul_rn(a, s[l]));
      f[l] = __fdiv_rn(f[l], powf(scale, beta));
    }
    Lanes<T, VEC>::store(yt + static_cast<size_t>(p) * C + c0, f);
  }
}

template <typename T, int VEC, int HALF>
int launch_half(const void* xp, void* yp, long long P, int C, int size, float a, float beta, float k,
                cudaStream_t stream) {
  const int chunk = C < CHUNK ? C : CHUNK;
  const int per_pixel = chunk / VEC;  // output vectors a pixel's chunk holds
  const int pix = per_pixel >= THREADS ? 1 : THREADS / per_pixel;
  const int width_max = chunk + 2 * (size / 2) + 2 * VEC;
  const size_t smem = sizeof(float) * static_cast<size_t>(pix) * ((width_max < C ? width_max : C) + 2 * PAD);
  const long long tiles = (P + pix - 1) / pix;
  if (P >= (1LL << 31) || tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  auto kernel = lrn_kernel<T, VEC, HALF>;
  if (smem > 48 * 1024) {
    // a window past what the card allows is refused here, with this error code
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>((C + chunk - 1) / chunk));
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(xp), static_cast<T*>(yp), static_cast<int>(P), C,
                                          chunk, pix, size, a, beta, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_vec(const void* xp, void* yp, long long total, int C, int size, float a, float beta, float k,
               cudaStream_t stream) {
  if (C % VEC != 0 || (VEC > 1 && !(port::aligned16(xp) && port::aligned16(yp)))) return cudaErrorInvalidValue;
  const long long P = total / C;
  if (size / 2 == 2) return launch_half<T, VEC, 2>(xp, yp, P, C, size, a, beta, k, stream);
  return launch_half<T, VEC, -1>(xp, yp, P, C, size, a, beta, k, stream);
}

// vec: the channel-vector width the wrapper chose (ops/cuda_kernels.py vector_width): 16 / sizeof(T) or 1
template <typename T>
int launch(const void* x, void* y, long long total, int C, int size, float a, float beta, float k, int vec,
           void* stream) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const auto st = static_cast<cudaStream_t>(stream);
  if (vec == V) return launch_vec<T, V>(x, y, total, C, size, a, beta, k, st);
  if (vec == 1) return launch_vec<T, 1>(x, y, total, C, size, a, beta, k, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int lrn_f32(const void* x, void* y, long long total, int C, int size, float a, float beta, float k,
                       int vec, void* stream) {
  return launch<float>(x, y, total, C, size, a, beta, k, vec, stream);
}

extern "C" int lrn_bf16(const void* x, void* y, long long total, int C, int size, float a, float beta, float k,
                        int vec, void* stream) {
  return launch<port::bf16>(x, y, total, C, size, a, beta, k, vec, stream);
}

// The library's one error-message entry point (shared by all the kernels).
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
