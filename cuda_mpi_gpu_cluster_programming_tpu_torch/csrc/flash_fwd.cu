// Flash-attention forward: online-softmax attention with the per-row LSE.
//
// Replaces the TPU kernel _fwd_kernel (cuda_mpi_gpu_cluster_programming_tpu/
// ops/flash_attention.py, pallas_call in _flash_forward). For q, k, v of
// shape (B, L, H, D), fp32 or bf16, it writes out (B, L, H, D) in the input
// type and lse (B, H, L) in fp32:
//   s = (q * scale) k^T, scale = 1/sqrt(D) applied to q first;
//   per k tile: m_new = max(m, rowmax(s)), corr = exp(m - m_new),
//   p = exp(s - m_new), acc = acc * corr + p v, den = den * corr + sum(p);
//   out = acc / max(den, 1e-30), lse = m + log(max(den, 1e-30)).
// Causal rows see keys at positions <= their own.
//
// Bound on the H100: operations in fp32 (4 B H L^2 D FLOPs, half of that
// causal, against 4 reads/writes of B L H D elements); in bf16 the bound is
// the tensor cores' rate, which this FFMA kernel does not reach (a
// wgmma/TMA design is later work). Design: one block per (b, h, 64-row
// q tile); the q tile, pre-scaled, and each 64-key K/V tile live in shared
// memory as fp32 (bf16 widens at the load; nothing is rounded to bf16
// before the single store). 128 threads: a thread owns 4 rows and every
// 8th column of the tile's scores (and every 8th of the D output columns),
// so a row's statistics reduce over 8 neighbouring lanes with shuffles and
// stay in registers. p goes through shared memory to the p v product.
// q, k and v are read in place through their (B, L, H) strides; the last
// axis is contiguous. The kernel tiles by its own 64 x 64: block_q/block_k
// of the Python API only validate and clamp (in fp32 only the order of
// the sums changes). D = 256: 209 KB of shared memory and a 4 x 32 register
// accumulator a thread. D > 256 (any multiple of DC = 64; flash_fwd_wide):
// one block per (b, h, q tile, window of WN = 256 output columns); the q
// and k tiles are held DC columns at a time and the scores summed chunk
// after chunk (d ascending, one fmaf a term, as above), so every window
// recomputes the same scores and statistics bit for bit; a block holds its
// window's V columns and a 4 x 32 accumulator a thread, as at D = 256
// (115 KB of shared memory); window 0 writes lse.
//
// Masking: a key past the end of the sequence or above the causal diagonal
// adds exactly 0. Its score is -inf and its p is exp(-inf) = 0; while a
// row has seen no key at all (m = -inf), the exponent is taken against 0,
// so no exp(-inf - -inf) appears. Tiles wholly above the diagonal are not
// visited. K/V rows past the end load as 0, so 0 * v never meets garbage.
#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int CG = 8;         // column groups: a thread's columns are cg + 8 j
constexpr int RG = 4;         // rows per thread
constexpr int THREADS = (BQ / RG) * CG;  // 128
constexpr int KJ = BK / CG;   // score columns per thread
constexpr int PS = BK + 1;    // row stride of the p tile

template <int D>
struct Layout {
  static constexpr int QS = D + 1;   // odd row strides: the 16 rows a warp reads hit distinct banks
  static constexpr int KS = D + 1;
  static constexpr int VS = D;       // a warp reads 8 neighbouring columns of one row
  static constexpr int bytes = static_cast<int>(sizeof(float)) * (BQ * QS + BK * KS + BK * VS + BQ * PS);
};

struct Strides {
  long long b, l, h;
};

// The steps both kernels take, for the thread's rows rg * RG + i and score
// columns cg + CG * j of a BQ x BK tile.

// s[i][j] += sum over the tiles' W columns of q[row][d] * k[key][d], d ascending, one fmaf a term
// (Qs, Ks: row stride S).
template <int W, int S>
__device__ __forceinline__ void score_chunk(float (&s)[RG][KJ], const float* Qs, const float* Ks, int rg, int cg) {
#pragma unroll 4
  for (int d = 0; d < W; ++d) {
    float qv[RG], kv[KJ];
#pragma unroll
    for (int i = 0; i < RG; ++i) qv[i] = Qs[(rg * RG + i) * S + d];
#pragma unroll
    for (int j = 0; j < KJ; ++j) kv[j] = Ks[(cg + CG * j) * S + d];
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
}

// The online softmax of the k tile at k0: mask, the row max over the 8 lanes of a row, p into Ps
// (row stride PS), den, and acc scaled by the correction.
template <int DJ>
__device__ __forceinline__ void softmax_step(float (&s)[RG][KJ], float (&m)[RG], float (&den)[RG],
                                             float (&acc)[RG][DJ], float* Ps, int q0, int k0, int L, int causal,
                                             int rg, int cg) {
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    const int r = rg * RG + i;
    const int row = q0 + r;
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int key = k0 + cg + CG * j;
      if (key >= L || (causal && key > row)) s[i][j] = -INFINITY;
      mt = fmaxf(mt, s[i][j]);
    }
#pragma unroll
    for (int off = 1; off < CG; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    const float m_new = fmaxf(m[i], mt);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float corr = expf(m[i] - m_use);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const float p = expf(s[i][j] - m_use);
      Ps[r * PS + cg + CG * j] = p;
      psum += p;
    }
#pragma unroll
    for (int off = 1; off < CG; off <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
    den[i] = den[i] * corr + psum;
    m[i] = m_new;
#pragma unroll
    for (int e = 0; e < DJ; ++e) acc[i][e] *= corr;
  }
}

// acc[i][e] += sum over the tile's BK keys of p[row][c] * v[c][cg + CG * e] (Vs: row stride VS).
template <int DJ, int VS>
__device__ __forceinline__ void pv_step(float (&acc)[RG][DJ], const float* Ps, const float* Vs, int rg, int cg) {
#pragma unroll 4
  for (int c = 0; c < BK; ++c) {
    float pv[RG], vv[DJ];
#pragma unroll
    for (int i = 0; i < RG; ++i) pv[i] = Ps[(rg * RG + i) * PS + c];
#pragma unroll
    for (int e = 0; e < DJ; ++e) vv[e] = Vs[c * VS + cg + CG * e];
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int e = 0; e < DJ; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
  }
}

// out columns [w0, w0 + CG * DJ) below D of the thread's rows (row stride H * D), and, where write_lse, lse.
template <typename T, int DJ>
__device__ __forceinline__ void store_rows(T* out, float* lse, const float (&m)[RG], const float (&den)[RG],
                                           const float (&acc)[RG][DJ], int b, int h, int q0, int L, int H, int D,
                                           int w0, bool write_lse, int rg, int cg) {
  const long long row_stride = static_cast<long long>(H) * D;
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    const int row = q0 + rg * RG + i;
    if (row >= L) continue;
    const float dd = fmaxf(den[i], 1e-30f);
    T* o = out + (static_cast<long long>(b) * L + row) * row_stride + static_cast<long long>(h) * D + w0;
#pragma unroll
    for (int e = 0; e < DJ; ++e)
      if (w0 + cg + CG * e < D) o[cg + CG * e] = port::from_f32<T>(acc[i][e] / dd);
    if (write_lse && cg == 0) lse[(static_cast<long long>(b) * H + h) * L + row] = m[i] + logf(dd);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int L, int H,
                 Strides sq, Strides sk, Strides sv, int causal, float scale) {
  using Lay = Layout<D>;
  constexpr int DJ = D / CG;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * Lay::QS;
  float* Vs = Ks + BK * Lay::KS;
  float* Ps = Vs + BK * Lay::VS;

  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    Qs[r * Lay::QS + d] = row < L ? port::to_f32(qb[row * sq.l + d]) * scale : 0.f;
  }

  float m[RG], den[RG], acc[RG][DJ];
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    m[i] = -INFINITY;
    den[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DJ; ++e) acc[i][e] = 0.f;
  }

  const int k_end = causal ? min(L, q0 + BQ) : L;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done with Ks, Vs and Ps
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int key = k0 + r;
      const bool in = key < L;
      Ks[r * Lay::KS + d] = in ? port::to_f32(kb[key * sk.l + d]) : 0.f;
      Vs[r * Lay::VS + d] = in ? port::to_f32(vb[key * sv.l + d]) : 0.f;
    }
    __syncthreads();

    float s[RG][KJ];
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
    score_chunk<D, Lay::QS>(s, Qs, Ks, rg, cg);
    softmax_step(s, m, den, acc, Ps, q0, k0, L, causal, rg, cg);
    __syncthreads();  // every row's p is in Ps
    pv_step<DJ, Lay::VS>(acc, Ps, Vs, rg, cg);
  }
  store_rows(out, lse, m, den, acc, b, h, q0, L, H, D, 0, true, rg, cg);
}

constexpr int DC = 64;   // columns of q and k a D > 256 block holds at a time
constexpr int WN = 256;  // output columns a D > 256 block owns

struct WideLayout {
  static constexpr int S = DC + 1;  // q and k chunks
  static constexpr int bytes = static_cast<int>(sizeof(float)) * (BQ * S + BK * S + BK * WN + BQ * PS);
};

// D > 256, a multiple of DC; grid x is q tile * windows + window.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ out, float* __restrict__ lse, int L, int H, int D, int windows,
                      Strides sq, Strides sk, Strides sv, int causal, float scale) {
  using Lay = WideLayout;
  constexpr int DJ = WN / CG;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * Lay::S;
  float* Vs = Ks + BK * Lay::S;
  float* Ps = Vs + BK * WN;

  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const int win = blockIdx.x % windows;
  const int q0 = (blockIdx.x / windows) * BQ, w0 = win * WN;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  float m[RG], den[RG], acc[RG][DJ];
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    m[i] = -INFINITY;
    den[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DJ; ++e) acc[i][e] = 0.f;
  }

  const int k_end = causal ? min(L, q0 + BQ) : L;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    float s[RG][KJ];
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
    for (int c = 0; c < D / DC; ++c) {
      __syncthreads();  // the readers of the previous chunks (and of the last tile's Vs and Ps) are done
      for (int i = tid; i < BQ * DC; i += THREADS) {
        const int r = i / DC, d = c * DC + i % DC;
        const int row = q0 + r, key = k0 + r;
        Qs[r * Lay::S + i % DC] = row < L ? port::to_f32(qb[row * sq.l + d]) * scale : 0.f;
        Ks[r * Lay::S + i % DC] = key < L ? port::to_f32(kb[key * sk.l + d]) : 0.f;
      }
      if (c == 0) {
        for (int i = tid; i < BK * WN; i += THREADS) {
          const int r = i / WN, d = i % WN;
          const int key = k0 + r;
          Vs[r * WN + d] = key < L && w0 + d < D ? port::to_f32(vb[key * sv.l + w0 + d]) : 0.f;
        }
      }
      __syncthreads();
      score_chunk<DC, Lay::S>(s, Qs, Ks, rg, cg);
    }
    softmax_step(s, m, den, acc, Ps, q0, k0, L, causal, rg, cg);
    __syncthreads();  // every row's p is in Ps
    pv_step<DJ, WN>(acc, Ps, Vs, rg, cg);
  }
  store_rows(out, lse, m, den, acc, b, h, q0, L, H, D, w0, win == 0, rg, cg);
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* out, void* lse, int B, int L, int H, int D,
                Strides sq, Strides sk, Strides sv, int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_wide_kernel<T>;
  const int bytes = WideLayout::bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int windows = (D + WN - 1) / WN;
  const dim3 grid((L + BQ - 1) / BQ * windows, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), L, H, D, windows, sq, sk, sv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, void* lse, int B, int L, int H,
             Strides sq, Strides sk, Strides sv, int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const int bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), L, H, sq, sk, sv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int L, int H, int D,
           long long qb, long long ql, long long qh, long long kb, long long kl, long long kh,
           long long vb, long long vl, long long vh, int causal, float scale, void* stream) {
  const Strides sq{qb, ql, qh}, sk{kb, kl, kh}, sv{vb, vl, vh};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, out, lse, B, L, H, sq, sk, sv, causal, scale, st);
    case 32: return launch_d<T, 32>(q, k, v, out, lse, B, L, H, sq, sk, sv, causal, scale, st);
    case 64: return launch_d<T, 64>(q, k, v, out, lse, B, L, H, sq, sk, sv, causal, scale, st);
    case 128: return launch_d<T, 128>(q, k, v, out, lse, B, L, H, sq, sk, sv, causal, scale, st);
    case 256: return launch_d<T, 256>(q, k, v, out, lse, B, L, H, sq, sk, sv, causal, scale, st);
    default:
      if (D > 256 && D % DC == 0) return launch_wide<T>(q, k, v, out, lse, B, L, H, D, sq, sk, sv, causal, scale, st);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse, int B, int L,
                             int H, int D, long long qb, long long ql, long long qh, long long kb, long long kl,
                             long long kh, long long vb, long long vl, long long vh, int causal, float scale,
                             void* stream) {
  return launch<float>(q, k, v, out, lse, B, L, H, D, qb, ql, qh, kb, kl, kh, vb, vl, vh, causal, scale, stream);
}

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B, int L,
                              int H, int D, long long qb, long long ql, long long qh, long long kb, long long kl,
                              long long kh, long long vb, long long vl, long long vh, int causal, float scale,
                              void* stream) {
  return launch<port::bf16>(q, k, v, out, lse, B, L, H, D, qb, ql, qh, kb, kl, kh, vb, vl, vh, causal, scale,
                            stream);
}
