// Flash-attention forward: online-softmax attention with the per-row LSE.
//
// Replaces the TPU kernel _fwd_kernel (cuda_mpi_gpu_cluster_programming_tpu/
// ops/flash_attention.py, pallas_call in _flash_forward). For q, k, v of
// shape (B, L, H, D), fp32 or bf16, it writes out (B, L, H, D) in the input
// type and lse (B, H, L) in fp32:
//   s = (q * scale) k^T, scale = 1/sqrt(D);
//   per k tile: m_new = max(m, rowmax(s)), corr = exp(m - m_new),
//   p = exp(s - m_new), acc = acc * corr + p v, den = den * corr + sum(p);
//   out = acc / max(den, 1e-30), lse = m + log(max(den, 1e-30)).
// Causal rows see keys at positions <= their own.
//
// Bound on the H100: operations (2 products of 2 B H L^2 D FLOPs, half of
// that causal, against 4 reads/writes of B L H D elements): FFMA's 67
// TFLOP/s in fp32, the tensor cores' 989 in bf16. One block per (b, h,
// 64-row q tile), 128 threads, one grid dimension with (b, h) fastest (any
// B and H) and the heaviest causal tiles first; 64-key K/V tiles stream
// through shared memory and k tiles wholly above the diagonal are not
// visited. No atomics: a second launch gives the same bits. At D <= 128
// (over flash_bwd_sm90.cuh, the pieces of the Hopper backward):
//   * fp32, flash_fwd_kernel_ffma: FFMA in the operations and order of the
//     parent kernel (its bits, which FLASH_SWEEP_SHA256 and the backward's
//     FLASH_BWD_TILES_SHA256 hold through out and lse): q rounded to
//     q * scale in shared memory, s one fmaf chain over d ascending from 0,
//     a thread's 4 rows (rg + 16 i) x 8 keys (cg + 8 j) of the score tile
//     (the key set whose partial sums and 8-lane butterfly give sum(p) as
//     before), acc multiplied by corr and then one fmaf chain over the
//     tile's keys ascending. What changed is the data movement: float4
//     reads along d and c from rows padded to D + 4 floats, a thread's
//     output columns in runs of 4 on the rows of its scores (so corr stays
//     in registers), p through shared memory, a 2-stage cp.async K/V ring.
//   * bf16, flash_fwd_kernel_mma: mma.sync.m16n8k16 on the tensor cores,
//     the FA-2 layout: a warp owns 16 q rows, their A fragments loaded once
//     by ldmatrix. s runs on the raw bf16 operands (exact products) and is
//     scaled after; the row max and sum(p) reduce over a quad by shuffles;
//     the output accumulator (D / 2 fp32 registers a thread) is rescaled in
//     registers. p's C fragments are re-packed as A fragments of p v, whose
//     V operand is read by ldmatrix.trans; p is split into hi = bf16(p) and
//     lo = bf16(p - hi), as one bf16 rounding takes out 38-79x past the
//     plain version's rule (tests/test_torch_attention.py). A 3-stage K/V
//     ring (2 at D = 128).
// D = 256 (flash_fwd_kernel) keeps the FFMA kernel of before for both
// dtypes: the q tile, pre-scaled, and each 64-key K/V tile in shared memory
// as fp32 (bf16 widened at the load), a thread owns 4 rows and every 8th
// column of the scores and of the output, p through shared memory (209 KB).
// D > 256 (any multiple of DC = 64; flash_fwd_wide_kernel): one block per
// (b, h, q tile, window of WN = 256 output columns); the q and k tiles are
// held DC columns at a time and the scores summed chunk after chunk (d
// ascending, one fmaf a term, as above), so every window recomputes the
// same scores and statistics bit for bit; window 0 writes lse.
//
// Masking: a key past the end of the sequence or above the causal diagonal
// adds exactly 0. Its score is -inf and its p is exp(-inf) = 0; while a
// row has seen no key at all (m = -inf), the exponent is taken against 0,
// so no exp(-inf - -inf) appears. K/V rows past the end load as 0, so
// 0 * v never meets garbage. q, k and v are read through their (B, L, H)
// strides, the last axis contiguous; at D <= 128 by 16-byte cp.async where
// the operand's base and strides are 16-byte aligned, else element by
// element into the same tiles (the same bits).
#include <type_traits>

#include "flash_bwd_sm90.cuh"

namespace {

namespace fs = flash_sm90;

// ------------------------------------------------------------------ D = 256 and D > 256: FFMA in both dtypes

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

// The steps both FFMA kernels of D >= 256 take, for the thread's rows rg * RG + i and score
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
  const fs::Place at = fs::place((L + BQ - 1) / BQ, H, causal);
  const int q0 = at.tile * BQ, h = at.h, b = at.b;
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

// D > 256, a multiple of DC; a block's rank is its q tile times windows plus its window.
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
  const fs::Place at = fs::place((L + BQ - 1) / BQ * windows, H, causal);  // rank: q tile, then window
  const int win = at.tile % windows;
  const int q0 = (at.tile / windows) * BQ, w0 = win * WN, h = at.h, b = at.b;
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

// ------------------------------------------------------------------ D <= 128, fp32: FFMA

namespace ffma {

constexpr int SR = fs::f32::SR;  // q rows of the score tile a thread owns: rg + 16 i
constexpr int SC = fs::f32::SC;  // keys: cg + 8 j (rg = tid / 8, cg = tid % 8)

// A thread's output columns of its rows: runs of W at cg * W + 8 W r, r < RUNS.
template <int D>
struct Cols {
  static constexpr int W = D >= 32 ? 4 : D / 8;
  static constexpr int RUNS = D / (8 * W);
};

template <int D>
struct Layout {
  static constexpr int S = fs::f32::RS<D>;
  // p rows: a warp's stores (4 rows x 8 keys) land in 32 distinct banks, its float4 reads of 4 rows in 4
  static constexpr int PS = 72;
  static constexpr int bytes = 4 * (5 * fs::BT * S + fs::BT * PS);  // q, k and v (2 stages), p
};

// s[i][j] = fmaf chain over d ascending from 0 of Q[rg + 16 i][d] K[cg + 8 j][d] (Q holds q * scale).
template <int D>
__device__ __forceinline__ void scores(float (&s)[SR][SC], const float* Q, const float* K, int rg, int cg) {
  constexpr int S = fs::f32::RS<D>;
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float a[SR][4], b[SC][4];
#pragma unroll
    for (int i = 0; i < SR; ++i)
      *reinterpret_cast<float4*>(a[i]) = *reinterpret_cast<const float4*>(Q + (rg + 16 * i) * S + d);
#pragma unroll
    for (int j = 0; j < SC; ++j)
      *reinterpret_cast<float4*>(b[j]) = *reinterpret_cast<const float4*>(K + (cg + 8 * j) * S + d);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = fmaf(a[i][e], b[j][e], s[i][j]);
  }
}

// acc[i][r * W + e] (row rg + 16 i, column cg * W + 8 W r + e) continues one fmaf chain over the tile's 64
// keys c ascending of P[row][c] V[c][column].
template <int D, int PS>
__device__ __forceinline__ void pv(float (&acc)[SR][D / 8], const float* P, const float* V, int rg, int cg) {
  using C = Cols<D>;
  constexpr int S = fs::f32::RS<D>, W = C::W;
#pragma unroll 2
  for (int c = 0; c < fs::BT; c += 4) {
    float pr[SR][4];
#pragma unroll
    for (int i = 0; i < SR; ++i)
      *reinterpret_cast<float4*>(pr[i]) = *reinterpret_cast<const float4*>(P + (rg + 16 * i) * PS + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float vr[C::RUNS][W];
#pragma unroll
      for (int r = 0; r < C::RUNS; ++r) {
        const float* src = V + (c + cc) * S + cg * W + 8 * W * r;
        if constexpr (W == 4) {
          *reinterpret_cast<float4*>(vr[r]) = *reinterpret_cast<const float4*>(src);
        } else {
          *reinterpret_cast<float2*>(vr[r]) = *reinterpret_cast<const float2*>(src);
        }
      }
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int r = 0; r < C::RUNS; ++r)
#pragma unroll
          for (int e = 0; e < W; ++e) acc[i][r * W + e] = fmaf(pr[i][cc], vr[r][e], acc[i][r * W + e]);
    }
  }
}

}  // namespace ffma

template <int D>
__global__ void __launch_bounds__(fs::THREADS)
flash_fwd_kernel_ffma(fs::Operand<float> q, fs::Operand<float> k, fs::Operand<float> v, float* __restrict__ out,
                      float* __restrict__ lse, int L, int H, int causal, float scale) {
  using Lay = ffma::Layout<D>;
  using C = ffma::Cols<D>;
  constexpr int BT = fs::BT, S = Lay::S, PS = Lay::PS, SR = ffma::SR, SC = ffma::SC, W = C::W;
  extern __shared__ float4 smem_ffma[];
  float* Qs = reinterpret_cast<float*>(smem_ffma);  // q * scale
  float* KV = Qs + BT * S;                          // stage st: k at KV + 2 st BT S, then v
  float* Ps = KV + 4 * BT * S;                      // p of the current k tile

  const int tid = threadIdx.x;
  const int rg = tid / SC, cg = tid % SC;
  const int nt = (L + BT - 1) / BT;
  const fs::Place at = fs::place(nt, H, causal);
  const int q0 = at.tile * BT, h = at.h, b = at.b;
  const float* kb = k.slice(b, h);
  const float* vb = v.slice(b, h);
  const int nkt = causal ? (min(L, q0 + BT) + BT - 1) / BT : nt;
  auto load_kv = [&](int t) {
    if (t < nkt) {
      float* dst = KV + (t & 1) * 2 * BT * S;
      fs::load_tile<float, D, S>(sm90::smem_addr(dst), kb, k.l, t * BT, L, k.vec);
      fs::load_tile<float, D, S>(sm90::smem_addr(dst + BT * S), vb, v.l, t * BT, L, v.vec);
    }
    sm90::cp_async_commit();
  };
  fs::load_tile<float, D, S>(sm90::smem_addr(Qs), q.slice(b, h), q.l, q0, L, q.vec);
  load_kv(0);
  sm90::cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < BT * D; i += fs::THREADS) Qs[(i / D) * S + i % D] *= scale;  // rows past L: 0

  float m[SR], den[SR], acc[SR][D / 8];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    m[i] = -INFINITY;
    den[i] = 0.f;
#pragma unroll
    for (int e = 0; e < D / 8; ++e) acc[i][e] = 0.f;
  }

  for (int t = 0; t < nkt; ++t) {
    sm90::cp_async_wait<0>();
    __syncthreads();  // tile t landed (and q is scaled); every reader of the last tile's p and of the stage refilled next is done
    load_kv(t + 1);
    const float* Kc = KV + (t & 1) * 2 * BT * S;
    float s[SR][SC];
    ffma::scores<D>(s, Qs, Kc, rg, cg);
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int r = rg + 16 * i;
      const int row = q0 + r;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int key = t * BT + cg + 8 * j;
        if (key >= L || (causal && key > row)) s[i][j] = -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < SC; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const float p = expf(s[i][j] - m_use);
        Ps[r * PS + cg + 8 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 1; off < SC; off <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      den[i] = den[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < D / 8; ++e) acc[i][e] *= corr;
    }
    __syncthreads();  // every row's p is in Ps
    ffma::pv<D, PS>(acc, Ps, Kc + BT * S, rg, cg);
  }

  const long long rs = static_cast<long long>(H) * D;
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= L) continue;
    const float dd = fmaxf(den[i], 1e-30f);
    float* o = out + (static_cast<long long>(b) * L + row) * rs + static_cast<long long>(h) * D + cg * W;
#pragma unroll
    for (int r = 0; r < C::RUNS; ++r) {
      float x[W];
#pragma unroll
      for (int e = 0; e < W; ++e) x[e] = acc[i][r * W + e] / dd;
      if constexpr (W == 4) {
        *reinterpret_cast<float4*>(o + 8 * W * r) = *reinterpret_cast<const float4*>(x);
      } else {
        *reinterpret_cast<float2*>(o + 8 * W * r) = *reinterpret_cast<const float2*>(x);
      }
    }
    if (cg == 0) lse[(static_cast<long long>(b) * H + h) * L + row] = m[i] + logf(dd);
  }
}

// ------------------------------------------------------------------ D <= 128, bf16: the tensor cores

template <int D>
struct MmaLayout {
  static constexpr int S = fs::mma::RS<D>;
  static constexpr int STAGES = D <= 64 ? 3 : 2;  // the K/V ring
  static constexpr int TILE = fs::BT * S * 2;     // bytes of a tile
  static constexpr int bytes = TILE * (1 + 2 * STAGES);
};

template <int D>
__global__ void __launch_bounds__(fs::THREADS)
flash_fwd_kernel_mma(fs::Operand<port::bf16> q, fs::Operand<port::bf16> k, fs::Operand<port::bf16> v,
                     port::bf16* __restrict__ out, float* __restrict__ lse, int L, int H, int causal, float scale) {
  using Lay = MmaLayout<D>;
  constexpr int BT = fs::BT, S = Lay::S, ST = Lay::STAGES, TILE = Lay::TILE, NT = D / 8;
  extern __shared__ float4 smem_mma[];
  const uint32_t sQ = sm90::smem_addr(smem_mma), sKV = sQ + TILE;  // stage st: k, then v

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = (L + BT - 1) / BT;
  const fs::Place at = fs::place(nt, H, causal);
  const int q0 = at.tile * BT, h = at.h, b = at.b;
  const port::bf16* kb = k.slice(b, h);
  const port::bf16* vb = v.slice(b, h);
  const int nkt = causal ? (min(L, q0 + BT) + BT - 1) / BT : nt;
  auto load_kv = [&](int t) {
    if (t < nkt) {
      const uint32_t dst = sKV + (t % ST) * 2 * TILE;
      fs::load_tile<port::bf16, D, S>(dst, kb, k.l, t * BT, L, k.vec);
      fs::load_tile<port::bf16, D, S>(dst + TILE, vb, v.l, t * BT, L, v.vec);
    }
    sm90::cp_async_commit();
  };
  fs::load_tile<port::bf16, D, S>(sQ, q.slice(b, h), q.l, q0, L, q.vec);
  for (int t = 0; t < ST - 1; ++t) load_kv(t);  // the first group holds q too

  const int m0 = warp * 16;
  const int row_lo = q0 + m0 + (lane >> 2);  // the thread's rows: row_lo (C regs 0, 1) and row_lo + 8 (2, 3)
  float m[2] = {-INFINITY, -INFINITY}, den[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qa[D / 16][4];  // the warp's A fragments of q, one a k16 step

  for (int t = 0; t < nkt; ++t) {
    sm90::cp_async_wait<ST - 2>();
    __syncthreads();  // tile t landed; every warp is done with the stage the next load refills
    load_kv(t + ST - 1);
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) sm90::ldmatrix_x4(qa[kk], fs::mma::frag_a<S>(sQ, m0, kk * 16, lane));
    }
    const uint32_t sK = sKV + (t % ST) * 2 * TILE, sV = sK + TILE;
    float s[8][4];  // the warp's 16 rows x the tile's 64 keys
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        sm90::ldmatrix_x4(bf, fs::mma::frag_b_nk<S>(sK, np * 16, kk * 16, lane));
        sm90::mma_bf16(s[2 * np], qa[kk], bf[0], bf[1]);
        sm90::mma_bf16(s[2 * np + 1], qa[kk], bf[2], bf[3]);
      }
    }
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_lo + 8 * (e >> 1);
        const int key = t * BT + n * 8 + 2 * (lane & 3) + (e & 1);
        const bool masked = key >= L || (causal && key > row);
        s[n][e] = masked ? -INFINITY : s[n][e] * scale;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
      }
    float m_use[2], corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mt[hf] = fmaxf(mt[hf], __shfl_xor_sync(0xffffffffu, mt[hf], 1));
      mt[hf] = fmaxf(mt[hf], __shfl_xor_sync(0xffffffffu, mt[hf], 2));
      const float m_new = fmaxf(m[hf], mt[hf]);
      m_use[hf] = m_new == -INFINITY ? 0.f : m_new;
      corr[hf] = expf(m[hf] - m_use[hf]);
      m[hf] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_use[e >> 1]);  // p
        psum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      psum[hf] += __shfl_xor_sync(0xffffffffu, psum[hf], 1);
      psum[hf] += __shfl_xor_sync(0xffffffffu, psum[hf], 2);
      den[hf] = den[hf] * corr[hf] + psum[hf];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    uint32_t hi[4][4], lo[4][4];
    fs::mma::as_a(s, hi, lo);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) fs::mma::product_pair<D>(acc[2 * np], acc[2 * np + 1], hi, lo, sV, np, lane);
  }

  const long long rs = static_cast<long long>(H) * D;
  port::bf16* base = out + static_cast<long long>(b) * L * rs + static_cast<long long>(h) * D + (lane & 3) * 2;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row_lo + 8 * hf;
    if (row >= L) continue;
    const float dd = fmaxf(den[hf], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(base + row * rs + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * hf] / dd, acc[n][2 * hf + 1] / dd);
    if ((lane & 3) == 0) lse[(static_cast<long long>(b) * H + h) * L + row] = m[hf] + logf(dd);
  }
}

// ------------------------------------------------------------------ launch

// the grid: one dimension over q tiles (x windows) x B x H
inline int grid_for(int L, int windows, int B, int H, dim3& grid) {
  const long long blocks = static_cast<long long>((L + BQ - 1) / BQ) * windows * B * H;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  grid = dim3(static_cast<unsigned>(blocks));
  return 0;
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* out, void* lse, int B, int L, int H, int D,
                Strides sq, Strides sk, Strides sv, int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_wide_kernel<T>;
  const int bytes = WideLayout::bytes;
  const int windows = (D + WN - 1) / WN;
  dim3 grid;
  if (const int err = grid_for(L, windows, B, H, grid)) return err;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  dim3 grid;
  if (const int err = grid_for(L, 1, B, H, grid)) return err;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), L, H, sq, sk, sv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_sm90(const void* q, const void* k, const void* v, void* out, void* lse, int B, int L, int H,
                Strides sq, Strides sk, Strides sv, int causal, float scale, cudaStream_t stream) {
  const auto oq = fs::operand<T>(q, sq.b, sq.l, sq.h), ok = fs::operand<T>(k, sk.b, sk.l, sk.h);
  const auto ov = fs::operand<T>(v, sv.b, sv.l, sv.h);
  dim3 grid;
  if (const int err = grid_for(L, 1, B, H, grid)) return err;
  auto run = [&](auto kernel, int bytes) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, fs::THREADS, bytes, stream>>>(oq, ok, ov, static_cast<T*>(out), static_cast<float*>(lse), L, H,
                                                 causal, scale);
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (std::is_same<T, float>::value) return run(flash_fwd_kernel_ffma<D>, ffma::Layout<D>::bytes);
  else return run(flash_fwd_kernel_mma<D>, MmaLayout<D>::bytes);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int L, int H, int D,
           long long qb, long long ql, long long qh, long long kb, long long kl, long long kh,
           long long vb, long long vl, long long vh, int causal, float scale, void* stream) {
  const Strides sq{qb, ql, qh}, sk{kb, kl, kh}, sv{vb, vl, vh};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_sm90<T, 16>(q, k, v, out, lse, B, L, H, sq, sk, sv, causal, scale, st);
    case 32: return launch_sm90<T, 32>(q, k, v, out, lse, B, L, H, sq, sk, sv, causal, scale, st);
    case 64: return launch_sm90<T, 64>(q, k, v, out, lse, B, L, H, sq, sk, sv, causal, scale, st);
    case 128: return launch_sm90<T, 128>(q, k, v, out, lse, B, L, H, sq, sk, sv, causal, scale, st);
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
