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
// TFLOP/s in fp32, the tensor cores' 989 in bf16. One grid dimension with
// (b, h) fastest (any B and H) and the heaviest causal tiles first; 64-key
// k/v tiles stream through shared memory and k tiles wholly above the
// diagonal are not visited. No atomics: a second launch gives the same
// bits. At D <= 128 one block per (b, h, 64-row q tile), 128 threads (over
// flash_bwd_sm90.cuh, the pieces of the Hopper backward):
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
// D = 256 and D > 256 (the WIDE instance, any multiple of 64; over the
// header's wide pieces): 256 threads (8 warps), one block per (b, h, 64-row
// q tile, window of 256 output columns, or 128 where wide::grid_for halves
// the windows on a grid smaller than the card). The operands move as 64 x 64
// chunks through a cp.async ring that runs ahead across the visited k
// tiles: per k tile, score steps over the D / 64 chunks of k (and above 256
// of q; at D = 256 the q tile stays in shared memory for the whole block)
// summed into s chunk after chunk, then product steps over the window's
// chunks of v; a ring step carries G chunks behind one __syncthreads. Every
// window recomputes the same scores and statistics; window 0 writes lse.
// Each output element's arithmetic does not depend on the split.
//   * bf16, flash_fwd_kernel_mma_wide: mma.sync on ldmatrix fragments, the
//     8 warps split the 64 x 64 score tile as 4 row groups x 2 key halves
//     (s on the raw bf16 operands, scaled after). The row max and sum(p) of
//     the two warps that share rows meet in a small shared array (one
//     __syncthreads a tile for the max; the sums ride the first product
//     step's), so both compute the same m and den and keep corr in
//     registers. p is split into hi + lo and written once as bf16 tiles;
//     each warp loads its A fragments once a tile and owns 16 rows x 32
//     columns of each window chunk (64 fp32 accumulators a thread), v read
//     by ldmatrix.trans. G = 4 at D = 256 (a step is the whole k tile, or
//     the window's v: 3 __syncthreads a tile), 2 above; a 4-stage ring.
//   * fp32, flash_fwd_kernel_ffma_wide: FFMA with the bits of the parent
//     FFMA kernels (FLASH_SWEEP_SHA256 at D = 256, FLASH_FWD_WIDE_SHA256 and
//     the backward's FLASH_BWD_WIDE_SHA256 above): q * scale rounded, s one
//     fmaf chain over d ascending chunk after chunk, a thread's 2 rows
//     (rg + 32 i) x the 8 keys cg + 8 j of the score tile (the key set of
//     the parent's sum(p) tree: partial sums, then the 8-lane butterfly),
//     and the same 2 rows x 8 columns of each window chunk in float4 runs,
//     so corr stays in registers; acc * corr, then one fmaf chain over the
//     tile's keys ascending. Chunk rows padded to 68 floats, p rows to 72;
//     G = 1, an 8-stage ring at D = 256 (k or v a stage), 6 above (q and k).
//
// Masking: a key past the end of the sequence or above the causal diagonal
// adds exactly 0. Its score is -inf and its p is exp(-inf) = 0; while a
// row has seen no key at all (m = -inf), the exponent is taken against 0,
// so no exp(-inf - -inf) appears. K/V rows past the end load as 0, so
// 0 * v never meets garbage. q, k and v are read through their (B, L, H)
// strides, the last axis contiguous, by 16-byte cp.async where the
// operand's base and strides are 16-byte aligned, else element by element
// into the same tiles (the same bits).
#include <type_traits>

#include "flash_bwd_sm90.cuh"

namespace {

namespace fs = flash_sm90;
using fs::Strides;

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

// ------------------------------------------------------------------ D = 256 and WIDE (the wide pieces)

namespace fw = flash_sm90::wide;

// The schedule of both kernels: a ring step carries G chunks. Step u (k tile t = u / per, r = u % per,
// per = ns + the window's product steps) is score step r < ns = ceil(nch / G), which reads chunks rG.. of k
// (and, above 256, of q: chunk i of the step at stage + i 2 tile, k then q), or product step r - ns, which reads
// the window's chunks c_lo + (r - ns) G.. of v (chunk i at stage + i tile); it lands in ring stage u % ST,
// issued ST - 1 steps ahead of its use, so the ring runs on across the visited tiles. At D = 256 (RES) the q
// tile is loaded once, with the first step.
template <typename T, int CS, bool RES, int G>
__device__ __forceinline__ void issue_step(int u, int steps, int per, int ns, int nch, uint32_t st, uint32_t tile,
                                           const fs::Operand<T>& q, const fs::Operand<T>& k,
                                           const fs::Operand<T>& v, const fw::Place& at, int q0, int L) {
  if (u < steps) {
    const int t = u / per, r = u % per;
    if (r < ns) {
      for (int i = 0; i < G && r * G + i < nch; ++i) {
        const uint32_t dst = st + i * (RES ? 1 : 2) * tile;
        fw::load_chunk<T, CS>(dst, k.slice(at.b, at.h), k.l, r * G + i, t * fs::BT, L, k.vec);
        if constexpr (!RES) fw::load_chunk<T, CS>(dst + tile, q.slice(at.b, at.h), q.l, r * G + i, q0, L, q.vec);
      }
    } else {
      for (int i = 0; i < G && (r - ns) * G + i < at.nwin; ++i)
        fw::load_chunk<T, CS>(st + i * tile, v.slice(at.b, at.h), v.l, at.c_lo + (r - ns) * G + i, t * fs::BT, L,
                              v.vec);
    }
  }
  sm90::cp_async_commit();
}

// ---------------------------------------------------------- fp32: FFMA, the parent kernels' bits

namespace ffma_wide {

constexpr int SR = 2;            // q rows of the score tile a thread owns: rg + 32 i (rg = tid / 8)
constexpr int SC = 8;            // keys: cg + 8 j (cg = tid % 8), the parent's sum(p) key set
constexpr int CS = fw::f32::CS;  // row stride of a chunk tile, floats
constexpr int PS = 72;           // p rows: a warp's stores (4 rows x 8 keys) land in 32 distinct banks

// s[i][j] (row rg + 32 i, key cg + 8 j) continues its fmaf chain over the chunk's 64 columns, d ascending, of
// Q (q * scale, or raw q rounded to q * scale here when SCALE) times K.
template <bool SCALE>
__device__ __forceinline__ void scores(float (&s)[SR][SC], const float* Q, const float* K, int rg, int cg,
                                       float scale) {
#pragma unroll 2
  for (int d = 0; d < fw::CW; d += 4) {
    float a[SR][4], b[SC][4];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      *reinterpret_cast<float4*>(a[i]) = *reinterpret_cast<const float4*>(Q + (rg + 32 * i) * CS + d);
      if constexpr (SCALE) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[i][e] *= scale;
      }
    }
#pragma unroll
    for (int j = 0; j < SC; ++j)
      *reinterpret_cast<float4*>(b[j]) = *reinterpret_cast<const float4*>(K + (cg + 8 * j) * CS + d);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = fmaf(a[i][e], b[j][e], s[i][j]);
  }
}

// acc[i][r * 4 + e] (row rg + 32 i, column cg * 4 + 32 r + e of a window chunk) continues its fmaf chain over the
// tile's 64 keys c ascending of P[row][c] V[c][column] (V: the chunk tile of v).
__device__ __forceinline__ void pv(float (&acc)[SR][8], const float* P, const float* V, int rg, int cg) {
#pragma unroll 2
  for (int c = 0; c < fs::BT; c += 4) {
    float pr[SR][4];
#pragma unroll
    for (int i = 0; i < SR; ++i)
      *reinterpret_cast<float4*>(pr[i]) = *reinterpret_cast<const float4*>(P + (rg + 32 * i) * PS + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float vr[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float4*>(vr[r]) = *reinterpret_cast<const float4*>(V + (c + cc) * CS + cg * 4 + 32 * r);
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][r * 4 + e] = fmaf(pr[i][cc], vr[r][e], acc[i][r * 4 + e]);
    }
  }
}

}  // namespace ffma_wide

template <int D>
struct FfmaWideLayout {
  static constexpr bool RES = D != fw::WIDE;            // q held for the whole block (D = 256)
  static constexpr int TILE = fw::f32::TILE;            // bytes of a chunk tile
  static constexpr int ST = RES ? 8 : 6;                // ring stages
  static constexpr int STAGE = (RES ? 1 : 2) * TILE;    // a score step: k (and q); a product step: v
  static constexpr int OWN = RES ? (D / fw::CW) * TILE : 0;
  static constexpr int bytes = OWN + fs::BT * ffma_wide::PS * 4 + ST * STAGE;  // q, p, the ring (227,328 B)
};

// D: 256, or WIDE (dd, a multiple of 64 above 256, and the windows at run time).
template <int D>
__global__ void __launch_bounds__(fw::THREADS, 1)
flash_fwd_kernel_ffma_wide(fs::Operand<float> q, fs::Operand<float> k, fs::Operand<float> v, float* __restrict__ out,
                           float* __restrict__ lse, int L, int H, int dd, int wn, int causal, float scale) {
  using Lay = FfmaWideLayout<D>;
  using ffma_wide::SR;
  using ffma_wide::SC;
  constexpr int BT = fs::BT, CS = ffma_wide::CS, PS = ffma_wide::PS, TL = Lay::TILE / 4, ST = Lay::ST;
  extern __shared__ float4 smem_ffma_wide[];
  float* Qs = reinterpret_cast<float*>(smem_ffma_wide);  // D = 256: chunk c of q * scale at Qs + c TL
  float* Ps = Qs + Lay::OWN / 4;                         // p of the current k tile
  float* ring = Ps + BT * PS;
  const uint32_t s_ring = sm90::smem_addr(ring);

  const int tid = threadIdx.x;
  const int rg = tid / SC, cg = tid % SC;
  const fw::Place at = fw::place(dd, wn, L, H, causal);
  const int nch = Lay::RES ? D / fw::CW : at.nch;
  const int q0 = at.tile * BT;
  const int nkt = causal ? (min(L, q0 + BT) + BT - 1) / BT : (L + BT - 1) / BT;
  const int per = nch + at.nwin, steps = nkt * per;
  auto issue = [&](int u) {
    issue_step<float, CS, Lay::RES, 1>(u, steps, per, nch, nch, s_ring + (u % ST) * Lay::STAGE, Lay::TILE, q, k, v,
                                       at, q0, L);
  };
  if constexpr (Lay::RES) {
    for (int c = 0; c < nch; ++c)
      fw::load_chunk<float, CS>(sm90::smem_addr(Qs + c * TL), q.slice(at.b, at.h), q.l, c, q0, L, q.vec);
  }
  for (int u = 0; u < ST - 1; ++u) issue(u);  // the first group carries q too
  if constexpr (Lay::RES) {
    sm90::cp_async_wait<ST - 2>();
    __syncthreads();
    for (int i = tid; i < nch * BT * fw::CW; i += fw::THREADS)  // rows past L: 0
      Qs[(i / (BT * fw::CW)) * TL + (i / fw::CW % BT) * CS + i % fw::CW] *= scale;
  }

  float m[SR], den[SR], acc[fw::NWC][SR][8];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    m[i] = -INFINITY;
    den[i] = 0.f;
#pragma unroll
    for (int j = 0; j < fw::NWC; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j][i][e] = 0.f;
  }

  for (int t = 0; t < nkt; ++t) {
    float s[SR][SC];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 1
    for (int r = 0; r < nch; ++r) {
      const int u = t * per + r;
      sm90::cp_async_wait<ST - 2>();
      __syncthreads();  // step u landed (and q is scaled); every thread is done with the stage the next issue refills
      issue(u + ST - 1);
      const float* K = ring + (u % ST) * (Lay::STAGE / 4);
      if constexpr (Lay::RES) {
        ffma_wide::scores<false>(s, Qs + r * TL, K, rg, cg, scale);
      } else {
        ffma_wide::scores<true>(s, K + TL, K, rg, cg, scale);
      }
    }
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int r = rg + 32 * i;
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
      for (int j = 0; j < fw::NWC; ++j) {
        if (j >= at.nwin) break;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[j][i][e] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < fw::NWC; ++j) {
      if (j >= at.nwin) break;
      const int u = t * per + nch + j;
      sm90::cp_async_wait<ST - 2>();
      __syncthreads();  // the v chunk landed; every row's p is in Ps
      issue(u + ST - 1);
      ffma_wide::pv(acc[j], Ps, ring + (u % ST) * (Lay::STAGE / 4), rg, cg);
    }
  }

  const long long rs = static_cast<long long>(H) * dd;
  float* base = out + static_cast<long long>(at.b) * L * rs + static_cast<long long>(at.h) * dd + at.c_lo * fw::CW +
                cg * 4;
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    const int row = q0 + rg + 32 * i;
    if (row >= L) continue;
    const float dn = fmaxf(den[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < fw::NWC; ++j) {
      if (j >= at.nwin) break;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float4*>(base + row * rs + j * fw::CW + 32 * r) =
            make_float4(acc[j][i][r * 4] / dn, acc[j][i][r * 4 + 1] / dn, acc[j][i][r * 4 + 2] / dn,
                        acc[j][i][r * 4 + 3] / dn);
    }
    if (at.c_lo == 0 && cg == 0) lse[(static_cast<long long>(at.b) * H + at.h) * L + row] = m[i] + logf(dn);
  }
}

// ---------------------------------------------------------- bf16: the tensor cores

template <int D>
struct MmaWideLayout {
  static constexpr bool RES = D != fw::WIDE;            // q held for the whole block (D = 256)
  static constexpr int TILE = fw::mma::TILE;            // bytes of a chunk tile (and of a split p half)
  static constexpr int G = RES ? D / fw::CW : 2;        // chunks a ring step carries: at D = 256 a whole k tile
  static constexpr int ST = 4;                          // ring stages
  static constexpr int STAGE = G * (RES ? 1 : 2) * TILE;  // a score step: k (and q); a product step: v
  static constexpr int OWN = RES ? (D / fw::CW) * TILE : 0;
  static constexpr int STATS = 4 * fs::BT * 4;          // each key half's row max, then its sum(p)
  static constexpr int bytes = OWN + 2 * TILE + STATS + ST * STAGE;  // q, p hi and lo, the stats, the ring
};

template <int D>
__global__ void __launch_bounds__(fw::THREADS, 1)
flash_fwd_kernel_mma_wide(fs::Operand<port::bf16> q, fs::Operand<port::bf16> k, fs::Operand<port::bf16> v,
                          port::bf16* __restrict__ out, float* __restrict__ lse, int L, int H, int dd, int wn,
                          int causal, float scale) {
  using Lay = MmaWideLayout<D>;
  using port::bf16;
  constexpr int BT = fs::BT, CS = fw::mma::CS, TILE = Lay::TILE, ST = Lay::ST, G = Lay::G;
  extern __shared__ float4 smem_mma_wide[];
  const uint32_t s_q = sm90::smem_addr(smem_mma_wide);  // chunk c of q at s_q + c TILE (D = 256)
  const uint32_t s_hi = s_q + Lay::OWN, s_lo = s_hi + TILE, s_ring = s_lo + TILE + Lay::STATS;
  // [0, BT): key half 0's row max, [BT, 2 BT): half 1's; then their sums of p
  float* stats = reinterpret_cast<float*>(reinterpret_cast<char*>(smem_mma_wide) + Lay::OWN + 2 * TILE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = warp >> 2, m0 = (warp & 3) * 16, n0 = half * 32;  // the warp's q rows; its keys and columns
  const fw::Place at = fw::place(dd, wn, L, H, causal);
  const int nch = Lay::RES ? D / fw::CW : at.nch;
  const int q0 = at.tile * BT;
  const int nkt = causal ? (min(L, q0 + BT) + BT - 1) / BT : (L + BT - 1) / BT;
  const int ns = (nch + G - 1) / G, per = ns + (at.nwin + G - 1) / G, steps = nkt * per;
  auto issue = [&](int u) {
    issue_step<bf16, CS, Lay::RES, G>(u, steps, per, ns, nch, s_ring + (u % ST) * Lay::STAGE, TILE, q, k, v, at, q0,
                                      L);
  };
  if constexpr (Lay::RES) {
    for (int c = 0; c < nch; ++c) fw::load_chunk<bf16, CS>(s_q + c * TILE, q.slice(at.b, at.h), q.l, c, q0, L, q.vec);
  }
  for (int u = 0; u < ST - 1; ++u) issue(u);  // the first group carries q too

  const int g = lane >> 2;  // the thread's rows of the tile: m0 + g (C regs 0, 1) and m0 + g + 8 (2, 3)
  float m[2] = {-INFINITY, -INFINITY}, den[2] = {0.f, 0.f};
  float acc[fw::NWC][4][4];
#pragma unroll
  for (int j = 0; j < fw::NWC; ++j)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;

  for (int t = 0; t < nkt; ++t) {
    float s[4][4];  // the warp's 16 rows x 32 keys
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int r = 0; r < ns; ++r) {
      const int u = t * per + r;
      sm90::cp_async_wait<ST - 2>();
      __syncthreads();  // step u landed; every warp is done with the stage the next issue refills
      issue(u + ST - 1);
      const uint32_t st = s_ring + (u % ST) * Lay::STAGE;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int c = r * G + i;
        if (c >= nch) break;
        const uint32_t sk = st + i * (Lay::RES ? 1 : 2) * TILE;
        fw::mma::scores(s, Lay::RES ? s_q + c * TILE : sk + TILE, m0, sk, n0, lane);
      }
    }
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + m0 + g + 8 * (e >> 1);
        const int key = t * BT + n0 + n * 8 + 2 * (lane & 3) + (e & 1);
        const bool masked = key >= L || (causal && key > row);
        s[n][e] = masked ? -INFINITY : s[n][e] * scale;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mt[hf] = fmaxf(mt[hf], __shfl_xor_sync(0xffffffffu, mt[hf], 1));
      mt[hf] = fmaxf(mt[hf], __shfl_xor_sync(0xffffffffu, mt[hf], 2));
      if ((lane & 3) == 0) stats[half * BT + m0 + g + 8 * hf] = mt[hf];
    }
    __syncthreads();  // both key halves' row maxima are in stats
    float m_use[2], corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = m0 + g + 8 * hf;
      const float m_new = fmaxf(m[hf], fmaxf(stats[r], stats[BT + r]));  // one order in both warps: one m
      m_use[hf] = m_new == -INFINITY ? 0.f : m_new;
      corr[hf] = expf(m[hf] - m_use[hf]);
      m[hf] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_use[e >> 1]);  // p
        psum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      psum[hf] += __shfl_xor_sync(0xffffffffu, psum[hf], 1);
      psum[hf] += __shfl_xor_sync(0xffffffffu, psum[hf], 2);
      if ((lane & 3) == 0) stats[(2 + half) * BT + m0 + g + 8 * hf] = psum[hf];
    }
#pragma unroll
    for (int j = 0; j < fw::NWC; ++j) {
      if (j >= at.nwin) break;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][n][e] *= corr[e >> 1];
    }
    fw::mma::store_split(s, s_hi, s_lo, m0, n0, lane);
    uint32_t a[2][4][4];
#pragma unroll
    for (int ps = 0; ps < fw::NWC / G; ++ps) {
      if (ps * G >= at.nwin) break;
      const int u = t * per + ns + ps;
      sm90::cp_async_wait<ST - 2>();
      __syncthreads();  // the v chunks landed; every warp's p and sum(p) are in shared memory
      issue(u + ST - 1);
      if (ps == 0) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = m0 + g + 8 * hf;
          den[hf] = den[hf] * corr[hf] + (stats[2 * BT + r] + stats[3 * BT + r]);
        }
        fw::mma::frags(a, s_hi, s_lo, m0, lane);
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int j = ps * G + i;
        if (j >= at.nwin) break;
        fw::mma::product(acc[j], a, s_ring + (u % ST) * Lay::STAGE + i * TILE, n0, lane);
      }
    }
  }

  const long long rs = static_cast<long long>(H) * dd;
  bf16* base = out + static_cast<long long>(at.b) * L * rs + static_cast<long long>(at.h) * dd + at.c_lo * fw::CW +
               n0 + (lane & 3) * 2;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + m0 + g + 8 * hf;
    if (row >= L) continue;
    const float dn = fmaxf(den[hf], 1e-30f);
    const float inv = 1.f / dn;  // one division a row, not 64 (each an FFMA sequence); below the bf16 rounding
#pragma unroll
    for (int j = 0; j < fw::NWC; ++j) {
      if (j >= at.nwin) break;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        *reinterpret_cast<__nv_bfloat162*>(base + row * rs + j * fw::CW + n * 8) =
            __floats2bfloat162_rn(acc[j][n][2 * hf] * inv, acc[j][n][2 * hf + 1] * inv);
    }
    if (half == 0 && at.c_lo == 0 && (lane & 3) == 0)
      lse[(static_cast<long long>(at.b) * H + at.h) * L + row] = m[hf] + logf(dn);
  }
}

// ------------------------------------------------------------------ launch

template <typename T, int D>
int launch_wide(const void* q, const void* k, const void* v, void* out, void* lse, int B, int L, int H, int dd,
                Strides sq, Strides sk, Strides sv, int causal, float scale, cudaStream_t stream) {
  const auto oq = fs::operand<T>(q, sq.b, sq.l, sq.h), ok = fs::operand<T>(k, sk.b, sk.l, sk.h);
  const auto ov = fs::operand<T>(v, sv.b, sv.l, sv.h);
  dim3 grid;
  int wn;
  if (!fw::grid_for(B, L, H, dd, grid, wn)) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto kernel, int bytes) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, fw::THREADS, bytes, stream>>>(oq, ok, ov, static_cast<T*>(out), static_cast<float*>(lse), L, H,
                                                 dd, wn, causal, scale);
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (std::is_same<T, float>::value) return run(flash_fwd_kernel_ffma_wide<D>, FfmaWideLayout<D>::bytes);
  else return run(flash_fwd_kernel_mma_wide<D>, MmaWideLayout<D>::bytes);
}

template <typename T, int D>
int launch_sm90(const void* q, const void* k, const void* v, void* out, void* lse, int B, int L, int H,
                Strides sq, Strides sk, Strides sv, int causal, float scale, cudaStream_t stream) {
  const auto oq = fs::operand<T>(q, sq.b, sq.l, sq.h), ok = fs::operand<T>(k, sk.b, sk.l, sk.h);
  const auto ov = fs::operand<T>(v, sv.b, sv.l, sv.h);
  const long long blocks = static_cast<long long>((L + fs::BT - 1) / fs::BT) * B * H;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
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
    case 256: return launch_wide<T, 256>(q, k, v, out, lse, B, L, H, D, sq, sk, sv, causal, scale, st);
    default:
      if (D > 256 && D % fw::CW == 0)
        return launch_wide<T, fw::WIDE>(q, k, v, out, lse, B, L, H, D, sq, sk, sv, causal, scale, st);
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
