// Flash-attention backward, dQ: the FA-2 recompute for one q tile.
//
// Replaces the TPU kernel _dq_kernel (cuda_mpi_gpu_cluster_programming_tpu/
// ops/flash_attention.py, pallas_call in _flash_backward). For q, k, v and
// the output gradient g (dO), each (B, L, H, D) fp32 or bf16, and the fp32
// lse and delta (B, H, L) (delta = sum_d dO o, shifted by -g_lse for the
// joint (out, lse) gradient), it writes dq (B, L, H, D) in q's type:
//   s = (q * scale) k^T, p = exp(s - lse), dS = p * (dO v^T - delta),
//   dq = scale * sum over k tiles of dS k.
// Causal rows see keys at positions <= their own.
//
// Bound on the H100: operations (3 products of 2 B H L^2 D FLOPs, half of
// that causal, against 5 reads/writes of B L H D elements): FFMA's 67
// TFLOP/s in fp32, the tensor cores' 989 in bf16. One block per (b, h,
// 64-row q tile), heaviest causal tiles first; 64-key K/V tiles stream
// through shared memory by cp.async, and k tiles wholly above the diagonal
// are not visited. All of it over flash_bwd_sm90.cuh. At D <= 128, 128
// threads:
//   * fp32, flash_dq_kernel_ffma: FFMA in the first FFMA kernel's operations
//     and order (its bits): a thread's 4 x 8 s and dp in registers, dS
//     through shared memory, the dq sums in registers; K double-buffered, V
//     refilled while dS k runs (103 KB of shared memory at D = 64: two
//     blocks an SM).
//   * bf16, flash_dq_kernel_mma: mma.sync on the tensor cores, a warp's 16
//     q rows; dS k from the C fragments re-packed as A fragments, dS split
//     into two bf16 terms; a 3-stage K/V ring (2 at D = 128).
// D = 256 and D > 256 (the WIDE instance, any multiple of 64; one block per
// (b, h, q tile, window of 256 dq columns, or 128 on a grid smaller than
// the card)), 256 threads, the operands in 64-column chunks through a
// cp.async ring (the wide namespace):
//   * fp32, flash_dq_kernel_ffma_wide: the same bits; a thread's 4 x 4 s and
//     dp, then 4 x 4 of each window chunk of dq in registers (64 a thread);
//     every chunk of q, dO, k and v streams (a 3-stage ring of 4 chunk tiles,
//     221 KB with the dS tile).
//   * bf16, flash_dq_kernel_mma_wide: mma.sync, the score tile split 4 row
//     groups x 2 key halves over the warps, dS split into hi and lo in shared
//     memory, each warp 16 rows x 32 columns of each window chunk of dq. At
//     D = 256 q and dO stay in shared memory (72 KB) and a 4-stage ring
//     carries the k and v chunks; above it every operand streams.
//
// Ragged tiles and masking: a q row or key past L loads as 0, and its p is
// set to exactly 0, as is a key above the causal diagonal, so it adds 0 to
// every sum; lse and delta are not read past L.
#include <type_traits>

#include "flash_bwd_sm90.cuh"

namespace {

// ------------------------------------------------------------------ D <= 128 (flash_bwd_sm90.cuh)

namespace fs = flash_sm90;
using fs::Strides;

template <int D>
struct FfmaLayout {
  static constexpr int S = fs::f32::RS<D>;
  // dS rows: a warp's stores (4 row groups 16 apart x 8 keys) land in 32 distinct banks
  static constexpr int PS = 72;
  static constexpr int bytes = 4 * (5 * fs::BT * S + fs::BT * PS);  // q, dO, k (2 buffers), v, dS
};

template <int D>
__global__ void __launch_bounds__(fs::THREADS)
flash_dq_kernel_ffma(fs::Operand<float> q, fs::Operand<float> k, fs::Operand<float> v, fs::Operand<float> g,
                     const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq, int L,
                     int H, int causal, float scale) {
  using Lay = FfmaLayout<D>;
  using O = fs::f32::Out<D>;
  constexpr int BT = fs::BT, S = Lay::S, PS = Lay::PS;
  extern __shared__ float4 smem_ffma[];
  float* Qs = reinterpret_cast<float*>(smem_ffma);  // raw q: the scores scale it
  float* Gs = Qs + BT * S;
  float* K0 = Gs + BT * S;
  float* K1 = K0 + BT * S;
  float* Vs = K1 + BT * S;
  float* Ps = Vs + BT * S;  // dS of the current k tile

  const int tid = threadIdx.x;
  const int rg = tid / fs::f32::SC, cg = tid % fs::f32::SC;
  const int pr = tid / O::CG, pc = tid % O::CG;
  const int nt = (L + BT - 1) / BT;
  const fs::Place at = fs::place(nt, H, causal);
  const int q0 = at.tile * BT, h = at.h, b = at.b;
  const float* kb = k.slice(b, h);
  const float* vb = v.slice(b, h);
  fs::load_tile<float, D, S>(sm90::smem_addr(Qs), q.slice(b, h), q.l, q0, L, q.vec);
  fs::load_tile<float, D, S>(sm90::smem_addr(Gs), g.slice(b, h), g.l, q0, L, g.vec);
  fs::load_tile<float, D, S>(sm90::smem_addr(K0), kb, k.l, 0, L, k.vec);
  fs::load_tile<float, D, S>(sm90::smem_addr(Vs), vb, v.l, 0, L, v.vec);
  sm90::cp_async_commit();
  const long long stat = (static_cast<long long>(b) * H + h) * L;
  float lse_r[fs::f32::SR], del_r[fs::f32::SR];
#pragma unroll
  for (int i = 0; i < fs::f32::SR; ++i) {
    const int row = q0 + rg + 16 * i;
    lse_r[i] = row < L ? lse[stat + row] : 0.f;
    del_r[i] = row < L ? delta[stat + row] : 0.f;
  }
  fs::f32::Acc<D, false> acc;
  acc.zero();

  const int k_end = causal ? min(L, q0 + BT) : L;
  for (int k0 = 0; k0 < k_end; k0 += BT) {
    const bool odd = (k0 / BT) & 1;
    float* Kc = odd ? K1 : K0;
    sm90::cp_async_wait<0>();
    __syncthreads();  // k and v of this tile landed; every reader of the last tile's dS and k is done
    if (k0 + BT < k_end) fs::load_tile<float, D, S>(sm90::smem_addr(odd ? K0 : K1), kb, k.l, k0 + BT, L, k.vec);
    sm90::cp_async_commit();
    float s[fs::f32::SR][fs::f32::SC], dp[fs::f32::SR][fs::f32::SC];
    fs::f32::scores<D>(s, dp, Qs, Gs, Kc, Vs, rg, cg, scale);
#pragma unroll
    for (int i = 0; i < fs::f32::SR; ++i) {
      const int row = q0 + rg + 16 * i;
#pragma unroll
      for (int j = 0; j < fs::f32::SC; ++j) {
        const int key = k0 + cg + 8 * j;
        const bool masked = row >= L || key >= L || (causal && key > row);
        const float p = masked ? 0.f : expf(s[i][j] - lse_r[i]);
        Ps[(rg + 16 * i) * PS + cg + 8 * j] = p * (dp[i][j] - del_r[i]);
      }
    }
    __syncthreads();  // every row's dS is in Ps; v is read
    if (k0 + BT < k_end) fs::load_tile<float, D, S>(sm90::smem_addr(Vs), vb, v.l, k0 + BT, L, v.vec);
    sm90::cp_async_commit();
    fs::f32::product<D, PS, false>(acc, Ps, Kc, pr, pc);
  }
  fs::f32::store<D, false>(dq, acc, b, h, q0, L, H, scale, pr, pc);
}

template <int D>
struct MmaLayout {
  static constexpr int S = fs::mma::RS<D>;
  static constexpr int STAGES = D <= 64 ? 3 : 2;  // the K/V ring
  static constexpr int TILE = fs::BT * S * 2;     // bytes of a tile
  static constexpr int bytes = TILE * (2 + 2 * STAGES);
};

template <int D>
__global__ void __launch_bounds__(fs::THREADS)
flash_dq_kernel_mma(fs::Operand<port::bf16> q, fs::Operand<port::bf16> k, fs::Operand<port::bf16> v,
                    fs::Operand<port::bf16> g, const float* __restrict__ lse, const float* __restrict__ delta,
                    port::bf16* __restrict__ dq, int L, int H, int causal, float scale) {
  using Lay = MmaLayout<D>;
  constexpr int BT = fs::BT, S = Lay::S, ST = Lay::STAGES, TILE = Lay::TILE;
  extern __shared__ float4 smem_mma[];
  const uint32_t sQ = sm90::smem_addr(smem_mma), sG = sQ + TILE, sKV = sG + TILE;  // stage st: k, then v

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
  fs::load_tile<port::bf16, D, S>(sG, g.slice(b, h), g.l, q0, L, g.vec);
  for (int t = 0; t < ST - 1; ++t) load_kv(t);

  const int m0 = warp * 16;
  const int row_lo = q0 + m0 + (lane >> 2);  // the thread's rows: row_lo (C regs 0, 1) and row_lo + 8 (2, 3)
  const long long stat = (static_cast<long long>(b) * H + h) * L;
  float lse_r[2], del_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row_lo + 8 * hf;
    lse_r[hf] = row < L ? lse[stat + row] : 0.f;
    del_r[hf] = row < L ? delta[stat + row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < nkt; ++t) {
    sm90::cp_async_wait<ST - 2>();
    __syncthreads();  // tile t landed; every warp is done with the stage the next load refills
    load_kv(t + ST - 1);
    const uint32_t sK = sKV + (t % ST) * 2 * TILE, sV = sK + TILE;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    fs::mma::scores<D>(s, sQ, m0, sK, lane);
    fs::mma::scores<D>(dp, sG, m0, sV, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_lo + 8 * (e >> 1);
        const int key = t * BT + n * 8 + 2 * (lane & 3) + (e & 1);
        const bool masked = row >= L || key >= L || (causal && key > row);
        const float p = masked ? 0.f : expf(s[n][e] * scale - lse_r[e >> 1]);
        s[n][e] = p * (dp[n][e] - del_r[e >> 1]);  // dS
      }
    uint32_t hi[4][4], lo[4][4];
    fs::mma::as_a(s, hi, lo);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) fs::mma::product_pair<D>(acc[2 * np], acc[2 * np + 1], hi, lo, sK, np, lane);
  }
  fs::mma::store<D>(dq, acc, b, h, q0, m0, L, H, scale, lane);
}

template <typename T, int D>
int launch_sm90(const void* q, const void* k, const void* v, const void* g, const void* lse, const void* delta,
                void* dq, int B, int L, int H, Strides sq, Strides sk, Strides sv, Strides sg, int causal,
                float scale, cudaStream_t stream) {
  const auto oq = fs::operand<T>(q, sq.b, sq.l, sq.h), ok = fs::operand<T>(k, sk.b, sk.l, sk.h);
  const auto ov = fs::operand<T>(v, sv.b, sv.l, sv.h), og = fs::operand<T>(g, sg.b, sg.l, sg.h);
  const long long blocks = static_cast<long long>((L + fs::BT - 1) / fs::BT) * B * H;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  auto run = [&](auto kernel, int bytes) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, fs::THREADS, bytes, stream>>>(oq, ok, ov, og, static_cast<const float*>(lse),
                                                 static_cast<const float*>(delta),
                                                 static_cast<T*>(dq), L, H, causal, scale);
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (std::is_same<T, float>::value) return run(flash_dq_kernel_ffma<D>, FfmaLayout<D>::bytes);
  else return run(flash_dq_kernel_mma<D>, MmaLayout<D>::bytes);
}

// ------------------------------------------------------------------ D = 256 and WIDE (the wide namespace)

namespace fw = flash_sm90::wide;

template <int D>
struct FfmaWideLayout {
  static constexpr int TILE = fw::f32::TILE;
  static constexpr int ST = 3;                               // ring stages
  static constexpr int STAGE = 4 * TILE;                     // k, v, q, dO chunks (a product step: k)
  static constexpr int bytes = TILE + ST * STAGE;            // dS, the ring
};

// D: 256, or WIDE (dd, a multiple of 64 above 256, and the windows at run time).
template <int D>
__global__ void __launch_bounds__(fw::THREADS, 1)
flash_dq_kernel_ffma_wide(fs::Operand<float> q, fs::Operand<float> k, fs::Operand<float> v, fs::Operand<float> g,
                          const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
                          int L, int H, int dd, int wn, int causal, float scale) {
  using Lay = FfmaWideLayout<D>;
  constexpr int BT = fs::BT, CS = fw::f32::CS, TL = Lay::TILE / 4, ST = Lay::ST;
  extern __shared__ float4 smem_ffma_wide[];
  float* Ps = reinterpret_cast<float*>(smem_ffma_wide);  // dS of the current k tile
  float* ring = Ps + TL;
  const uint32_t s_ring = sm90::smem_addr(ring);

  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;  // scores: q rows rg + 16 i, keys cg + 16 j; dq: rows rg * 4 + i
  const fw::Place at = fw::place(dd, wn, L, H, causal);
  const int nch = D == fw::WIDE ? at.nch : D / fw::CW;
  const int q0 = at.tile * BT;
  const float *qb = q.slice(at.b, at.h), *kb = k.slice(at.b, at.h);
  const float *vb = v.slice(at.b, at.h), *gb = g.slice(at.b, at.h);
  const int nkt = causal ? (min(L, q0 + BT) + BT - 1) / BT : (L + BT - 1) / BT;
  const int per = nch + at.nwin, steps = nkt * per;
  // step u of the schedule into stage u % ST: score step r < nch of k tile t loads chunk r of k, v, q, dO;
  // product step r >= nch window chunk c_lo + r - nch of k
  auto issue = [&](int u) {
    if (u < steps) {
      const int t = u / per, r = u % per;
      const uint32_t st = s_ring + (u % ST) * Lay::STAGE;
      if (r < nch) {
        fw::load_chunk<float, CS>(st, kb, k.l, r, t * BT, L, k.vec);
        fw::load_chunk<float, CS>(st + Lay::TILE, vb, v.l, r, t * BT, L, v.vec);
        fw::load_chunk<float, CS>(st + 2 * Lay::TILE, qb, q.l, r, q0, L, q.vec);
        fw::load_chunk<float, CS>(st + 3 * Lay::TILE, gb, g.l, r, q0, L, g.vec);
      } else {
        fw::load_chunk<float, CS>(st, kb, k.l, at.c_lo + r - nch, t * BT, L, k.vec);
      }
    }
    sm90::cp_async_commit();
  };
  for (int u = 0; u < ST - 1; ++u) issue(u);
  const long long stat = (static_cast<long long>(at.b) * H + at.h) * L;
  float lse_r[4], del_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    lse_r[i] = row < L ? lse[stat + row] : 0.f;
    del_r[i] = row < L ? delta[stat + row] : 0.f;
  }
  float acc[fw::NWC][4][4];
#pragma unroll
  for (int j = 0; j < fw::NWC; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.f;

  for (int t = 0; t < nkt; ++t) {
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 1
    for (int r = 0; r < nch; ++r) {
      const int u = t * per + r;
      sm90::cp_async_wait<ST - 2>();
      __syncthreads();  // step u landed; every thread is done with the stage the next issue refills
      issue(u + ST - 1);
      const float* st = ring + (u % ST) * (Lay::STAGE / 4);
      fw::f32::scores(s, dp, st + 2 * TL, st + 3 * TL, st, st + TL, rg, cg, scale);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t * BT + cg + 16 * j;
        const bool masked = row >= L || key >= L || (causal && key > row);
        const float p = masked ? 0.f : expf(s[i][j] - lse_r[i]);
        Ps[(rg + 16 * i) * CS + cg + 16 * j] = p * (dp[i][j] - del_r[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < fw::NWC; ++j) {
      if (j >= at.nwin) break;
      const int u = t * per + nch + j;
      sm90::cp_async_wait<ST - 2>();
      __syncthreads();  // the k chunk landed; every row's dS is in Ps
      issue(u + ST - 1);
      fw::f32::product(acc[j], Ps, ring + (u % ST) * (Lay::STAGE / 4), rg, cg);
    }
  }
  fw::f32::store(dq, acc, at, q0, rg, cg, L, H, dd, scale);
}

template <int D>
struct MmaWideLayout {
  static constexpr bool RES = D != fw::WIDE;          // q and dO held for the whole block (D = 256)
  static constexpr int TILE = fw::mma::TILE;
  static constexpr int ST = 4;                         // ring stages
  static constexpr int STAGE = (RES ? 2 : 4) * TILE;  // k, v (and q, dO) chunks; a product step: k
  static constexpr int OWN = RES ? 2 * (D / fw::CW) * TILE : 0;
  static constexpr int bytes = OWN + 2 * TILE + ST * STAGE;  // q and dO, dS hi and lo, the ring
  // D = 256: a tile's four score steps fill the four stages, the window's chunks first (chunk c_lo + r at step
  // r), and product step j finds chunk c_lo + j of k where score step j left it and loads nothing
  static_assert(!RES || ST == D / fw::CW, "the D = 256 ring holds one tile's chunks");
};

template <int D>
__global__ void __launch_bounds__(fw::THREADS, 1)
flash_dq_kernel_mma_wide(fs::Operand<port::bf16> q, fs::Operand<port::bf16> k, fs::Operand<port::bf16> v,
                         fs::Operand<port::bf16> g, const float* __restrict__ lse, const float* __restrict__ delta,
                         port::bf16* __restrict__ dq, int L, int H, int dd, int wn, int causal, float scale) {
  using Lay = MmaWideLayout<D>;
  using port::bf16;
  constexpr int BT = fs::BT, CS = fw::mma::CS, TILE = Lay::TILE, ST = Lay::ST;
  extern __shared__ float4 smem_mma_wide[];
  const uint32_t s_own = sm90::smem_addr(smem_mma_wide);  // chunk c of q, then of dO (D = 256)
  const uint32_t s_hi = s_own + Lay::OWN, s_lo = s_hi + TILE, s_ring = s_lo + TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;  // the warp's q rows; its keys and its columns of a chunk
  const fw::Place at = fw::place(dd, wn, L, H, causal);
  const int nch = D == fw::WIDE ? at.nch : D / fw::CW;
  const int q0 = at.tile * BT;
  const bf16 *qb = q.slice(at.b, at.h), *kb = k.slice(at.b, at.h);
  const bf16 *vb = v.slice(at.b, at.h), *gb = g.slice(at.b, at.h);
  const int nkt = causal ? (min(L, q0 + BT) + BT - 1) / BT : (L + BT - 1) / BT;
  const int per = nch + at.nwin, steps = nkt * per;
  // Step u (score step or product step r of k tile t): score step r < nch loads chunk r of k and v (at
  // D = 256 chunk c_lo + r, mod 4) and, above 256, of q and dO; product step r >= nch window chunk
  // c_lo + r - nch of k (at D = 256 already there). Its stage: u % ST, or at D = 256 (t nwin + r) % ST, the
  // product steps' that of the score step that left their chunk: a tile's stages of score steps past the
  // window are refilled first, those of the window only once its products are done.
  auto stage = [&](int u, int t, int r) {
    return s_ring + ((Lay::RES ? t * at.nwin + r : u) % ST) * Lay::STAGE;
  };
  auto issue = [&](int u) {
    if (u < steps) {
      const int t = u / per, r = u % per;
      const uint32_t st = stage(u, t, r);
      if (r < nch) {
        const int c = Lay::RES ? (at.c_lo + r) % nch : r;
        fw::load_chunk<bf16, CS>(st, kb, k.l, c, t * BT, L, k.vec);
        fw::load_chunk<bf16, CS>(st + TILE, vb, v.l, c, t * BT, L, v.vec);
        if constexpr (!Lay::RES) {
          fw::load_chunk<bf16, CS>(st + 2 * TILE, qb, q.l, r, q0, L, q.vec);
          fw::load_chunk<bf16, CS>(st + 3 * TILE, gb, g.l, r, q0, L, g.vec);
        }
      } else if constexpr (!Lay::RES) {
        fw::load_chunk<bf16, CS>(st, kb, k.l, at.c_lo + r - nch, t * BT, L, k.vec);
      }
    }
    sm90::cp_async_commit();
  };
  if constexpr (Lay::RES) {
    for (int c = 0; c < nch; ++c) {
      fw::load_chunk<bf16, CS>(s_own + c * TILE, qb, q.l, c, q0, L, q.vec);
      fw::load_chunk<bf16, CS>(s_own + (nch + c) * TILE, gb, g.l, c, q0, L, g.vec);
    }
  }
  for (int u = 0; u < ST - 1; ++u) issue(u);  // the first group carries q and dO too

  const int row_lo = q0 + m0 + (lane >> 2);  // the thread's rows: row_lo (C regs 0, 1) and row_lo + 8 (2, 3)
  const long long stat = (static_cast<long long>(at.b) * H + at.h) * L;
  float lse_r[2], del_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row_lo + 8 * hf;
    lse_r[hf] = row < L ? lse[stat + row] : 0.f;
    del_r[hf] = row < L ? delta[stat + row] : 0.f;
  }
  float acc[fw::NWC][4][4];
#pragma unroll
  for (int j = 0; j < fw::NWC; ++j)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;

  for (int t = 0; t < nkt; ++t) {
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    for (int r = 0; r < nch; ++r) {
      const int u = t * per + r;
      sm90::cp_async_wait<ST - 2>();
      __syncthreads();  // step u landed; every warp is done with the stage the next issue refills
      issue(u + ST - 1);
      const uint32_t st = stage(u, t, r);
      const int c = (at.c_lo + r) % nch;
      const uint32_t sq = Lay::RES ? s_own + c * TILE : st + 2 * TILE;
      const uint32_t sg = Lay::RES ? s_own + (nch + c) * TILE : st + 3 * TILE;
      fw::mma::scores(s, sq, m0, st, n0, lane);
      fw::mma::scores(dp, sg, m0, st + TILE, n0, lane);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_lo + 8 * (e >> 1);
        const int key = t * BT + n0 + n * 8 + 2 * (lane & 3) + (e & 1);
        const bool masked = row >= L || key >= L || (causal && key > row);
        const float p = masked ? 0.f : expf(s[n][e] * scale - lse_r[e >> 1]);
        s[n][e] = p * (dp[n][e] - del_r[e >> 1]);  // dS
      }
    fw::mma::store_split(s, s_hi, s_lo, m0, n0, lane);
    uint32_t a[2][4][4];
#pragma unroll
    for (int j = 0; j < fw::NWC; ++j) {
      if (j >= at.nwin) break;
      const int u = t * per + nch + j;
      sm90::cp_async_wait<ST - 2>();
      __syncthreads();  // the k chunk landed; every warp's dS is in shared memory
      issue(u + ST - 1);
      if (j == 0) fw::mma::frags(a, s_hi, s_lo, m0, lane);
      fw::mma::product(acc[j], a, stage(u, t, j), n0, lane);
    }
  }
  fw::mma::store(dq, acc, at, q0, m0, n0, L, H, dd, scale, lane);
}

template <typename T, int D>
int launch_wide(const void* q, const void* k, const void* v, const void* g, const void* lse, const void* delta,
                void* dq, int B, int L, int H, int dd, Strides sq, Strides sk, Strides sv, Strides sg, int causal,
                float scale, cudaStream_t stream) {
  const auto oq = fs::operand<T>(q, sq.b, sq.l, sq.h), ok = fs::operand<T>(k, sk.b, sk.l, sk.h);
  const auto ov = fs::operand<T>(v, sv.b, sv.l, sv.h), og = fs::operand<T>(g, sg.b, sg.l, sg.h);
  dim3 grid;
  int wn;
  if (!fw::grid_for(B, L, H, dd, grid, wn)) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto kernel, int bytes) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, fw::THREADS, bytes, stream>>>(oq, ok, ov, og, static_cast<const float*>(lse),
                                                 static_cast<const float*>(delta), static_cast<T*>(dq), L, H,
                                                 dd, wn, causal, scale);
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (std::is_same<T, float>::value) return run(flash_dq_kernel_ffma_wide<D>, FfmaWideLayout<D>::bytes);
  else return run(flash_dq_kernel_mma_wide<D>, MmaWideLayout<D>::bytes);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g, const void* lse, const void* delta,
           void* dq, int B, int L, int H, int D, long long qb, long long ql, long long qh, long long kb,
           long long kl, long long kh, long long vb, long long vl, long long vh, long long gb, long long gl,
           long long gh, int causal, float scale, void* stream) {
  const Strides sq{qb, ql, qh}, sk{kb, kl, kh}, sv{vb, vl, vh}, sg{gb, gl, gh};
  const auto st = static_cast<cudaStream_t>(stream);
#define FLASH_DQ_WIDE(I) launch_wide<T, I>(q, k, v, g, lse, delta, dq, B, L, H, D, sq, sk, sv, sg, causal, scale, st)
#define FLASH_DQ_SM90(I) launch_sm90<T, I>(q, k, v, g, lse, delta, dq, B, L, H, sq, sk, sv, sg, causal, scale, st)
  switch (D) {
    case 16: return FLASH_DQ_SM90(16);
    case 32: return FLASH_DQ_SM90(32);
    case 64: return FLASH_DQ_SM90(64);
    case 128: return FLASH_DQ_SM90(128);
    case 256: return FLASH_DQ_WIDE(256);
    default:
      if (D > 256 && D % fw::CW == 0) return FLASH_DQ_WIDE(fw::WIDE);
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_DQ_WIDE
#undef FLASH_DQ_SM90
}

}  // namespace

#define FLASH_DQ_ARGS                                                                                        \
  const void *q, const void *k, const void *v, const void *g, const void *lse, const void *delta, void *dq,  \
      int B, int L, int H, int D, long long qb, long long ql, long long qh, long long kb, long long kl,       \
      long long kh, long long vb, long long vl, long long vh, long long gb, long long gl, long long gh,      \
      int causal, float scale, void *stream
#define FLASH_DQ_PASS \
  q, k, v, g, lse, delta, dq, B, L, H, D, qb, ql, qh, kb, kl, kh, vb, vl, vh, gb, gl, gh, causal, scale, stream

extern "C" int flash_dq_f32(FLASH_DQ_ARGS) { return launch<float>(FLASH_DQ_PASS); }

extern "C" int flash_dq_bf16(FLASH_DQ_ARGS) { return launch<port::bf16>(FLASH_DQ_PASS); }
