// Flash-attention backward, dK and dV: the FA-2 recompute for one k tile.
//
// Replaces the TPU kernel _dkv_kernel (cuda_mpi_gpu_cluster_programming_tpu/
// ops/flash_attention.py, pallas_call in _flash_backward). For q, k, v and
// the output gradient g (dO), each (B, L, H, D) fp32 or bf16, and the fp32
// lse and delta (B, H, L), it writes dk and dv (B, L, H, D) in k's and v's
// type:
//   s = (q * scale) k^T, p = exp(s - lse), dS = p * (dO v^T - delta),
//   dv = sum over q tiles of p^T dO,
//   dk = scale * sum over q tiles of dS^T q (the unscaled q, then the scale,
//   as _dkv_kernel multiplies).
// Causal: a key gets gradient from the q rows at positions >= its own.
//
// Bound on the H100: operations (4 products of 2 B H L^2 D FLOPs, half of
// that causal, against 6 reads/writes of B L H D elements): FFMA's 67
// TFLOP/s in fp32, the tensor cores' 989 in bf16. One block per (b, h,
// 64-key tile); 64-row q/dO tiles stream through shared memory by cp.async,
// from the diagonal tile on (causal: the first k tiles, launched first, are
// the heaviest). All of it over flash_bwd_sm90.cuh. At D <= 128, 128
// threads, the K and V tiles held for the whole block:
//   * fp32, flash_dkv_kernel_ffma: FFMA in the first FFMA kernel's
//     operations and order (its bits): a thread's 4 x 8 s and dp in
//     registers, p^T and then dS^T through one shared tile to the p^T dO and
//     dS^T q products, the dK and dV sums in registers; q double-buffered,
//     dO refilled while dS^T q runs (102 KB of shared memory at D = 64: two
//     blocks an SM). At D = 128 the two accumulators (128 registers a
//     thread) live in shared memory, laid out per thread, and q is
//     single-buffered (213 KB).
//   * bf16, flash_dkv_kernel_mma: mma.sync on the tensor cores, a warp's 16
//     keys; s^T = k q^T and dp^T = v dO^T, then p^T dO and dS^T q from the C
//     fragments re-packed as A fragments, p and dS split into two bf16
//     terms; a 3-stage q/dO ring (2 at D = 128). At D = 128 the dK
//     accumulators live in shared memory, laid out per thread (see the
//     kernel).
// D = 256 and D > 256 (the WIDE instance, any multiple of 64; one block per
// (b, h, k tile, window of 256 dk and dv columns, or 128 on a grid smaller
// than the card)), 256 threads, the operands in 64-column chunks through a
// cp.async ring (the wide namespace):
//   * fp32, flash_dkv_kernel_ffma_wide: the same bits; a thread's 4 x 4 s
//     and dp, p^T and then dS^T through one shared tile, 4 x 4 of each
//     window chunk of dk and of dv in registers (128 a thread); every chunk
//     of q, dO, k and v streams (a 3-stage ring of 4 chunk tiles, 221 KB).
//   * bf16, flash_dkv_kernel_mma_wide: mma.sync, s^T and dp^T split 4 key
//     groups x 2 q-row halves over the warps, p^T and dS^T split into hi and
//     lo in shared memory, each warp 16 keys x 32 columns of each window
//     chunk of dv and dk. At D = 256 k and v stay in shared memory (72 KB)
//     and a 4-stage ring carries the q and dO chunks; above it every operand
//     streams.
//
// Ragged tiles and masking: a key or q row past L loads as 0, and its p is
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
  // p^T / dS^T rows (keys): a warp's stores (8 keys 8 apart x 4 row groups 16 apart) land in 32 distinct banks
  static constexpr int PS = 68;
  static constexpr int QBUF = D <= 64 ? 2 : 1;  // q tiles in shared memory
  static constexpr bool SMEM_ACC = D > 64;      // dK and dV sums in shared memory
  static constexpr int ACC = SMEM_ACC ? 2 * fs::f32::Out<D>::N * fs::THREADS * 4 : 0;
  static constexpr int bytes = ACC + 4 * ((3 + QBUF) * fs::BT * S + fs::BT * PS);  // k, v, q, dO, p^T/dS^T
};

template <int D>
__global__ void __launch_bounds__(fs::THREADS)
flash_dkv_kernel_ffma(fs::Operand<float> q, fs::Operand<float> k, fs::Operand<float> v, fs::Operand<float> g,
                      const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int L, int H, int causal, float scale) {
  using Lay = FfmaLayout<D>;
  using O = fs::f32::Out<D>;
  constexpr int BT = fs::BT, S = Lay::S, PS = Lay::PS;
  constexpr bool SA = Lay::SMEM_ACC;
  extern __shared__ float4 smem_ffma[];
  float4* acc_s = smem_ffma;
  float* Ks = reinterpret_cast<float*>(smem_ffma) + Lay::ACC / 4;
  float* Vs = Ks + BT * S;
  float* Q0 = Vs + BT * S;  // q tiles, unscaled (the scores scale them)
  float* Q1 = Q0 + (Lay::QBUF - 1) * BT * S;
  float* Gs = Q1 + BT * S;
  float* Ps = Gs + BT * S;  // p^T, then dS^T, of the current q tile

  const int tid = threadIdx.x;
  const int rg = tid / fs::f32::SC, cg = tid % fs::f32::SC;
  const int pr = tid / O::CG, pc = tid % O::CG;
  const fs::Place at = fs::place((L + BT - 1) / BT, H, false);
  const int k0 = at.tile * BT, h = at.h, b = at.b;
  const float* qb = q.slice(b, h);
  const float* gb = g.slice(b, h);
  const float* lse_b = lse + (static_cast<long long>(b) * H + h) * L;
  const float* del_b = delta + (static_cast<long long>(b) * H + h) * L;
  // The tiles are square, so the first q tile that sees a key of this tile is the diagonal one.
  const int q_start = causal ? k0 : 0;
  fs::load_tile<float, D, S>(sm90::smem_addr(Ks), k.slice(b, h), k.l, k0, L, k.vec);
  fs::load_tile<float, D, S>(sm90::smem_addr(Vs), v.slice(b, h), v.l, k0, L, v.vec);
  fs::load_tile<float, D, S>(sm90::smem_addr(Q0), qb, q.l, q_start, L, q.vec);
  fs::load_tile<float, D, S>(sm90::smem_addr(Gs), gb, g.l, q_start, L, g.vec);
  sm90::cp_async_commit();
  fs::f32::Acc<D, SA> acc_k, acc_v;
  acc_k.s = acc_s;
  acc_v.s = acc_s + O::N / 4 * fs::THREADS;
  acc_k.zero();
  acc_v.zero();

  for (int q0 = q_start; q0 < L; q0 += BT) {
    const bool odd = Lay::QBUF == 2 && ((q0 - q_start) / BT) & 1;
    float* Qc = odd ? Q1 : Q0;
    sm90::cp_async_wait<0>();
    __syncthreads();  // q and dO of this tile landed; every reader of the last tile is done
    if (Lay::QBUF == 2 && q0 + BT < L) {
      fs::load_tile<float, D, S>(sm90::smem_addr(odd ? Q0 : Q1), qb, q.l, q0 + BT, L, q.vec);
    }
    sm90::cp_async_commit();
    float lse_c[fs::f32::SR], del_c[fs::f32::SR];
#pragma unroll
    for (int i = 0; i < fs::f32::SR; ++i) {
      const int row = q0 + rg + 16 * i;
      lse_c[i] = row < L ? lse_b[row] : 0.f;
      del_c[i] = row < L ? del_b[row] : 0.f;
    }
    float s[fs::f32::SR][fs::f32::SC], dp[fs::f32::SR][fs::f32::SC];
    fs::f32::scores<D>(s, dp, Qc, Gs, Ks, Vs, rg, cg, scale);
#pragma unroll
    for (int i = 0; i < fs::f32::SR; ++i) {
      const int row = q0 + rg + 16 * i;
#pragma unroll
      for (int j = 0; j < fs::f32::SC; ++j) {
        const int key = k0 + cg + 8 * j;
        const bool masked = key >= L || row >= L || (causal && key > row);
        const float p = masked ? 0.f : expf(s[i][j] - lse_c[i]);
        Ps[(cg + 8 * j) * PS + rg + 16 * i] = p;
        s[i][j] = p * (dp[i][j] - del_c[i]);  // dS, kept until p^T dO is done
      }
    }
    __syncthreads();  // p^T is in Ps
    fs::f32::product<D, PS, SA>(acc_v, Ps, Gs, pr, pc);
    __syncthreads();  // every reader of p^T and dO is done
    if (q0 + BT < L) fs::load_tile<float, D, S>(sm90::smem_addr(Gs), gb, g.l, q0 + BT, L, g.vec);
    sm90::cp_async_commit();
#pragma unroll
    for (int i = 0; i < fs::f32::SR; ++i)
#pragma unroll
      for (int j = 0; j < fs::f32::SC; ++j) Ps[(cg + 8 * j) * PS + rg + 16 * i] = s[i][j];
    __syncthreads();  // dS^T is in Ps
    fs::f32::product<D, PS, SA>(acc_k, Ps, Qc, pr, pc);
    if (Lay::QBUF == 1) {
      __syncthreads();  // every reader of q is done
      if (q0 + BT < L) fs::load_tile<float, D, S>(sm90::smem_addr(Q0), qb, q.l, q0 + BT, L, q.vec);
      sm90::cp_async_commit();
    }
  }
  fs::f32::store<D, SA>(dk, acc_k, b, h, k0, L, H, scale, pr, pc);
  fs::f32::store<D, SA>(dv, acc_v, b, h, k0, L, H, 1.f, pr, pc);
}

template <int D>
struct MmaLayout {
  static constexpr int S = fs::mma::RS<D>;
  static constexpr int STAGES = D <= 64 ? 3 : 2;  // the q/dO ring
  static constexpr int TILE = fs::BT * S * 2;     // bytes of a tile
  static constexpr int STAT = 2 * fs::BT * 4;     // lse and delta of a q tile
  // dK's sums in shared memory at D = 128: in registers, dK's and dV's would take 128 a thread beside the
  // 64 of s^T and dp^T, and spill
  static constexpr bool K_SMEM = D == 128;
  static constexpr int ACC_K = K_SMEM ? fs::THREADS * D * 2 : 0;  // D / 8 n-tiles x 4 fp32 a thread
  static constexpr int bytes = ACC_K + TILE * (2 + 2 * STAGES) + STAGES * STAT;
};

template <int D>
__global__ void __launch_bounds__(fs::THREADS)
flash_dkv_kernel_mma(fs::Operand<port::bf16> q, fs::Operand<port::bf16> k, fs::Operand<port::bf16> v,
                     fs::Operand<port::bf16> g, const float* __restrict__ lse, const float* __restrict__ delta,
                     port::bf16* __restrict__ dk, port::bf16* __restrict__ dv, int L, int H, int causal,
                     float scale) {
  using Lay = MmaLayout<D>;
  constexpr int BT = fs::BT, S = Lay::S, ST = Lay::STAGES, TILE = Lay::TILE, NT = D / 8;
  extern __shared__ float4 smem_mma[];
  float4* acc_ks = smem_mma;  // K_SMEM: float4 acc_ks[n * THREADS + tid], n-tile n of the thread's dK fragment
  const uint32_t sK = sm90::smem_addr(smem_mma) + Lay::ACC_K, sV = sK + TILE, sQG = sV + TILE;  // stage: q, dO
  const uint32_t sStat = sQG + ST * 2 * TILE;                                                    // stage: lse, delta
  const float* stat_s = reinterpret_cast<const float*>(reinterpret_cast<const char*>(smem_mma) + Lay::ACC_K +
                                                       TILE * (2 + 2 * ST));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const fs::Place at = fs::place((L + BT - 1) / BT, H, false);
  const int k0 = at.tile * BT, h = at.h, b = at.b;
  const port::bf16* qb = q.slice(b, h);
  const port::bf16* gb = g.slice(b, h);
  const float* lse_b = lse + (static_cast<long long>(b) * H + h) * L;
  const float* del_b = delta + (static_cast<long long>(b) * H + h) * L;
  const int q_start = causal ? k0 : 0;
  const int nqt = (L - q_start + BT - 1) / BT;
  auto load_q = [&](int t) {
    if (t < nqt) {
      const int q0 = q_start + t * BT;
      const uint32_t dst = sQG + (t % ST) * 2 * TILE;
      fs::load_tile<port::bf16, D, S>(dst, qb, q.l, q0, L, q.vec);
      fs::load_tile<port::bf16, D, S>(dst + TILE, gb, g.l, q0, L, g.vec);
      const int r = tid % BT;  // threads 0..63 copy lse, 64..127 delta
      const bool ok = q0 + r < L;
      sm90::cp_async4(sStat + (t % ST) * Lay::STAT + ((tid / BT) * BT + r) * 4,
                      (tid < BT ? lse_b : del_b) + (ok ? q0 + r : 0), ok);
    }
    sm90::cp_async_commit();
  };
  fs::load_tile<port::bf16, D, S>(sK, k.slice(b, h), k.l, k0, L, k.vec);
  fs::load_tile<port::bf16, D, S>(sV, v.slice(b, h), v.l, k0, L, v.vec);
  for (int t = 0; t < ST - 1; ++t) load_q(t);

  const int m0 = warp * 16;
  const int key_lo = k0 + m0 + (lane >> 2);  // the thread's keys: key_lo (C regs 0, 1) and key_lo + 8 (2, 3)
  float acc_v[NT][4], acc_k[Lay::K_SMEM ? 1 : NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_v[n][e] = 0.f;
      if constexpr (!Lay::K_SMEM) acc_k[n][e] = 0.f;
    }
  if constexpr (Lay::K_SMEM) {
#pragma unroll
    for (int n = 0; n < NT; ++n) acc_ks[n * fs::THREADS + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = 0; t < nqt; ++t) {
    sm90::cp_async_wait<ST - 2>();
    __syncthreads();  // tile t landed; every warp is done with the stage the next load refills
    load_q(t + ST - 1);
    const uint32_t sQ = sQG + (t % ST) * 2 * TILE, sG = sQ + TILE;
    const float* lse_s = stat_s + (t % ST) * (Lay::STAT / 4);
    const float* del_s = lse_s + BT;
    float s[8][4], dp[8][4];  // s^T and dp^T: the warp's 16 keys x the tile's 64 q rows
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    fs::mma::scores<D>(s, sK, m0, sQ, lane);
    fs::mma::scores<D>(dp, sV, m0, sG, lane);
    const int q0 = q_start + t * BT;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_lo + 8 * (e >> 1);
        const int c = n * 8 + 2 * (lane & 3) + (e & 1);
        const int row = q0 + c;
        const bool masked = key >= L || row >= L || (causal && key > row);
        const float p = masked ? 0.f : expf(s[n][e] * scale - lse_s[c]);
        dp[n][e] = p * (dp[n][e] - del_s[c]);  // dS^T
        s[n][e] = p;
      }
    uint32_t hi[4][4], lo[4][4];
    fs::mma::as_a(s, hi, lo);
#pragma unroll
    for (int np = 0; np < D / 16; ++np)
      fs::mma::product_pair<D>(acc_v[2 * np], acc_v[2 * np + 1], hi, lo, sG, np, lane);
    fs::mma::as_a(dp, hi, lo);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      if constexpr (Lay::K_SMEM) {
        float a0[4], a1[4];
        *reinterpret_cast<float4*>(a0) = acc_ks[2 * np * fs::THREADS + tid];
        *reinterpret_cast<float4*>(a1) = acc_ks[(2 * np + 1) * fs::THREADS + tid];
        fs::mma::product_pair<D>(a0, a1, hi, lo, sQ, np, lane);
        acc_ks[2 * np * fs::THREADS + tid] = *reinterpret_cast<const float4*>(a0);
        acc_ks[(2 * np + 1) * fs::THREADS + tid] = *reinterpret_cast<const float4*>(a1);
      } else {
        fs::mma::product_pair<D>(acc_k[2 * np], acc_k[2 * np + 1], hi, lo, sQ, np, lane);
      }
    }
  }
  if constexpr (Lay::K_SMEM) {
    float out_k[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) *reinterpret_cast<float4*>(out_k[n]) = acc_ks[n * fs::THREADS + tid];
    fs::mma::store<D>(dk, out_k, b, h, k0, m0, L, H, scale, lane);
  } else {
    fs::mma::store<D>(dk, acc_k, b, h, k0, m0, L, H, scale, lane);
  }
  fs::mma::store<D>(dv, acc_v, b, h, k0, m0, L, H, 1.f, lane);
}

template <typename T, int D>
int launch_sm90(const void* q, const void* k, const void* v, const void* g, const void* lse, const void* delta,
                void* dk, void* dv, int B, int L, int H, Strides sq, Strides sk, Strides sv, Strides sg, int causal,
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
                                                 static_cast<T*>(dk), static_cast<T*>(dv), L, H, causal, scale);
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (std::is_same<T, float>::value) return run(flash_dkv_kernel_ffma<D>, FfmaLayout<D>::bytes);
  else return run(flash_dkv_kernel_mma<D>, MmaLayout<D>::bytes);
}

// ------------------------------------------------------------------ D = 256 and WIDE (the wide namespace)

namespace fw = flash_sm90::wide;

template <int D>
struct FfmaWideLayout {
  static constexpr int TILE = fw::f32::TILE;
  static constexpr int ST = 3;                     // ring stages
  static constexpr int STAGE = 4 * TILE;           // q, dO, k, v chunks (a product step: dO or q)
  static constexpr int bytes = TILE + ST * STAGE;  // p^T / dS^T, the ring
};

// D: 256, or WIDE (dd, a multiple of 64 above 256, and the windows at run time).
template <int D>
__global__ void __launch_bounds__(fw::THREADS, 1)
flash_dkv_kernel_ffma_wide(fs::Operand<float> q, fs::Operand<float> k, fs::Operand<float> v, fs::Operand<float> g,
                           const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
                           float* __restrict__ dv, int L, int H, int dd, int wn, int causal, float scale) {
  using Lay = FfmaWideLayout<D>;
  constexpr int BT = fs::BT, CS = fw::f32::CS, TL = Lay::TILE / 4, ST = Lay::ST;
  extern __shared__ float4 smem_ffma_wide[];
  float* Ps = reinterpret_cast<float*>(smem_ffma_wide);  // p^T, then dS^T, of the current q tile
  float* ring = Ps + TL;
  const uint32_t s_ring = sm90::smem_addr(ring);

  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;  // scores: q rows rg + 16 i, keys cg + 16 j; dk, dv: keys rg * 4 + i
  const fw::Place at = fw::place(dd, wn, L, H, false);
  const int nch = D == fw::WIDE ? at.nch : D / fw::CW;
  const int k0 = at.tile * BT;
  const float *qb = q.slice(at.b, at.h), *kb = k.slice(at.b, at.h);
  const float *vb = v.slice(at.b, at.h), *gb = g.slice(at.b, at.h);
  const float* lse_b = lse + (static_cast<long long>(at.b) * H + at.h) * L;
  const float* del_b = delta + (static_cast<long long>(at.b) * H + at.h) * L;
  // The tiles are square, so the first q tile that sees a key of this tile is the diagonal one.
  const int q_start = causal ? k0 : 0;
  const int nqt = (L - q_start + BT - 1) / BT;
  const int per = nch + 2 * at.nwin, steps = nqt * per;
  // step u into stage u % ST: score step r < nch of q tile t loads chunk r of q, dO, k, v; then the window
  // chunks of dO (the p^T dO steps), then those of q (dS^T q)
  auto issue = [&](int u) {
    if (u < steps) {
      const int t = u / per, r = u % per, q0 = q_start + t * BT;
      const uint32_t st = s_ring + (u % ST) * Lay::STAGE;
      if (r < nch) {
        fw::load_chunk<float, CS>(st, qb, q.l, r, q0, L, q.vec);
        fw::load_chunk<float, CS>(st + Lay::TILE, gb, g.l, r, q0, L, g.vec);
        fw::load_chunk<float, CS>(st + 2 * Lay::TILE, kb, k.l, r, k0, L, k.vec);
        fw::load_chunk<float, CS>(st + 3 * Lay::TILE, vb, v.l, r, k0, L, v.vec);
      } else if (r < nch + at.nwin) {
        fw::load_chunk<float, CS>(st, gb, g.l, at.c_lo + r - nch, q0, L, g.vec);
      } else {
        fw::load_chunk<float, CS>(st, qb, q.l, at.c_lo + r - nch - at.nwin, q0, L, q.vec);
      }
    }
    sm90::cp_async_commit();
  };
  for (int u = 0; u < ST - 1; ++u) issue(u);
  float acc_k[fw::NWC][4][4], acc_v[fw::NWC][4][4];
#pragma unroll
  for (int j = 0; j < fw::NWC; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[j][i][e] = acc_v[j][i][e] = 0.f;

  for (int t = 0; t < nqt; ++t) {
    const int q0 = q_start + t * BT;
    float lse_c[4], del_c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg + 16 * i;
      lse_c[i] = row < L ? lse_b[row] : 0.f;
      del_c[i] = row < L ? del_b[row] : 0.f;
    }
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
      fw::f32::scores(s, dp, st, st + TL, st + 2 * TL, st + 3 * TL, rg, cg, scale);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + cg + 16 * j;
        const bool masked = key >= L || row >= L || (causal && key > row);
        const float p = masked ? 0.f : expf(s[i][j] - lse_c[i]);
        Ps[(cg + 16 * j) * CS + rg + 16 * i] = p;
        s[i][j] = p * (dp[i][j] - del_c[i]);  // dS, kept until p^T dO is done
      }
    }
#pragma unroll
    for (int j = 0; j < fw::NWC; ++j) {
      if (j >= at.nwin) break;
      const int u = t * per + nch + j;
      sm90::cp_async_wait<ST - 2>();
      __syncthreads();  // the dO chunk landed; p^T is in Ps
      issue(u + ST - 1);
      fw::f32::product(acc_v[j], Ps, ring + (u % ST) * (Lay::STAGE / 4), rg, cg);
    }
    __syncthreads();  // every reader of p^T is done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(cg + 16 * j) * CS + rg + 16 * i] = s[i][j];
#pragma unroll
    for (int j = 0; j < fw::NWC; ++j) {
      if (j >= at.nwin) break;
      const int u = t * per + nch + at.nwin + j;
      sm90::cp_async_wait<ST - 2>();
      __syncthreads();  // the q chunk landed; dS^T is in Ps
      issue(u + ST - 1);
      fw::f32::product(acc_k[j], Ps, ring + (u % ST) * (Lay::STAGE / 4), rg, cg);
    }
  }
  fw::f32::store(dk, acc_k, at, k0, rg, cg, L, H, dd, scale);
  fw::f32::store(dv, acc_v, at, k0, rg, cg, L, H, dd, 1.f);
}

template <int D>
struct MmaWideLayout {
  static constexpr bool RES = D != fw::WIDE;          // k and v held for the whole block (D = 256)
  static constexpr int TILE = fw::mma::TILE;
  static constexpr int ST = 4;                         // ring stages
  static constexpr int STAGE = (RES ? 2 : 4) * TILE;  // q, dO (and k, v) chunks; a product step: dO or q
  static constexpr int OWN = RES ? 2 * (D / fw::CW) * TILE : 0;
  static constexpr int bytes = OWN + 4 * TILE + ST * STAGE;  // k and v, p^T and dS^T hi and lo, the ring
  // D = 256: a tile's four score steps fill the four stages, the window's chunks first (chunk c_lo + r at step
  // r), and the product steps of window chunk j find chunk c_lo + j of q and dO where score step j left them
  // and load nothing
  static_assert(!RES || ST == D / fw::CW, "the D = 256 ring holds one tile's chunks");
};

template <int D>
__global__ void __launch_bounds__(fw::THREADS, 1)
flash_dkv_kernel_mma_wide(fs::Operand<port::bf16> q, fs::Operand<port::bf16> k, fs::Operand<port::bf16> v,
                          fs::Operand<port::bf16> g, const float* __restrict__ lse, const float* __restrict__ delta,
                          port::bf16* __restrict__ dk, port::bf16* __restrict__ dv, int L, int H, int dd, int wn,
                          int causal, float scale) {
  using Lay = MmaWideLayout<D>;
  using port::bf16;
  constexpr int BT = fs::BT, CS = fw::mma::CS, TILE = Lay::TILE, ST = Lay::ST;
  extern __shared__ float4 smem_mma_wide[];
  const uint32_t s_own = sm90::smem_addr(smem_mma_wide);  // chunk c of k, then of v (D = 256)
  const uint32_t s_phi = s_own + Lay::OWN, s_plo = s_phi + TILE, s_dhi = s_plo + TILE, s_dlo = s_dhi + TILE;
  const uint32_t s_ring = s_dlo + TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;  // the warp's keys; its q rows and its columns of a chunk
  const fw::Place at = fw::place(dd, wn, L, H, false);
  const int nch = D == fw::WIDE ? at.nch : D / fw::CW;
  const int k0 = at.tile * BT;
  const bf16 *qb = q.slice(at.b, at.h), *kb = k.slice(at.b, at.h);
  const bf16 *vb = v.slice(at.b, at.h), *gb = g.slice(at.b, at.h);
  const float* lse_b = lse + (static_cast<long long>(at.b) * H + at.h) * L;
  const float* del_b = delta + (static_cast<long long>(at.b) * H + at.h) * L;
  const int q_start = causal ? k0 : 0;
  const int nqt = (L - q_start + BT - 1) / BT;
  const int per = nch + 2 * at.nwin, steps = nqt * per;
  // Step u (score or product step r of q tile t): score step r < nch loads chunk r of q and dO (at D = 256
  // chunk c_lo + r, mod 4) and, above 256, of k and v; then the window chunks of dO (the p^T dO steps), then
  // those of q (dS^T q), at D = 256 already there. Its stage: u % ST, or at D = 256 (t nwin + r) % ST, the
  // product steps' of window chunk j that of score step j: a tile's stages of score steps past the window
  // are refilled first, those of the window only once both its products are done.
  auto stage = [&](int u, int t, int r) {
    return s_ring + ((Lay::RES ? t * at.nwin + r : u) % ST) * Lay::STAGE;
  };
  auto issue = [&](int u) {
    if (u < steps) {
      const int t = u / per, r = u % per, q0 = q_start + t * BT;
      const uint32_t st = stage(u, t, r);
      if (r < nch) {
        const int c = Lay::RES ? (at.c_lo + r) % nch : r;
        fw::load_chunk<bf16, CS>(st, qb, q.l, c, q0, L, q.vec);
        fw::load_chunk<bf16, CS>(st + TILE, gb, g.l, c, q0, L, g.vec);
        if constexpr (!Lay::RES) {
          fw::load_chunk<bf16, CS>(st + 2 * TILE, kb, k.l, r, k0, L, k.vec);
          fw::load_chunk<bf16, CS>(st + 3 * TILE, vb, v.l, r, k0, L, v.vec);
        }
      } else if constexpr (!Lay::RES) {
        if (r < nch + at.nwin) {
          fw::load_chunk<bf16, CS>(st, gb, g.l, at.c_lo + r - nch, q0, L, g.vec);
        } else {
          fw::load_chunk<bf16, CS>(st, qb, q.l, at.c_lo + r - nch - at.nwin, q0, L, q.vec);
        }
      }
    }
    sm90::cp_async_commit();
  };
  if constexpr (Lay::RES) {
    for (int c = 0; c < nch; ++c) {
      fw::load_chunk<bf16, CS>(s_own + c * TILE, kb, k.l, c, k0, L, k.vec);
      fw::load_chunk<bf16, CS>(s_own + (nch + c) * TILE, vb, v.l, c, k0, L, v.vec);
    }
  }
  for (int u = 0; u < ST - 1; ++u) issue(u);  // the first group carries k and v too

  const int key_lo = k0 + m0 + (lane >> 2);  // the thread's keys: key_lo (C regs 0, 1) and key_lo + 8 (2, 3)
  float acc_k[fw::NWC][4][4], acc_v[fw::NWC][4][4];
#pragma unroll
  for (int j = 0; j < fw::NWC; ++j)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[j][n][e] = acc_v[j][n][e] = 0.f;

  for (int t = 0; t < nqt; ++t) {
    const int q0 = q_start + t * BT;
    float lse_c[4][2], del_c[4][2];  // the thread's q rows: q0 + n0 + n * 8 + 2 (lane % 4) + e
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = q0 + n0 + n * 8 + 2 * (lane & 3) + e;
        lse_c[n][e] = row < L ? lse_b[row] : 0.f;
        del_c[n][e] = row < L ? del_b[row] : 0.f;
      }
    float s[4][4], dp[4][4];  // s^T and dp^T: the warp's 16 keys x its 32 q rows
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
      const uint32_t sk = Lay::RES ? s_own + c * TILE : st + 2 * TILE;
      const uint32_t sv = Lay::RES ? s_own + (nch + c) * TILE : st + 3 * TILE;
      fw::mma::scores(s, sk, m0, st, n0, lane);
      fw::mma::scores(dp, sv, m0, st + TILE, n0, lane);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_lo + 8 * (e >> 1);
        const int row = q0 + n0 + n * 8 + 2 * (lane & 3) + (e & 1);
        const bool masked = key >= L || row >= L || (causal && key > row);
        const float p = masked ? 0.f : expf(s[n][e] * scale - lse_c[n][e & 1]);
        dp[n][e] = p * (dp[n][e] - del_c[n][e & 1]);  // dS^T
        s[n][e] = p;
      }
    fw::mma::store_split(s, s_phi, s_plo, m0, n0, lane);
    fw::mma::store_split(dp, s_dhi, s_dlo, m0, n0, lane);
    uint32_t a[2][4][4];
#pragma unroll
    for (int j = 0; j < 2 * fw::NWC; ++j) {
      const int w = j % fw::NWC;  // p^T dO for j < NWC, then dS^T q
      if (w >= at.nwin) continue;
      const int u = t * per + nch + (j < fw::NWC ? 0 : at.nwin) + w;
      sm90::cp_async_wait<ST - 2>();
      __syncthreads();  // the dO or q chunk landed; every warp's p^T and dS^T are in shared memory
      issue(u + ST - 1);
      if (w == 0) fw::mma::frags(a, j < fw::NWC ? s_phi : s_dhi, j < fw::NWC ? s_plo : s_dlo, m0, lane);
      const uint32_t st = stage(u, t, w);
      if (j < fw::NWC) {
        fw::mma::product(acc_v[w], a, Lay::RES ? st + TILE : st, n0, lane);  // dO: a score step's second chunk
      } else {
        fw::mma::product(acc_k[w], a, st, n0, lane);
      }
    }
  }
  fw::mma::store(dk, acc_k, at, k0, m0, n0, L, H, dd, scale, lane);
  fw::mma::store(dv, acc_v, at, k0, m0, n0, L, H, dd, 1.f, lane);
}

template <typename T, int D>
int launch_wide(const void* q, const void* k, const void* v, const void* g, const void* lse, const void* delta,
                void* dk, void* dv, int B, int L, int H, int dd, Strides sq, Strides sk, Strides sv, Strides sg,
                int causal, float scale, cudaStream_t stream) {
  const auto oq = fs::operand<T>(q, sq.b, sq.l, sq.h), ok = fs::operand<T>(k, sk.b, sk.l, sk.h);
  const auto ov = fs::operand<T>(v, sv.b, sv.l, sv.h), og = fs::operand<T>(g, sg.b, sg.l, sg.h);
  dim3 grid;
  int wn;
  if (!fw::grid_for(B, L, H, dd, grid, wn)) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto kernel, int bytes) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, fw::THREADS, bytes, stream>>>(oq, ok, ov, og, static_cast<const float*>(lse),
                                                 static_cast<const float*>(delta), static_cast<T*>(dk),
                                                 static_cast<T*>(dv), L, H, dd, wn, causal, scale);
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (std::is_same<T, float>::value) return run(flash_dkv_kernel_ffma_wide<D>, FfmaWideLayout<D>::bytes);
  else return run(flash_dkv_kernel_mma_wide<D>, MmaWideLayout<D>::bytes);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g, const void* lse, const void* delta,
           void* dk, void* dv, int B, int L, int H, int D, long long qb, long long ql, long long qh, long long kb,
           long long kl, long long kh, long long vb, long long vl, long long vh, long long gb, long long gl,
           long long gh, int causal, float scale, void* stream) {
  const Strides sq{qb, ql, qh}, sk{kb, kl, kh}, sv{vb, vl, vh}, sg{gb, gl, gh};
  const auto st = static_cast<cudaStream_t>(stream);
#define FLASH_DKV_WIDE(I) \
  launch_wide<T, I>(q, k, v, g, lse, delta, dk, dv, B, L, H, D, sq, sk, sv, sg, causal, scale, st)
#define FLASH_DKV_SM90(I) \
  launch_sm90<T, I>(q, k, v, g, lse, delta, dk, dv, B, L, H, sq, sk, sv, sg, causal, scale, st)
  switch (D) {
    case 16: return FLASH_DKV_SM90(16);
    case 32: return FLASH_DKV_SM90(32);
    case 64: return FLASH_DKV_SM90(64);
    case 128: return FLASH_DKV_SM90(128);
    case 256: return FLASH_DKV_WIDE(256);
    default:
      if (D > 256 && D % fw::CW == 0) return FLASH_DKV_WIDE(fw::WIDE);
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_DKV_WIDE
#undef FLASH_DKV_SM90
}

}  // namespace

#define FLASH_DKV_ARGS                                                                                        \
  const void *q, const void *k, const void *v, const void *g, const void *lse, const void *delta, void *dk,   \
      void *dv, int B, int L, int H, int D, long long qb, long long ql, long long qh, long long kb,           \
      long long kl, long long kh, long long vb, long long vl, long long vh, long long gb, long long gl,        \
      long long gh, int causal, float scale, void *stream
#define FLASH_DKV_PASS                                                                                      \
  q, k, v, g, lse, delta, dk, dv, B, L, H, D, qb, ql, qh, kb, kl, kh, vb, vl, vh, gb, gl, gh, causal, scale, \
      stream

extern "C" int flash_dkv_f32(FLASH_DKV_ARGS) { return launch<float>(FLASH_DKV_PASS); }

extern "C" int flash_dkv_bf16(FLASH_DKV_ARGS) { return launch<port::bf16>(FLASH_DKV_PASS); }
