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
// 64-key tile), 128 threads; the K and V tiles stay in shared memory and
// 64-row q/dO tiles stream through it by cp.async, from the diagonal tile on
// (causal: the first k tiles, launched first, are the heaviest). At
// D <= 128 (flash_bwd_sm90.cuh):
//   * fp32, flash_dkv_kernel_ffma: FFMA in the parent's operations and order
//     (its bits): a thread's 4 x 8 s and dp in registers, p^T and then dS^T
//     through one shared tile to the p^T dO and dS^T q products, the dK and
//     dV sums in registers; q double-buffered, dO refilled while dS^T q
//     runs (102 KB of shared memory at D = 64: two blocks an SM). At D = 128
//     the two accumulators (128 registers a thread) live in shared memory,
//     laid out per thread, and q is single-buffered (213 KB).
//   * bf16, flash_dkv_kernel_mma: mma.sync on the tensor cores, a warp's 16
//     keys; s^T = k q^T and dp^T = v dO^T, then p^T dO and dS^T q from the C
//     fragments re-packed as A fragments, p and dS split into two bf16
//     terms; a 3-stage q/dO ring (2 at D = 128). At D = 128 the dK
//     accumulators live in shared memory, laid out per thread (see the
//     kernel).
// D = 256 and D > 256 (the WIDE instance, any multiple of 64; one block per
// (b, h, k tile, window of 256 dk and dv columns)) keep the FFMA kernel of
// flash_bwd.cuh for both dtypes: the tiles held 64 columns at a time, the
// sums in shared-memory accumulators.
//
// Ragged tiles and masking: a key or q row past L loads as 0, and its p is
// set to exactly 0, as is a key above the causal diagonal, so it adds 0 to
// every sum; lse and delta are not read past L.
#include <type_traits>

#include "flash_bwd.cuh"
#include "flash_bwd_sm90.cuh"

namespace {

// ------------------------------------------------------------------ D = 256 and WIDE (flash_bwd.cuh)

using namespace flash_bwd;

template <int D>
struct Layout {
  static constexpr int DC = Dims<D>::DC, S = Dims<D>::S, AS = Dims<D>::AS;
  static constexpr int bytes = static_cast<int>(sizeof(float)) * (4 * BT * S + BT * PS + 2 * BT * AS);
};

// D: the instance's head dim, or WIDE (dd, a multiple of 64 above 256, and windows at run time).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int L, int H, int dd, int windows, Strides sq,
                 Strides sk, Strides sv, Strides sg, int causal, float scale) {
  using Lay = Layout<D>;
  constexpr int DC = Lay::DC;
  const Window<D> win(dd, windows, L, H, false);
  const int nch = win.nch;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * Lay::S;
  float* Qs = Vs + BT * Lay::S;  // q tile (chunk), unscaled
  float* Gs = Qs + BT * Lay::S;  // dO tile (chunk)
  float* Ps = Gs + BT * Lay::S;  // p^T, then dS^T, of the current q tile
  float* AccK = Ps + BT * PS;    // dk / scale
  float* AccV = AccK + BT * Lay::AS;

  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const int k0 = win.tile * BT;
  const int h = win.h, b = win.b;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* gb = g + b * sg.b + h * sg.h;
  const float* lse_b = lse + (static_cast<long long>(b) * H + h) * L;
  const float* del_b = delta + (static_cast<long long>(b) * H + h) * L;

  if (nch == 1) {
    load_tile<T, DC>(Ks, kb, sk.l, k0, L, 1.f);
    load_tile<T, DC>(Vs, vb, sv.l, k0, L, 1.f);
  }
  zero_acc<D>(AccK);
  zero_acc<D>(AccV);

  // The tiles are square, so the first q tile that sees a key of this tile is the diagonal one.
  for (int q0 = causal ? k0 : 0; q0 < L; q0 += BT) {
    float lse_c[CJ], del_c[CJ];
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int row = q0 + cg + CG * j;
      lse_c[j] = row < L ? lse_b[row] : 0.f;
      del_c[j] = row < L ? del_b[row] : 0.f;
    }
    float s[RG][CJ], dp[RG][CJ];
    zero_scores(s, dp);
    for (int c = 0; c < nch; ++c) {
      __syncthreads();  // the previous readers are done with the tiles and Ps
      if (nch > 1) {
        load_tile<T, DC>(Ks, kb + c * DC, sk.l, k0, L, 1.f);
        load_tile<T, DC>(Vs, vb + c * DC, sv.l, k0, L, 1.f);
      }
      load_tile<T, DC>(Qs, qb + c * DC, sq.l, q0, L, 1.f);
      load_tile<T, DC>(Gs, gb + c * DC, sg.l, q0, L, 1.f);
      __syncthreads();
      scores<DC, true>(s, dp, Ks, Vs, Qs, Gs, rg, cg, scale);  // s^T = k (q * scale)^T, dp^T = v dO^T
    }
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int key = k0 + rg * RG + i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int row = q0 + cg + CG * j;
        const bool masked = key >= L || row >= L || (causal && key > row);
        const float p = masked ? 0.f : expf(s[i][j] - lse_c[j]);
        Ps[(rg * RG + i) * PS + cg + CG * j] = p;
        s[i][j] = p * (dp[i][j] - del_c[j]);  // dS^T, kept until p^T dO is done
      }
    }
    __syncthreads();  // p^T is in Ps
    // p^T dO, chunk by chunk of the window's columns of dO, last first: chunk nch - 1 is the one in Gs
    for (int c = win.c_hi - 1; c >= win.c_lo; --c) {
      if (c != nch - 1) {
        __syncthreads();
        load_tile<T, DC>(Gs, gb + c * DC, sg.l, q0, L, 1.f);
        __syncthreads();
      }
      accumulate<DC, Lay::AS>(AccV + (c - win.c_lo) * DC, Ps, Gs, rg, cg);
    }
    __syncthreads();  // every reader of p^T is done
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) Ps[(rg * RG + i) * PS + cg + CG * j] = s[i][j];
    __syncthreads();  // dS^T is in Ps
    // dS^T q, the same way: chunk nch - 1 of q is the one in Qs
    for (int c = win.c_hi - 1; c >= win.c_lo; --c) {
      if (c != nch - 1) {
        __syncthreads();
        load_tile<T, DC>(Qs, qb + c * DC, sq.l, q0, L, 1.f);
        __syncthreads();
      }
      accumulate<DC, Lay::AS>(AccK + (c - win.c_lo) * DC, Ps, Qs, rg, cg);
    }
  }
  __syncthreads();
  const int d_out = D == WIDE ? dd : D;
  store_tile<T, D>(dk, AccK, b, h, k0, L, H, d_out, win.c_lo * DC, scale);
  store_tile<T, D>(dv, AccV, b, h, k0, L, H, d_out, win.c_lo * DC, 1.f);
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* g, const void* lse, const void* delta,
             void* dk, void* dv, int B, int L, int H, int dd, Strides sq, Strides sk, Strides sv, Strides sg,
             int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_dkv_kernel<T, D>;
  const int bytes = Layout<D>::bytes;
  const int windows = D == WIDE ? (dd + WN - 1) / WN : 1;
  dim3 grid;
  if (!grid_for(B, L, H, windows, grid)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      L, H, dd, windows, sq, sk, sv, sg, causal, scale);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------------------ D <= 128 (flash_bwd_sm90.cuh)

namespace fs = flash_sm90;

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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g, const void* lse, const void* delta,
           void* dk, void* dv, int B, int L, int H, int D, long long qb, long long ql, long long qh, long long kb,
           long long kl, long long kh, long long vb, long long vl, long long vh, long long gb, long long gl,
           long long gh, int causal, float scale, void* stream) {
  const Strides sq{qb, ql, qh}, sk{kb, kl, kh}, sv{vb, vl, vh}, sg{gb, gl, gh};
  const auto st = static_cast<cudaStream_t>(stream);
#define FLASH_DKV_LAUNCH(I) \
  launch_d<T, I>(q, k, v, g, lse, delta, dk, dv, B, L, H, D, sq, sk, sv, sg, causal, scale, st)
#define FLASH_DKV_SM90(I) \
  launch_sm90<T, I>(q, k, v, g, lse, delta, dk, dv, B, L, H, sq, sk, sv, sg, causal, scale, st)
  switch (D) {
    case 16: return FLASH_DKV_SM90(16);
    case 32: return FLASH_DKV_SM90(32);
    case 64: return FLASH_DKV_SM90(64);
    case 128: return FLASH_DKV_SM90(128);
    case 256: return FLASH_DKV_LAUNCH(256);
    default:
      if (D > 256 && D % Dims<WIDE>::DC == 0) return FLASH_DKV_LAUNCH(WIDE);
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_DKV_LAUNCH
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
