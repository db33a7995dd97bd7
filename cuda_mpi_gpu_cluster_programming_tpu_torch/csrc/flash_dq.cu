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
// 64-row q tile), 128 threads, heaviest causal tiles first; 64-key K/V tiles
// stream through shared memory by cp.async, and k tiles wholly above the
// diagonal are not visited. At D <= 128 (flash_bwd_sm90.cuh):
//   * fp32, flash_dq_kernel_ffma: FFMA in the parent's operations and order
//     (its bits): a thread's 4 x 8 s and dp in registers, dS through shared
//     memory, the dq sums in registers; K double-buffered, V refilled while
//     dS k runs (103 KB of shared memory at D = 64: two blocks an SM).
//   * bf16, flash_dq_kernel_mma: mma.sync on the tensor cores, a warp's 16
//     q rows; dS k from the C fragments re-packed as A fragments, dS split
//     into two bf16 terms; a 3-stage K/V ring (2 at D = 128).
// D = 256 and D > 256 (the WIDE instance, any multiple of 64; one block per
// (b, h, q tile, window of 256 dq columns)) keep the FFMA kernel of
// flash_bwd.cuh for both dtypes: the tiles held 64 columns at a time, the
// dq sums in a shared-memory accumulator.
//
// Ragged tiles and masking: a q row or key past L loads as 0, and its p is
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
  static constexpr int bytes = static_cast<int>(sizeof(float)) * (4 * BT * S + BT * PS + BT * AS);
};

// D: the instance's head dim, or WIDE (dd, a multiple of 64 above 256, and windows at run time).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int L, int H, int dd, int windows, Strides sq, Strides sk, Strides sv,
                Strides sg, int causal, float scale) {
  using Lay = Layout<D>;
  constexpr int DC = Lay::DC;
  const Window<D> win(dd, windows, L, H, causal);
  const int nch = win.nch;
  extern __shared__ float smem[];
  float* Qs = smem;             // q tile (chunk), pre-scaled
  float* Gs = Qs + BT * Lay::S;  // dO tile (chunk)
  float* Ks = Gs + BT * Lay::S;
  float* Vs = Ks + BT * Lay::S;
  float* Ps = Vs + BT * Lay::S;  // dS of the current k tile
  float* Acc = Ps + BT * PS;     // dq / scale

  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const int q0 = win.tile * BT;
  const int h = win.h, b = win.b;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* gb = g + b * sg.b + h * sg.h;
  const long long stat = (static_cast<long long>(b) * H + h) * L;

  if (nch == 1) {
    load_tile<T, DC>(Qs, qb, sq.l, q0, L, scale);
    load_tile<T, DC>(Gs, gb, sg.l, q0, L, 1.f);
  }
  zero_acc<D>(Acc);
  float lse_r[RG], del_r[RG];
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    const int row = q0 + rg * RG + i;
    lse_r[i] = row < L ? lse[stat + row] : 0.f;
    del_r[i] = row < L ? delta[stat + row] : 0.f;
  }

  const int k_end = causal ? min(L, q0 + BT) : L;
  for (int k0 = 0; k0 < k_end; k0 += BT) {
    float s[RG][CJ], dp[RG][CJ];
    zero_scores(s, dp);
    for (int c = 0; c < nch; ++c) {
      __syncthreads();  // the previous readers are done with the tiles and Ps
      if (nch > 1) {
        load_tile<T, DC>(Qs, qb + c * DC, sq.l, q0, L, scale);
        load_tile<T, DC>(Gs, gb + c * DC, sg.l, q0, L, 1.f);
      }
      load_tile<T, DC>(Ks, kb + c * DC, sk.l, k0, L, 1.f);
      load_tile<T, DC>(Vs, vb + c * DC, sv.l, k0, L, 1.f);
      __syncthreads();
      scores<DC, false>(s, dp, Qs, Gs, Ks, Vs, rg, cg, 1.f);
    }
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int row = q0 + rg * RG + i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int key = k0 + cg + CG * j;
        const bool masked = row >= L || key >= L || (causal && key > row);
        const float p = masked ? 0.f : expf(s[i][j] - lse_r[i]);
        Ps[(rg * RG + i) * PS + cg + CG * j] = p * (dp[i][j] - del_r[i]);
      }
    }
    __syncthreads();  // every row's dS is in Ps
    // dS k, chunk by chunk of the window's columns of k, last first: chunk nch - 1 is the one in Ks
    for (int c = win.c_hi - 1; c >= win.c_lo; --c) {
      if (c != nch - 1) {
        __syncthreads();
        load_tile<T, DC>(Ks, kb + c * DC, sk.l, k0, L, 1.f);
        __syncthreads();
      }
      accumulate<DC, Lay::AS>(Acc + (c - win.c_lo) * DC, Ps, Ks, rg, cg);
    }
  }
  __syncthreads();
  store_tile<T, D>(dq, Acc, b, h, q0, L, H, D == WIDE ? dd : D, win.c_lo * DC, scale);
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* g, const void* lse, const void* delta,
             void* dq, int B, int L, int H, int dd, Strides sq, Strides sk, Strides sv, Strides sg, int causal,
             float scale, cudaStream_t stream) {
  auto kernel = flash_dq_kernel<T, D>;
  const int bytes = Layout<D>::bytes;
  const int windows = D == WIDE ? (dd + WN - 1) / WN : 1;
  dim3 grid;
  if (!grid_for(B, L, H, windows, grid)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq), L, H, dd, windows,
      sq, sk, sv, sg, causal, scale);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------------------ D <= 128 (flash_bwd_sm90.cuh)

namespace fs = flash_sm90;

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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g, const void* lse, const void* delta,
           void* dq, int B, int L, int H, int D, long long qb, long long ql, long long qh, long long kb,
           long long kl, long long kh, long long vb, long long vl, long long vh, long long gb, long long gl,
           long long gh, int causal, float scale, void* stream) {
  const Strides sq{qb, ql, qh}, sk{kb, kl, kh}, sv{vb, vl, vh}, sg{gb, gl, gh};
  const auto st = static_cast<cudaStream_t>(stream);
#define FLASH_DQ_LAUNCH(I) launch_d<T, I>(q, k, v, g, lse, delta, dq, B, L, H, D, sq, sk, sv, sg, causal, scale, st)
#define FLASH_DQ_SM90(I) launch_sm90<T, I>(q, k, v, g, lse, delta, dq, B, L, H, sq, sk, sv, sg, causal, scale, st)
  switch (D) {
    case 16: return FLASH_DQ_SM90(16);
    case 32: return FLASH_DQ_SM90(32);
    case 64: return FLASH_DQ_SM90(64);
    case 128: return FLASH_DQ_SM90(128);
    case 256: return FLASH_DQ_LAUNCH(256);
    default:
      if (D > 256 && D % Dims<WIDE>::DC == 0) return FLASH_DQ_LAUNCH(WIDE);
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_DQ_LAUNCH
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
