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
// Bound on the H100: operations in fp32 (3 products of 2 B H L^2 D FLOPs,
// half of that causal, against 5 reads/writes of B L H D elements); in bf16
// the tensor cores' rate, which this FFMA kernel does not reach (a
// wgmma/TMA design is later work). Design: one block per (b, h, 64-row q
// tile), 128 threads (flash_bwd.cuh); the pre-scaled q tile and the dO tile
// stay in shared memory, 64-key K/V tiles stream through it, k tiles
// wholly above the diagonal are not visited. A thread's s and dp (4 rows x
// 8 keys) stay in registers; dS goes through shared memory to the dS k
// product, whose sums land in a shared-memory accumulator (64 x D fp32).
// bf16 widens at the load and rounds once at the store. D = 256 (150 KB of
// shared memory): the tiles hold 64 columns at a time (flash_bwd.cuh), so q
// and dO are reloaded per k tile and k once more per chunk of the dS k product.
// D > 256 (any multiple of 64; the WIDE instance, 146 KB): one block per
// (b, h, q tile, window of 256 dq columns); each window sums the scores over
// all of D as at D = 256 and runs the dS k product over its own columns.
//
// Ragged tiles and masking: a q row or key past L loads as 0, and its p is
// set to exactly 0, as is a key above the causal diagonal, so it adds 0 to
// every sum; lse and delta are not read past L.
#include "flash_bwd.cuh"

namespace {

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
  const Window<D> win(dd, windows);
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
  const int h = blockIdx.y, b = blockIdx.z;
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
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int windows = D == WIDE ? (dd + WN - 1) / WN : 1;
  const dim3 grid((L + BT - 1) / BT * windows, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq), L, H, dd, windows,
      sq, sk, sv, sg, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g, const void* lse, const void* delta,
           void* dq, int B, int L, int H, int D, long long qb, long long ql, long long qh, long long kb,
           long long kl, long long kh, long long vb, long long vl, long long vh, long long gb, long long gl,
           long long gh, int causal, float scale, void* stream) {
  const Strides sq{qb, ql, qh}, sk{kb, kl, kh}, sv{vb, vl, vh}, sg{gb, gl, gh};
  const auto st = static_cast<cudaStream_t>(stream);
#define FLASH_DQ_LAUNCH(I) launch_d<T, I>(q, k, v, g, lse, delta, dq, B, L, H, D, sq, sk, sv, sg, causal, scale, st)
  switch (D) {
    case 16: return FLASH_DQ_LAUNCH(16);
    case 32: return FLASH_DQ_LAUNCH(32);
    case 64: return FLASH_DQ_LAUNCH(64);
    case 128: return FLASH_DQ_LAUNCH(128);
    case 256: return FLASH_DQ_LAUNCH(256);
    default:
      if (D > 256 && D % Dims<WIDE>::DC == 0) return FLASH_DQ_LAUNCH(WIDE);
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_DQ_LAUNCH
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
