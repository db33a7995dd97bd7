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
// Bound on the H100: operations in fp32 (4 products of 2 B H L^2 D FLOPs,
// half of that causal, against 6 reads/writes of B L H D elements); in bf16
// the tensor cores' rate, which this FFMA kernel does not reach. Design: one
// block per (b, h, 64-key tile), 128 threads (flash_bwd.cuh); the K and V
// tiles stay in shared memory, 64-row q/dO tiles stream through it from the
// diagonal tile on (causal) or from the first. A thread owns 4 keys x 8 q
// rows of the transposed tile: s^T and dp^T in registers, then p^T through
// shared memory to the p^T dO product, then dS^T through the same buffer to
// the dS^T q product. The dK and dV accumulators (64 x D fp32 each; 128
// registers a thread at D = 128) live in shared memory: 210 KB of it at
// D = 128, opted into with cudaFuncSetAttribute. At D = 256 they alone take
// 129 KB, so the operand tiles hold 64 columns at a time (flash_bwd.cuh;
// 210 KB in all): K, V, q and dO are reloaded chunk by chunk per q tile, and
// dO and q once more per chunk of the two products into the accumulators.
// D > 256 (any multiple of 64; the WIDE instance, 210 KB): one block per
// (b, h, k tile, window of 256 dk and dv columns); each window sums the
// scores over all of D as at D = 256 and runs the two products over its
// own columns.
//
// Ragged tiles and masking: a key or q row past L loads as 0, and its p is
// set to exactly 0, as is a key above the causal diagonal, so it adds 0 to
// every sum; lse and delta are not read past L.
#include "flash_bwd.cuh"

namespace {

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
  const Window<D> win(dd, windows);
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
  const int h = blockIdx.y, b = blockIdx.z;
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
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int windows = D == WIDE ? (dd + WN - 1) / WN : 1;
  const dim3 grid((L + BT - 1) / BT * windows, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      L, H, dd, windows, sq, sk, sv, sg, causal, scale);
  return static_cast<int>(cudaGetLastError());
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
  switch (D) {
    case 16: return FLASH_DKV_LAUNCH(16);
    case 32: return FLASH_DKV_LAUNCH(32);
    case 64: return FLASH_DKV_LAUNCH(64);
    case 128: return FLASH_DKV_LAUNCH(128);
    case 256: return FLASH_DKV_LAUNCH(256);
    default:
      if (D > 256 && D % Dims<WIDE>::DC == 0) return FLASH_DKV_LAUNCH(WIDE);
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_DKV_LAUNCH
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
