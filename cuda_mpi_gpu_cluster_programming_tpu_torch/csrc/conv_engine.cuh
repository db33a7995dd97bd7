// The implicit-GEMM engine of conv_taps.cu and conv_g8.cu (conv2d.cu,
// conv_block.cu, conv_im2col.cu and conv_pairs.cu run conv_sm90.cuh).
//
// Every conv variant is one GEMM: rows are output pixels (n, oy, ox),
// columns are output channels, and the reduction runs over KG terms in the
// variant's fixed order. A variant is an operand policy ("Op") that says
// where reduction term kg of a pixel lives (a per-thread Loader, read in
// order) and where weight row kg lives (row()). The engine owns the rest:
//   * a block computes a BM x BN tile in BK-term slices staged through
//     shared memory, a TM x TN register tile per thread, one fmaf per term
//     in kg order from 0 (so two variants whose term orders agree give the
//     same bits);
//   * the epilogue adds the bias in fp32, applies ReLU (a NaN stays NaN, as
//     with jnp.maximum) and casts once to the element type;
//   * k_block (the TPU kernel's K grid dimension): a block owns k_block
//     output channels and walks them BN at a time. Each element's sum is
//     the same chain, so the result is bitwise that of k_block = 0;
//   * hpool (the TPU kernel's _conv_epilogue hpool fusion): a block owns a
//     band of pooled rows of one image and BN channels, computes the conv
//     rows the band's pool windows need into shared memory (cast, exactly
//     the values the unfused conv writes), takes the H-axis max in the
//     pool's tap order (the first of equal values, a NaN wins) and writes
//     (N, Hp, Wo, K) once. The conv row shared by two neighbouring bands is
//     computed twice. The W stage (maxpool.cu with a 1 x pw window) then
//     gives bitwise the conv -> maxpool2d result: max is exact.
// Bound on the H100: operations (FFMA; the fp32 contract rules out TF32).
#pragma once

#include <algorithm>

#include "common.cuh"

namespace {
namespace engine {

constexpr int BM = 128;  // output pixels per tile
constexpr int BN = 32;   // output channels per tile
constexpr int BK = 16;   // reduction terms staged per step
constexpr int TM = 8;    // pixels per thread
constexpr int TN = 4;    // channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 128
static_assert(THREADS == BM, "the A loader gives each thread one pixel row");
static_assert(BK * BN == 4 * THREADS, "the B loader gives each thread 4 weights");

// Pooled rows per block of the hpool kernel, at most (fewer where the
// band's conv rows would pass HPOOL_SMEM bytes of shared memory).
constexpr int HPOOL_BAND = 4;
constexpr size_t HPOOL_SMEM = 96 * 1024;

struct Tile {
  float As[BK][BM];
  float Bs[BK][BN];
};

// acc = the BM x BN tile of pixels (one per thread, set up in `a`) times
// weight columns [n0, n0 + BN), over the Op's KG terms in order.
template <class Op>
__device__ __forceinline__ void accumulate(const Op& op, typename Op::Loader a, int n0, Tile& sm,
                                           float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int b_row = tid / (BN / 4);
  const int b_col = (tid % (BN / 4)) * 4;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < op.KG; k0 += BK) {
#pragma unroll
    for (int j = 0; j < BK; ++j) sm.As[j][tid] = a.next(k0 + j < op.KG);
    {
      const int kg = k0 + b_row;
      const typename Op::Elem* wrow = kg < op.KG ? op.row(kg) : nullptr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + b_col + j;
        sm.Bs[b_row][b_col + j] = (wrow != nullptr && n < op.K) ? port::to_f32(wrow[n]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = sm.As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = sm.Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The space-to-depth window operand policy of conv_taps.cu and conv_g8.cu:
// xs (N, Hs, Ws, cs) and w (fq, fq, cs, K). Output pixel (oy, ox), term
// kg = (qh*fq + qw)*cs + c (the row-major order of w viewed as a (fq*fq*cs,
// K) matrix) reads xs pixel (oy + qh, ox + qw), channel c. The fq*cs terms
// of one qh row are contiguous in xs (pixel ox + qw + 1 follows ox + qw), so
// the gather is a pointer that steps by one and jumps once per qh row.
template <typename T>
struct S2dOp {
  using Elem = T;
  const T* xs;
  const T* w;
  int K, KG;
  int Hs, Ws, cs, fq;

  struct Loader {
    const T* p;  // the next term
    int left;    // terms left in this qh row
    int run;     // fq * cs terms per qh row
    int skip;    // (Ws - fq) * cs: from the end of one qh row to the next
    bool ok;

    __device__ __forceinline__ float next(bool valid) {
      const float v = (ok && valid) ? port::to_f32(*p) : 0.f;
      ++p;
      if (--left == 0) {
        left = run;
        p += skip;
      }
      return v;
    }
  };

  __device__ __forceinline__ Loader loader(bool ok, int n, int oy, int ox) const {
    return Loader{xs + ((static_cast<size_t>(n) * Hs + oy) * Ws + ox) * cs, fq * cs, fq * cs,
                  (Ws - fq) * cs, ok};
  }
  __device__ __forceinline__ const T* row(int kg) const { return w + static_cast<size_t>(kg) * K; }
};

template <typename T>
__device__ __forceinline__ T epilogue(float acc, const T* bias, int n, int relu) {
  float v = acc + port::to_f32(bias[n]);
  if (relu && v < 0.f) v = 0.f;
  return port::from_f32<T>(v);
}

// (N, Ho, Wo, K) output; grid (pixel tiles, channel blocks), each block
// owning kb_tiles x BN channels (1 tile when k_block = 0).
template <class Op>
__global__ void __launch_bounds__(THREADS)
conv_kernel(Op op, const typename Op::Elem* __restrict__ bias, typename Op::Elem* __restrict__ y,
            int N, int Ho, int Wo, int relu, int kb_tiles) {
  __shared__ Tile sm;
  const int tid = threadIdx.x;
  const int M = N * Ho * Wo;
  const int m0 = blockIdx.x * BM;
  const int am = m0 + tid;
  const bool ok = am < M;
  int an = 0, aoy = 0, aox = 0;
  if (ok) {
    an = am / (Ho * Wo);
    const int r = am - an * Ho * Wo;
    aoy = r / Wo;
    aox = r - aoy * Wo;
  }
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  for (int t = 0; t < kb_tiles; ++t) {
    const int n0 = (blockIdx.y * kb_tiles + t) * BN;
    if (n0 >= op.K) break;  // the same for every thread of the block
    float acc[TM][TN];
    accumulate(op, op.loader(ok, an, aoy, aox), n0, sm, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx * TN + j;
        if (n >= op.K) continue;
        y[static_cast<size_t>(m) * op.K + n] = epilogue(acc[i][j], bias, n, relu);
      }
    }
  }
}

// (N, Hp, Wo, K) output: conv, then the H-axis max of a pw / ps pool.
// grid (channel tiles, bands of pooled rows, images).
template <class Op>
__global__ void __launch_bounds__(THREADS)
conv_hpool_kernel(Op op, const typename Op::Elem* __restrict__ bias, typename Op::Elem* __restrict__ y,
                  int Wo, int pw, int ps, int Hp, int band, int relu) {
  using T = typename Op::Elem;
  extern __shared__ __align__(16) unsigned char hpool_rows_bytes[];
  T* rows = reinterpret_cast<T*>(hpool_rows_bytes);  // [band conv rows][Wo][BN]
  __shared__ Tile sm;

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int n0 = blockIdx.x * BN;
  const int py0 = blockIdx.y * band;
  const int py1 = min(Hp, py0 + band);
  const int r0 = py0 * ps;                      // first conv row of the band
  const int npix = ((py1 - 1 - py0) * ps + pw) * Wo;  // its conv pixels
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  for (int p0 = 0; p0 < npix; p0 += BM) {
    const int p = p0 + tid;
    const bool ok = p < npix;
    const int dr = ok ? p / Wo : 0;
    float acc[TM][TN];
    accumulate(op, op.loader(ok, n, r0 + dr, ok ? p - dr * Wo : 0), n0, sm, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int pl = p0 + ty * TM + i;
      if (pl >= npix) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int ch = n0 + tx * TN + j;
        if (ch >= op.K) continue;
        rows[static_cast<size_t>(pl) * BN + tx * TN + j] = epilogue(acc[i][j], bias, ch, relu);
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < (py1 - py0) * Wo * BN; i += THREADS) {
    const int cl = i % BN;
    const int rest = i / BN;
    const int ox = rest % Wo;
    const int dpy = rest / Wo;
    const int ch = n0 + cl;
    if (ch >= op.K) continue;
    const T* col = rows + static_cast<size_t>(dpy * ps * Wo + ox) * BN + cl;
    T best = col[0];
    float bf = port::to_f32(best);
    for (int fy = 0; fy < pw; ++fy) {
      const T v = col[static_cast<size_t>(fy) * Wo * BN];
      const float vf = port::to_f32(v);
      if (vf > bf || vf != vf) {
        best = v;
        bf = vf;
      }
    }
    y[((static_cast<size_t>(n) * Hp + py0 + dpy) * Wo + ox) * op.K + ch] = best;
  }
}

// Launch conv_kernel for the Op on the stream: k_block in {0, 64, 128},
// with K % k_block == 0 when it is not 0. Returns the launch's CUDA error.
template <class Op>
int launch_tiles(const Op& op, const void* b, void* y, int N, int Ho, int Wo, int relu, int k_block,
                 void* stream) {
  using T = typename Op::Elem;
  const long long M = static_cast<long long>(N) * Ho * Wo;
  dim3 grid(port::blocks_for(M, BM), k_block ? op.K / k_block : port::blocks_for(op.K, BN));
  conv_kernel<Op><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      op, static_cast<const T*>(b), static_cast<T*>(y), N, Ho, Wo, relu, k_block ? k_block / BN : 1);
  return static_cast<int>(cudaGetLastError());
}

// Launch conv_hpool_kernel for the Op on the stream (pool window pw, stride
// ps, Hp pooled rows). Returns the CUDA error of its set-up or launch.
template <class Op>
int launch_hpool(const Op& op, const void* b, void* y, int N, int Wo, int relu, int pw, int ps, int Hp,
                 void* stream) {
  using T = typename Op::Elem;
  auto rows_bytes = [&](int bd) { return static_cast<size_t>((bd - 1) * ps + pw) * Wo * BN * sizeof(T); };
  int band = std::min(HPOOL_BAND, Hp);
  while (band > 1 && rows_bytes(band) > HPOOL_SMEM) --band;
  auto kernel = conv_hpool_kernel<Op>;
  // A band past what the card allows is refused here, with this error code.
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(rows_bytes(band)));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(port::blocks_for(op.K, BN), port::blocks_for(Hp, band), N);
  kernel<<<grid, THREADS, rows_bytes(band), static_cast<cudaStream_t>(stream)>>>(
      op, static_cast<const T*>(b), static_cast<T*>(y), Wo, pw, ps, Hp, band, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace engine
}  // namespace
