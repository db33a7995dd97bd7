// Shared pieces of the flash-attention backward kernels (flash_dq.cu, flash_dkv.cu)
// at D = 256 and D > 256 (WIDE), in both dtypes: FFMA, bf16 widened to fp32 at
// the load. D <= 128 runs the Hopper design of flash_bwd_sm90.cuh, whose fp32
// kernels keep the operations and order below, and so the bits of the
// instances this file served at D <= 128 before it.
//
// Both kernels recompute the probabilities of one 64 x 64 tile from the saved
// per-row LSE, p = exp(s - lse) with s = (q * scale) k^T, and the products
// dp = dO v^T of the same tile; then dS = p * (dp - delta). They differ in
// which side a block owns (a q tile for dQ, a k tile for dK/dV) and which it
// streams through shared memory.
//
// Layout of a block: 128 threads; a thread owns 4 rows (rg) and every 8th
// column (cg + 8 j) of the 64 x 64 tile, as flash_fwd.cu's D >= 256 kernels
// lay out their scores. Operand tiles live in shared memory as fp32 with odd
// row strides (W + 1 for W columns), so the 4 rows and 8 columns a warp
// reads hit distinct banks. The
// output accumulators (64 x D each) live in shared memory too: at D = 128 a
// thread's share of two of them would be 128 registers on top of the 64 that
// hold s and dp. Each tile's contribution to them is summed in registers, at
// most 8 columns at a time, and added to the accumulator once; every element
// has one owner thread, so there are no atomics and a launch is bitwise
// repeatable.
//
// Head dims above 128 (D = 256): the accumulators alone take 64 x 256 x 4 B
// each, so the operand tiles are held DC = 64 columns at a time (Dims<D>):
// the scores sum chunk after chunk (d still ascending, one fmaf a term), and
// each product into an accumulator runs chunk by chunk, reloading the
// operand's chunks from global memory (L2).
//
// Head dims above 256 (D = WIDE: the instance takes D at run time, a
// multiple of DC): a block owns one window of at most WN = 256 output
// columns (Window: its rank is tile * windows + window), so its accumulators are those
// of D = 256. It still sums the scores s and dp over all of D, chunk after
// chunk with d ascending, so every window recomputes the same p and dS bit
// for bit; then it accumulates and stores only its window's columns. At
// D <= 256 there is one window and the instances are those of before.
#pragma once

#include "common.cuh"

namespace flash_bwd {

constexpr int BT = 64;       // rows of a tile, both sides
constexpr int CG = 8;        // column groups: a thread's columns are cg + 8 j
constexpr int RG = 4;        // rows per thread
constexpr int THREADS = (BT / RG) * CG;  // 128
constexpr int CJ = BT / CG;  // tile columns per thread
constexpr int PS = BT + 1;   // row stride of the p / dS tile

constexpr int WIDE = 0;  // the D template argument of the instance for D > 256
constexpr int WN = 256;  // output columns a block of that instance owns

// Operand tiles hold DC columns at a time (NCH chunks of D; 0: D / DC at run
// time); accumulators AW columns: all D, or a window of the WIDE instance.
template <int D>
struct Dims {
  static constexpr int DC = D != WIDE && D <= 128 ? D : 64;
  static constexpr int NCH = D / DC;
  static constexpr int AW = D == WIDE ? WN : D;
  static constexpr int S = DC + 1;   // operand tiles
  static constexpr int AS = AW + 2;  // accumulators: the 4 rows a warp touches (4 apart) land 8 banks apart
  static_assert(D % DC == 0 && WN % DC == 0, "D and the window are multiples of the chunk");
};

// A block's (b, h), tile, window and chunks. The grid is one dimension over q or k tiles x windows x B x
// H with (b, h) fastest (the card's y and z dimensions would cap B and H at 65535): rank r = blockIdx.x /
// (B H) covers tile r / windows (nt - 1 - that when `reverse`: dq's heaviest causal tile, the last, first)
// and window r % windows; the window's columns are chunks [c_lo, c_hi) of the nch chunks of D.
template <int D>
struct Window {
  int b, h, tile, nch, c_lo, c_hi;
  __device__ __forceinline__ Window(int d_run, int windows, int L, int H, bool reverse) {
    using Di = Dims<D>;
    const int nt = (L + BT - 1) / BT;
    const int heads = gridDim.x / (nt * windows);
    const int bh = blockIdx.x % heads, rank = blockIdx.x / heads;
    b = bh / H;
    h = bh % H;
    tile = reverse ? nt - 1 - rank / windows : rank / windows;
    if constexpr (D == WIDE) {
      nch = d_run / Di::DC;
      c_lo = (rank % windows) * (WN / Di::DC);
      c_hi = min(nch, c_lo + WN / Di::DC);
    } else {
      nch = Di::NCH;
      c_lo = 0;
      c_hi = Di::NCH;
    }
  }
};

// The grid of B x H x the tiles of L x windows blocks; false past the grid's 2^31 - 1.
inline bool grid_for(int B, int L, int H, int windows, dim3& grid) {
  const long long blocks = static_cast<long long>((L + BT - 1) / BT) * windows * B * H;
  grid = dim3(static_cast<unsigned>(blocks));
  return blocks <= 0x7fffffff;
}

struct Strides {
  long long b, l, h;
};

// Rows [r0, r0 + 64) and W columns of one (b, h) slice of a (B, L, H, D) tensor (src points at the
// first column) into shared memory as fp32 (row stride W + 1), each times mul; rows past L load as 0.
template <typename T, int W>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride, int r0, int L,
                                          float mul) {
  constexpr int S = W + 1;
  for (int i = threadIdx.x; i < BT * W; i += THREADS) {
    const int r = i / W, d = i % W;
    const int row = r0 + r;
    dst[r * S + d] = row < L ? port::to_f32(src[row * row_stride + d]) * mul : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(float* acc) {
  constexpr int AW = Dims<D>::AW, AS = Dims<D>::AS;
  for (int i = threadIdx.x; i < BT * AW; i += THREADS) acc[(i / AW) * AS + i % AW] = 0.f;
}

__device__ __forceinline__ void zero_scores(float (&s)[RG][CJ], float (&dp)[RG][CJ]) {
#pragma unroll
  for (int i = 0; i < RG; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
}

// s[i][j] += sum_d A[row_i][d] * (B[col_j][d] * bmul) and dp[i][j] += sum_d A2[row_i][d] * B2[col_j][d]
// over the W columns of the tiles, for the thread's rows rg*4 + i and columns cg + 8 j, d ascending,
// one fmaf a term. With bmul the scale and B the raw q (dK/dV), each term rounds as flash_fwd.cu's
// pre-scaled q does.
template <int W, bool SCALE_B>
__device__ __forceinline__ void scores(float (&s)[RG][CJ], float (&dp)[RG][CJ], const float* A, const float* A2,
                                       const float* B, const float* B2, int rg, int cg, float bmul) {
  constexpr int S = W + 1;
#pragma unroll 2
  for (int d = 0; d < W; ++d) {
    float av[RG], a2v[RG], bv[CJ], b2v[CJ];
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      av[i] = A[(rg * RG + i) * S + d];
      a2v[i] = A2[(rg * RG + i) * S + d];
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      bv[j] = SCALE_B ? B[(cg + CG * j) * S + d] * bmul : B[(cg + CG * j) * S + d];
      b2v[j] = B2[(cg + CG * j) * S + d];
    }
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        dp[i][j] = fmaf(a2v[i], b2v[j], dp[i][j]);
      }
  }
}

// acc[row][col] += sum_c P[row][c] * B[c][col] over the tile's 64 c, for the thread's rows rg*4 + i
// and columns cg + 8 e of the W columns of B (acc points at B's first column, row stride AS). P is the
// p or dS tile (stride PS), B an operand tile (stride W + 1).
template <int W, int AS>
__device__ __forceinline__ void accumulate(float* acc, const float* P, const float* B, int rg, int cg) {
  constexpr int S = W + 1;
  constexpr int EJ = W / CG;             // columns a thread owns
  constexpr int EC = EJ < 8 ? EJ : 8;    // of them summed in registers at a time
#pragma unroll
  for (int e0 = 0; e0 < EJ; e0 += EC) {
    float part[RG][EC];
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int e = 0; e < EC; ++e) part[i][e] = 0.f;
#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float pv[RG], bv[EC];
#pragma unroll
      for (int i = 0; i < RG; ++i) pv[i] = P[(rg * RG + i) * PS + c];
#pragma unroll
      for (int e = 0; e < EC; ++e) bv[e] = B[c * S + cg + CG * (e0 + e)];
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int e = 0; e < EC; ++e) part[i][e] = fmaf(pv[i], bv[e], part[i][e]);
    }
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int e = 0; e < EC; ++e) acc[(rg * RG + i) * AS + cg + CG * (e0 + e)] += part[i][e];
  }
}

// Rows [r0, r0 + 64) of the accumulator, times mul, into columns [w0, w0 + AW) of one (b, h)
// slice of a contiguous (B, L, H, dd) output; rows past L and columns past dd are not written.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* out, const float* acc, int b, int h, int r0, int L, int H, int dd,
                                           int w0, float mul) {
  constexpr int AW = Dims<D>::AW, AS = Dims<D>::AS;
  const long long row_stride = static_cast<long long>(H) * dd;
  T* base = out + static_cast<long long>(b) * L * row_stride + static_cast<long long>(h) * dd + w0;
  for (int i = threadIdx.x; i < BT * AW; i += THREADS) {
    const int r = i / AW, d = i % AW;
    const int row = r0 + r;
    if (row < L && w0 + d < dd) base[row * row_stride + d] = port::from_f32<T>(acc[r * AS + d] * mul);
  }
}

}  // namespace flash_bwd
