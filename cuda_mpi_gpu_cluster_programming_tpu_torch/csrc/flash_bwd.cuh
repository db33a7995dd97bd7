// Shared pieces of the flash-attention backward kernels (flash_dq.cu, flash_dkv.cu).
//
// Both kernels recompute the probabilities of one 64 x 64 tile from the saved
// per-row LSE, p = exp(s - lse) with s = (q * scale) k^T, and the products
// dp = dO v^T of the same tile; then dS = p * (dp - delta). They differ in
// which side a block owns (a q tile for dQ, a k tile for dK/dV) and which it
// streams through shared memory.
//
// Layout of a block: 128 threads; a thread owns 4 rows (rg) and every 8th
// column (cg + 8 j) of the 64 x 64 tile, as flash_fwd.cu lays out its scores.
// Operand tiles live in shared memory as fp32 with odd row strides (D + 1),
// so the 4 rows and 8 columns a warp reads hit distinct banks. The output
// accumulators (64 x D each) live in shared memory too: at D = 128 a thread's
// share of two of them would be 128 registers on top of the 64 that hold s
// and dp. Each tile's contribution to them is summed in registers, at most
// 8 columns at a time, and added to the accumulator once; every element has
// one owner thread, so there are no atomics and a launch is bitwise
// repeatable.
#pragma once

#include "common.cuh"

namespace flash_bwd {

constexpr int BT = 64;       // rows of a tile, both sides
constexpr int CG = 8;        // column groups: a thread's columns are cg + 8 j
constexpr int RG = 4;        // rows per thread
constexpr int THREADS = (BT / RG) * CG;  // 128
constexpr int CJ = BT / CG;  // tile columns per thread
constexpr int PS = BT + 1;   // row stride of the p / dS tile

template <int D>
struct Strides2 {
  static constexpr int S = D + 1;   // operand tiles
  static constexpr int AS = D + 2;  // accumulators: the 4 rows a warp touches (4 apart) land 8 banks apart
};

struct Strides {
  long long b, l, h;
};

// Rows [r0, r0 + 64) of one (b, h) slice of a (B, L, H, D) tensor into shared
// memory as fp32 (row stride S), each times mul; rows past L load as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride, int r0, int L,
                                          float mul) {
  constexpr int S = Strides2<D>::S;
  for (int i = threadIdx.x; i < BT * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int row = r0 + r;
    dst[r * S + d] = row < L ? port::to_f32(src[row * row_stride + d]) * mul : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(float* acc) {
  constexpr int AS = Strides2<D>::AS;
  for (int i = threadIdx.x; i < BT * D; i += THREADS) acc[(i / D) * AS + i % D] = 0.f;
}

// s[i][j] = sum_d A[row_i][d] * (B[col_j][d] * bmul) and dp[i][j] = sum_d A2[row_i][d] * B2[col_j][d]
// for the thread's rows rg*4 + i and columns cg + 8 j, d ascending, one fmaf a term. With bmul the
// scale and B the raw q (dK/dV), each term rounds as flash_fwd.cu's pre-scaled q does.
template <int D, bool SCALE_B>
__device__ __forceinline__ void scores(float (&s)[RG][CJ], float (&dp)[RG][CJ], const float* A, const float* A2,
                                       const float* B, const float* B2, int rg, int cg, float bmul) {
  constexpr int S = Strides2<D>::S;
#pragma unroll
  for (int i = 0; i < RG; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
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
// and columns cg + 8 e. P is the p or dS tile (stride PS), B an operand tile (stride S).
template <int D>
__device__ __forceinline__ void accumulate(float* acc, const float* P, const float* B, int rg, int cg) {
  constexpr int S = Strides2<D>::S, AS = Strides2<D>::AS;
  constexpr int EJ = D / CG;             // columns a thread owns
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

// Rows [r0, r0 + 64) of the accumulator, times mul, into one (b, h) slice of a contiguous
// (B, L, H, D) output; rows past L are not written.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* out, const float* acc, int b, int h, int r0, int L, int H,
                                           float mul) {
  constexpr int AS = Strides2<D>::AS;
  const long long row_stride = static_cast<long long>(H) * D;
  T* base = out + static_cast<long long>(b) * L * row_stride + static_cast<long long>(h) * D;
  for (int i = threadIdx.x; i < BT * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int row = r0 + r;
    if (row < L) base[row * row_stride + d] = port::from_f32<T>(acc[r * AS + d] * mul);
  }
}

}  // namespace flash_bwd
