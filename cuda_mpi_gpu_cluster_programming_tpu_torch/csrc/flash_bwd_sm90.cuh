// The Hopper flash-attention backward at the head dims 16, 32, 64 and 128:
// the pieces flash_dq.cu and flash_dkv.cu build their kernels from. (D = 256
// and the windowed instance above it keep flash_bwd.cuh.) The forward,
// flash_fwd.cu, builds its kernels at those head dims from the same pieces:
// Operand, place, load_tile, f32::RS and, in mma, the fragment addresses,
// split, as_a and product_pair.
//
// Both kernels recompute one 64 x 64 tile of s = q k^T and dp = dO v^T, then
// p = exp(s * scale - lse) (exactly 0 where masked) and dS = p * (dp - delta),
// and run two products over the tile (dq: dS k; dk/dv: p^T dO and dS^T q).
// A block is 128 threads (4 warps) and owns one 64-row tile of its outputs;
// the other side's tiles stream through shared memory by cp.async (16-byte
// copies where the operand's base and strides are 16-byte aligned, else one
// element at a time into the same layout, so both routes give the same bits).
// Rows past L load as zeros and their p is set to 0.
//
// fp32 (namespace f32): FFMA, one output element one thread, in the exact
// operations and order of the parent kernels (flash_bwd.cuh), so the fp32
// bits do not move: s and dp are one fmaf chain over d ascending from 0 (q
// rounded to q * scale first), and each visited 64-row tile of the second
// product adds one 64-term fmaf chain, started at 0, to an accumulator that
// starts at 0 and is multiplied by the scale at the store. What changed is the
// data movement: a thread owns 4 q rows x 8 keys of the score tile and 4
// (2 at D = 16) rows x 4-column runs of the output, reads shared memory in
// float4 runs along d or c (10.7 FFMA a 16-byte load at D = 64, against
// 2.7 FFMA a 4-byte load before), keeps the accumulators in registers (dK
// and dV at D = 128 in shared memory, laid out per thread), and rows are
// padded to D + 4 floats so the float4 reads of a quarter warp hit distinct
// bank groups.
//
// bf16 (namespace mma): the tensor cores, mma.sync.m16n8k16 with fp32
// accumulators, the FA-2 layout: each warp owns 16 rows of the tile. The
// score products run on the raw bf16 operands (exact products, s scaled
// after), read by ldmatrix; the C fragments of p and dS are re-packed as A
// fragments of the second products, whose B operand is read by
// ldmatrix.trans. p and dS are fp32, and a single bf16 rounding of them
// would take the outputs well past the plain versions' fp32 arithmetic, so
// each is split into hi = bf16(x) and lo = bf16(x - hi) and the product runs
// on both terms (16 significant bits, with the fp32 accumulators). Rows are
// padded to D + 8 elements (16 bytes), so ldmatrix's 8 row addresses hit
// distinct bank groups.
#pragma once

#include "common.cuh"
#include "sm90_ptx.cuh"

namespace flash_sm90 {

using port::bf16;

constexpr int BT = 64;        // rows of a tile, both sides
constexpr int THREADS = 128;  // 4 warps

// One (B, L, H, D) operand: element (0, 0, 0, 0), the b, l and h strides in elements (the last axis is
// contiguous), and whether 16-byte copies apply (base and strides 16-byte aligned).
template <typename T>
struct Operand {
  const T* p;
  long long b, l, h;
  int vec;
  __device__ __forceinline__ const T* slice(int bi, int hi) const { return p + bi * b + hi * h; }
};

// The block's 64-row tile and (b, h). The grid is one dimension over tiles x B x H with (b, h) fastest, so
// every head's tile of one rank is launched before any head's tile of the next; rank 0 is tile nt - 1 when
// `reverse` (dq's heaviest causal tile, the last), else tile 0 (dk/dv's heaviest, the first).
struct Place {
  int tile, b, h;
};

__device__ __forceinline__ Place place(int nt, int H, bool reverse) {
  const int heads = gridDim.x / nt;  // B * H
  const int bh = blockIdx.x % heads, rank = blockIdx.x / heads;
  return Place{reverse ? nt - 1 - rank : rank, bh / H, bh % H};
}

template <typename T>
inline Operand<T> operand(const void* p, long long b, long long l, long long h) {
  constexpr long long V = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(p) % 16 == 0 && b % V == 0 && l % V == 0 && h % V == 0;
  return Operand<T>{static_cast<const T*>(p), b, l, h, vec ? 1 : 0};
}

// Rows [r0, r0 + 64) and the D columns of one (b, h) slice (src: its row 0) into the shared tile at the
// shared address dst (row stride RS elements); rows past L as zeros. cp.async, 16 bytes a copy where vec;
// else fp32 by 4-byte cp.async and bf16 by plain loads and shared stores (cp.async has no 2-byte copy).
template <typename T, int D, int RS>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src, long long ls, int r0, int L, bool vec) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int CH = D / V;  // 16-byte chunks a row
  if (vec) {
    for (int i = threadIdx.x; i < BT * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * V;
      const bool ok = r0 + r < L;
      sm90::cp_async16(dst + (r * RS + c) * sizeof(T), src + (ok ? r0 + r : 0) * ls + c, ok);
    }
    return;
  }
  for (int i = threadIdx.x; i < BT * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const bool ok = r0 + r < L;
    const uint32_t a = dst + (r * RS + c) * sizeof(T);
    if constexpr (sizeof(T) == 4) {
      sm90::cp_async4(a, src + (ok ? r0 + r : 0) * ls + c, ok);
    } else {
      sm90::st_shared(a, ok ? src[(r0 + r) * ls + c] : __ushort_as_bfloat16(0));
    }
  }
}

// ------------------------------------------------------------------ fp32: FFMA

namespace f32 {

constexpr int SR = 4;  // q rows of the score tile a thread owns: rg + 16 i
constexpr int SC = 8;  // keys: cg + 8 j (rg = tid / 8, cg = tid % 8)

template <int D>
constexpr int RS = D + 4;  // row stride of an operand tile, floats

// s[i][j] (q row rg + 16 i, key cg + 8 j) = fmaf chain over d ascending from 0 of (q * scale) k, and
// dp[i][j] that of dO v; Q and G are the q and dO tiles, K and V the key tiles, all rows d-contiguous.
template <int D>
__device__ __forceinline__ void scores(float (&s)[SR][SC], float (&dp)[SR][SC], const float* Q, const float* G,
                                       const float* K, const float* V, int rg, int cg, float scale) {
  constexpr int S = RS<D>;
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int j = 0; j < SC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 1
  for (int d = 0; d < D; d += 4) {
    float a[SR][4], b[SC][4];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      *reinterpret_cast<float4*>(a[i]) = *reinterpret_cast<const float4*>(Q + (rg + 16 * i) * S + d);
#pragma unroll
      for (int e = 0; e < 4; ++e) a[i][e] *= scale;
    }
#pragma unroll
    for (int j = 0; j < SC; ++j)
      *reinterpret_cast<float4*>(b[j]) = *reinterpret_cast<const float4*>(K + (cg + 8 * j) * S + d);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = fmaf(a[i][e], b[j][e], s[i][j]);
#pragma unroll
    for (int i = 0; i < SR; ++i)
      *reinterpret_cast<float4*>(a[i]) = *reinterpret_cast<const float4*>(G + (rg + 16 * i) * S + d);
#pragma unroll
    for (int j = 0; j < SC; ++j)
      *reinterpret_cast<float4*>(b[j]) = *reinterpret_cast<const float4*>(V + (cg + 8 * j) * S + d);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) dp[i][j] = fmaf(a[i][e], b[j][e], dp[i][j]);
  }
}

// A thread's share of a 64 x D output: rows pr * TM + i, columns in runs of 4 at pc * 4 + 4 * CG * r.
template <int D>
struct Out {
  static constexpr int CG = D >= 32 ? 8 : D / 4;  // column groups
  static constexpr int RUNS = D / (4 * CG);        // runs of 4 columns a thread owns
  static constexpr int TM = BT * CG / THREADS;     // rows a thread owns
  static constexpr int N = TM * RUNS * 4;          // its elements: acc[(i * RUNS + r) * 4 + e]
  static constexpr int RC = RUNS < 2 ? RUNS : 2;   // runs summed in registers at a time
};

// A thread's accumulator of its share of a 64 x D output: registers, or (SMEM) shared memory laid out per
// thread, float4 s[at * THREADS + tid] for element group at = i * RUNS + r (4 columns of row i).
template <int D, bool SMEM>
struct Acc {
  float r[SMEM ? 1 : Out<D>::N];
  float4* s;

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int at = 0; at < Out<D>::N / 4; ++at) {
      if constexpr (SMEM) {
        s[at * THREADS + threadIdx.x] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) r[at * 4 + e] = 0.f;
      }
    }
  }
  __device__ __forceinline__ float4 get(int at) const {
    if constexpr (SMEM) {
      return s[at * THREADS + threadIdx.x];
    } else {
      return make_float4(r[at * 4], r[at * 4 + 1], r[at * 4 + 2], r[at * 4 + 3]);
    }
  }
  // acc = acc + part, element by element
  __device__ __forceinline__ void add(int at, const float* part) {
    if constexpr (SMEM) {
      float4 v = s[at * THREADS + threadIdx.x];
      v.x += part[0];
      v.y += part[1];
      v.z += part[2];
      v.w += part[3];
      s[at * THREADS + threadIdx.x] = v;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) r[at * 4 + e] += part[e];
    }
  }
};

// acc += the tile's partial: for each of the thread's elements (row, col), part = fmaf chain over the
// tile's 64 c ascending from 0 of P[row][c] * B[c][col], then acc = acc + part. P: the dS, p^T or dS^T
// tile (row stride PS), B: an operand tile (row stride RS<D>).
template <int D, int PS, bool SMEM>
__device__ __forceinline__ void product(Acc<D, SMEM>& acc, const float* P, const float* B, int pr, int pc) {
  using O = Out<D>;
  constexpr int S = RS<D>;
#pragma unroll
  for (int r0 = 0; r0 < O::RUNS; r0 += O::RC) {
    float part[O::TM][O::RC * 4];
#pragma unroll
    for (int i = 0; i < O::TM; ++i)
#pragma unroll
      for (int e = 0; e < O::RC * 4; ++e) part[i][e] = 0.f;
#pragma unroll 2
    for (int c = 0; c < BT; c += 4) {
      float pv[O::TM][4];
#pragma unroll
      for (int i = 0; i < O::TM; ++i)
        *reinterpret_cast<float4*>(pv[i]) = *reinterpret_cast<const float4*>(P + (pr * O::TM + i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float bv[O::RC][4];
#pragma unroll
        for (int r = 0; r < O::RC; ++r)
          *reinterpret_cast<float4*>(bv[r]) =
              *reinterpret_cast<const float4*>(B + (c + cc) * S + pc * 4 + 4 * O::CG * (r0 + r));
#pragma unroll
        for (int i = 0; i < O::TM; ++i)
#pragma unroll
          for (int r = 0; r < O::RC; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[i][r * 4 + e] = fmaf(pv[i][cc], bv[r][e], part[i][r * 4 + e]);
      }
    }
#pragma unroll
    for (int i = 0; i < O::TM; ++i)
#pragma unroll
      for (int r = 0; r < O::RC; ++r) acc.add(i * O::RUNS + r0 + r, part[i] + r * 4);
  }
}

// The thread's elements of the accumulator, times mul, into rows [r0, r0 + 64) of one (b, h) slice of a
// contiguous (B, L, H, D) output; rows past L are not written.
template <int D, bool SMEM>
__device__ __forceinline__ void store(float* out, const Acc<D, SMEM>& acc, int b, int h, int r0, int L, int H,
                                      float mul, int pr, int pc) {
  using O = Out<D>;
  const long long rs = static_cast<long long>(H) * D;
  float* base = out + static_cast<long long>(b) * L * rs + static_cast<long long>(h) * D;
#pragma unroll
  for (int i = 0; i < O::TM; ++i) {
    const int row = r0 + pr * O::TM + i;
    if (row >= L) continue;
#pragma unroll
    for (int r = 0; r < O::RUNS; ++r) {
      float4 v = acc.get(i * O::RUNS + r);
      v.x *= mul;
      v.y *= mul;
      v.z *= mul;
      v.w *= mul;
      *reinterpret_cast<float4*>(base + row * rs + pc * 4 + 4 * O::CG * r) = v;
    }
  }
}

}  // namespace f32

// ------------------------------------------------------------------ bf16: the tensor cores

namespace mma {

template <int D>
constexpr int RS = D + 8;  // row stride of an operand tile, elements

// ldmatrix row addresses (lane: the calling lane) of one x4 load from a bf16 tile at the shared address
// `tile`, row stride RS:
//  * frag_a(): the A fragment (16 x 16) at rows m0.., columns k0.. of a row-major tile;
//  * frag_b_nk(): the B fragments of two 8-column n-tiles (n0.., n0 + 8..) x k16 (k0..) of a tile stored
//    [n][k] (no transpose): regs {b0, b1} of n-tile 0, then of n-tile 1. From a tile stored [k][n],
//    ldmatrix.trans gives the same registers from frag_a()'s addresses at rows k0.., columns n0...
template <int RS>
__device__ __forceinline__ uint32_t frag_a(uint32_t tile, int m0, int k0, int lane) {
  const int mat = lane >> 3, r = lane & 7;
  return tile + ((m0 + r + (mat & 1) * 8) * RS + k0 + (mat >> 1) * 8) * 2;
}

template <int RS>
__device__ __forceinline__ uint32_t frag_b_nk(uint32_t tile, int n0, int k0, int lane) {
  const int mat = lane >> 3, r = lane & 7;
  return tile + ((n0 + r + (mat >> 1) * 8) * RS + k0 + (mat & 1) * 8) * 2;
}

// c (16 x 64: 8 n-tiles) += A (16 rows of a row-major tile at m0) times the 64 rows of a tile stored
// [n][k] (B^T), over D columns: the score products.
template <int D>
__device__ __forceinline__ void scores(float (&c)[8][4], uint32_t A, int m0, uint32_t Bt, int lane) {
  constexpr int S = RS<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    sm90::ldmatrix_x4(af, frag_a<S>(A, m0, kk * 16, lane));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      sm90::ldmatrix_x4(bf, frag_b_nk<S>(Bt, np * 16, kk * 16, lane));
      sm90::mma_bf16(c[2 * np], af, bf[0], bf[1]);
      sm90::mma_bf16(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// hi = bf16(x), lo = bf16(x - hi), two elements a register (x: the lower column).
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The A fragments (hi and lo terms) of the four k16 steps of a 16 x 64 tile held as C fragments.
__device__ __forceinline__ void as_a(const float (&c)[8][4], uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split(c[2 * kk][0], c[2 * kk][1], hi[kk][0], lo[kk][0]);
    split(c[2 * kk][2], c[2 * kk][3], hi[kk][1], lo[kk][1]);
    split(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
    split(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
  }
}

// acc (16 x 16: n-tiles 2 np, 2 np + 1) += (hi + lo) (16 x 64) times rows 0..63, columns np * 16.. of a
// row-major tile B (stride RS<D>): the second products.
template <int D>
__device__ __forceinline__ void product_pair(float (&acc0)[4], float (&acc1)[4], const uint32_t (&hi)[4][4],
                                             const uint32_t (&lo)[4][4], uint32_t B, int np, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t bf[4];
    sm90::ldmatrix_x4_trans(bf, frag_a<RS<D>>(B, kk * 16, np * 16, lane));
    sm90::mma_bf16(acc0, hi[kk], bf[0], bf[1]);
    sm90::mma_bf16(acc0, lo[kk], bf[0], bf[1]);
    sm90::mma_bf16(acc1, hi[kk], bf[2], bf[3]);
    sm90::mma_bf16(acc1, lo[kk], bf[2], bf[3]);
  }
}

// A warp's 16 rows (m0 + g, m0 + g + 8) of a 64 x D accumulator in C fragments, times mul, into rows
// [r0, r0 + 64) of one (b, h) slice of a contiguous (B, L, H, D) bf16 output; rows past L are not written.
template <int D>
__device__ __forceinline__ void store(bf16* out, const float (&acc)[D / 8][4], int b, int h, int r0, int m0,
                                      int L, int H, float mul, int lane) {
  const long long rs = static_cast<long long>(H) * D;
  bf16* base = out + static_cast<long long>(b) * L * rs + static_cast<long long>(h) * D + (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + m0 + (lane >> 2) + half * 8;
    if (row >= L) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(base + row * rs + nt * 8) =
          __floats2bfloat162_rn(acc[nt][2 * half] * mul, acc[nt][2 * half + 1] * mul);
  }
}

}  // namespace mma

}  // namespace flash_sm90
