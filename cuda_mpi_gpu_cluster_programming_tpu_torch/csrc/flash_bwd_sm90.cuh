// The Hopper flash-attention backward: the pieces flash_dq.cu and flash_dkv.cu
// build their kernels from, at the head dims 16, 32, 64 and 128 (namespaces
// f32 and mma) and at D = 256 and the windowed instance above it (namespace
// wide). The forward, flash_fwd.cu, builds its kernels from the same
// pieces: at D <= 128 Operand, place, load_tile, f32::RS and, in mma, the
// fragment addresses, split, as_a and product_pair; at D = 256 and above
// wide's place, grid_for, load_chunk and, in wide::mma, scores, store_split,
// frags and product.
//
// Both kernels recompute one 64 x 64 tile of s = q k^T and dp = dO v^T, then
// p = exp(s * scale - lse) (exactly 0 where masked) and dS = p * (dp - delta),
// and run two products over the tile (dq: dS k; dk/dv: p^T dO and dS^T q).
// At D <= 128 a block is 128 threads (4 warps) and owns one 64-row tile of
// its outputs; the other side's tiles stream through shared memory by
// cp.async (16-byte copies where the operand's base and strides are 16-byte
// aligned, else one element at a time into the same layout, so both routes
// give the same bits). Rows past L load as zeros and their p is set to 0.
//
// fp32 (namespace f32): FFMA, one output element one thread, in the exact
// operations and order of the first FFMA kernels (PRs 5-8), so the fp32
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
//
// D = 256 and above (namespace wide): a block is 256 threads (8 warps) and
// owns one 64-row tile and one window of 256 output columns, or of 128
// where 256 would leave SMs without a block (grid_for; the WIDE instance
// takes D, a multiple of 64, at run time). The operands move as 64 x 64
// chunks: a block's schedule is, for each visited tile of the other side,
// the D / 64 score steps (the chunk c of each operand the scores read,
// summed into s and dp chunk after chunk) and then one product step per
// window chunk of each product operand (dq: k; dk/dv: dO, then q), each
// step one stage of a cp.async ring that runs ahead across the visited
// tiles. Every window recomputes the same s and dp over all of D. A thread's
// or warp's share of the window (64 x 256 of each output) stays in
// registers; no atomics.
//  * bf16 (wide::mma): the 8 warps split the 64 x 64 score tile as 4 row
//    groups x 2 key halves (a warp: 16 x 32, mma.sync on ldmatrix
//    fragments); p and dS are split into hi and lo and written once to
//    shared memory as bf16 tiles, from which each warp loads its 16 rows'
//    A fragments once a tile; the second products split the output by
//    columns (a warp: 16 rows x 32 columns of each window chunk, 64 fp32
//    accumulators a thread an output). At D = 256 the own side's operands
//    (dq: q and dO; dk/dv: k and v) stay in shared memory for the whole
//    block, a score step loads only the other side's two chunks (the
//    window's chunks first), and the product steps find theirs in the ring.
//  * fp32 (wide::f32): FFMA with the bits of the first FFMA kernels, as
//    above: a thread owns 4 q rows x 4 keys of the score tile (rows rg + 16 i,
//    keys cg + 16 j) and 4 rows x 4 columns of each window chunk, float4
//    reads along d and c, chunk rows padded to 68 floats. All four operands
//    stream (a 64 x 256 fp32 tile is 64 KB).
#pragma once

#include "common.cuh"
#include "sm90_ptx.cuh"

namespace flash_sm90 {

using port::bf16;

constexpr int BT = 64;        // rows of a tile, both sides
constexpr int THREADS = 128;  // 4 warps

// The b, l and h strides in elements of a (B, L, H, D) operand, as the entry points take them.
struct Strides {
  long long b, l, h;
};

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
template <typename T, int D, int RS, int NT = THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src, long long ls, int r0, int L, bool vec) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int CH = D / V;  // 16-byte chunks a row
  if (vec) {
    for (int i = threadIdx.x; i < BT * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * V;
      const bool ok = r0 + r < L;
      sm90::cp_async16(dst + (r * RS + c) * sizeof(T), src + (ok ? r0 + r : 0) * ls + c, ok);
    }
    return;
  }
  for (int i = threadIdx.x; i < BT * D; i += NT) {
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

// ------------------------------------------------------------------ D >= 256: 8 warps, 64-column chunks

namespace wide {

constexpr int THREADS = 256;   // 8 warps
constexpr int CW = 64;         // columns of a chunk
constexpr int WN = 256;        // output columns of a window
constexpr int NWC = WN / CW;   // chunks of a window
constexpr int WIDE = 0;        // the D template argument of the instance for D > 256

// A block's (b, h), 64-row tile and window of wn chunks. The grid is one dimension over tiles x windows x B x H
// with (b, h) fastest (the card's y and z dimensions would cap B and H at 65535): rank r = blockIdx.x / (B H)
// covers tile r / windows (nt - 1 - that when `reverse`: dq's heaviest causal tile, the last, first) and
// window r % windows, whose output columns are chunks [c_lo, c_lo + nwin) of the nch chunks of D.
struct Place {
  int b, h, tile, nch, c_lo, nwin;
};

__device__ __forceinline__ Place place(int dd, int wn, int L, int H, bool reverse) {
  const int nt = (L + BT - 1) / BT;
  const int nch = dd / CW, windows = (nch + wn - 1) / wn;
  const int heads = gridDim.x / (nt * windows);
  const int bh = blockIdx.x % heads, rank = blockIdx.x / heads;
  const int c_lo = (rank % windows) * wn;
  return Place{bh / H, bh % H, reverse ? nt - 1 - rank / windows : rank / windows, nch, c_lo, min(wn, nch - c_lo)};
}

// The grid of B x H x the tiles of L x the windows of D, and wn, the chunks of a window: NWC (256 columns), or
// NWC / 2 when that grid would leave an SM without a block. A block keeps an SM to itself and visits up to
// L / 64 tiles of the other side, so on a small causal grid the heaviest blocks set the time; halving the
// windows doubles the blocks and halves each one's second products (the scores are recomputed by both
// halves). Each output element's arithmetic is the same either way. False past the grid's 2^31 - 1.
inline bool grid_for(int B, int L, int H, int dd, dim3& grid, int& wn) {
  const int nch = dd / CW;
  const long long tiles = static_cast<long long>((L + BT - 1) / BT) * B * H;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  wn = tiles * ((nch + NWC - 1) / NWC) < sms ? NWC / 2 : NWC;
  const long long blocks = tiles * ((nch + wn - 1) / wn);
  grid = dim3(static_cast<unsigned>(blocks));
  return blocks <= 0x7fffffff;
}

// Rows [r0, r0 + 64) of chunk c (columns 64 c ..) of one (b, h) slice (src: its row 0) into a chunk tile at
// the shared address dst (row stride RS elements); rows past L as zeros.
template <typename T, int RS>
__device__ __forceinline__ void load_chunk(uint32_t dst, const T* src, long long ls, int c, int r0, int L,
                                           bool vec) {
  load_tile<T, CW, RS, THREADS>(dst, src + c * CW, ls, r0, L, vec);
}

// ---------------------------------------------------------- bf16: the tensor cores

namespace mma {

constexpr int CS = CW + 8;           // row stride of a chunk tile, elements
constexpr int TILE = BT * CS * 2;    // bytes of a chunk tile (and of a split p or dS half)

// c (16 x 32: 4 n-tiles) += rows m0.. of the chunk tile A times rows n0.. of the chunk tile B^T (B stored
// [n][k]) over the chunk's 64 columns: a warp's share of a score product.
__device__ __forceinline__ void scores(float (&c)[4][4], uint32_t A, int m0, uint32_t B, int n0, int lane) {
#pragma unroll
  for (int kk = 0; kk < CW / 16; ++kk) {
    uint32_t af[4];
    sm90::ldmatrix_x4(af, flash_sm90::mma::frag_a<CS>(A, m0, kk * 16, lane));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bf[4];
      sm90::ldmatrix_x4(bf, flash_sm90::mma::frag_b_nk<CS>(B, n0 + np * 16, kk * 16, lane));
      sm90::mma_bf16(c[2 * np], af, bf[0], bf[1]);
      sm90::mma_bf16(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// A warp's 16 x 32 C fragments (rows m0.., columns n0..), split into hi = bf16(x) and lo = bf16(x - hi),
// into the bf16 tiles at the shared addresses hi and lo (row stride CS).
__device__ __forceinline__ void store_split(const float (&c)[4][4], uint32_t hi, uint32_t lo, int m0, int n0,
                                            int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t h, l;
      flash_sm90::mma::split(c[n][2 * half], c[n][2 * half + 1], h, l);
      const uint32_t off = ((m0 + (lane >> 2) + 8 * half) * CS + n0 + n * 8 + 2 * (lane & 3)) * 2;
      sm90::st_shared_b32(hi + off, h);
      sm90::st_shared_b32(lo + off, l);
    }
}

// The A fragments of rows m0.. x the 64 columns of the split tiles: a[0] from hi, a[1] from lo, per k16 step.
__device__ __forceinline__ void frags(uint32_t (&a)[2][4][4], uint32_t hi, uint32_t lo, int m0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    sm90::ldmatrix_x4(a[0][kk], flash_sm90::mma::frag_a<CS>(hi, m0, kk * 16, lane));
    sm90::ldmatrix_x4(a[1][kk], flash_sm90::mma::frag_a<CS>(lo, m0, kk * 16, lane));
  }
}

// acc (16 x 32: 4 n-tiles) += (hi + lo) (16 x 64) times columns n0.. of the chunk tile B stored [k][n]: a
// warp's share of a second product over one 64-row tile.
__device__ __forceinline__ void product(float (&acc)[4][4], const uint32_t (&a)[2][4][4], uint32_t B, int n0,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bf[4];
      sm90::ldmatrix_x4_trans(bf, flash_sm90::mma::frag_a<CS>(B, kk * 16, n0 + np * 16, lane));
      sm90::mma_bf16(acc[2 * np], a[0][kk], bf[0], bf[1]);
      sm90::mma_bf16(acc[2 * np], a[1][kk], bf[0], bf[1]);
      sm90::mma_bf16(acc[2 * np + 1], a[0][kk], bf[2], bf[3]);
      sm90::mma_bf16(acc[2 * np + 1], a[1][kk], bf[2], bf[3]);
    }
}

// A warp's accumulators (window chunk j: rows m0.., columns n0.. of the chunk), times mul, into rows
// [r0, r0 + 64) of one (b, h) slice of a contiguous (B, L, H, dd) bf16 output; rows past L are not written.
__device__ __forceinline__ void store(bf16* out, const float (&acc)[NWC][4][4], const Place& at, int r0, int m0,
                                      int n0, int L, int H, int dd, float mul, int lane) {
  const long long rs = static_cast<long long>(H) * dd;
  bf16* base = out + static_cast<long long>(at.b) * L * rs + static_cast<long long>(at.h) * dd +
               at.c_lo * CW + n0 + (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < NWC; ++j) {
    if (j >= at.nwin) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + m0 + (lane >> 2) + half * 8;
      if (row >= L) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        *reinterpret_cast<__nv_bfloat162*>(base + row * rs + j * CW + n * 8) =
            __floats2bfloat162_rn(acc[j][n][2 * half] * mul, acc[j][n][2 * half + 1] * mul);
    }
  }
}

}  // namespace mma

// ---------------------------------------------------------- fp32: FFMA, the bits of the first FFMA kernels

namespace f32 {

constexpr int CS = CW + 4;          // row stride of a chunk tile, floats
constexpr int TILE = BT * CS * 4;   // bytes of a chunk tile (and of the p / dS tile)

// s[i][j] (q row rg + 16 i, key cg + 16 j) continues its fmaf chain over the chunk's 64 columns, d ascending,
// of (q * scale) k, and dp[i][j] that of dO v; Q and G are the q and dO chunk tiles, K and V the key ones.
__device__ __forceinline__ void scores(float (&s)[4][4], float (&dp)[4][4], const float* Q, const float* G,
                                       const float* K, const float* V, int rg, int cg, float scale) {
#pragma unroll 2
  for (int d = 0; d < CW; d += 4) {
    float a[4][4], b[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(a[i]) = *reinterpret_cast<const float4*>(Q + (rg + 16 * i) * CS + d);
#pragma unroll
      for (int e = 0; e < 4; ++e) a[i][e] *= scale;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(b[j]) = *reinterpret_cast<const float4*>(K + (cg + 16 * j) * CS + d);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i][e], b[j][e], s[i][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(a[i]) = *reinterpret_cast<const float4*>(G + (rg + 16 * i) * CS + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(b[j]) = *reinterpret_cast<const float4*>(V + (cg + 16 * j) * CS + d);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i][e], b[j][e], dp[i][j]);
  }
}

// acc[i][e] (row pr * 4 + i, column pc * 4 + e of a window chunk) += the tile's partial: an fmaf chain over
// the tile's 64 c ascending from 0 of P[row][c] * B[c][col]. P: the dS, p^T or dS^T tile, B: a chunk tile.
__device__ __forceinline__ void product(float (&acc)[4][4], const float* P, const float* B, int pr, int pc) {
  float part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll 2
  for (int c = 0; c < BT; c += 4) {
    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(pv[i]) = *reinterpret_cast<const float4*>(P + (pr * 4 + i) * CS + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float bv[4];
      *reinterpret_cast<float4*>(bv) = *reinterpret_cast<const float4*>(B + (c + cc) * CS + pc * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][e] = fmaf(pv[i][cc], bv[e], part[i][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += part[i][e];
}

// The thread's accumulators (window chunk j: rows pr * 4 + i, columns pc * 4 + e), times mul, into rows
// [r0, r0 + 64) of one (b, h) slice of a contiguous (B, L, H, dd) fp32 output; rows past L are not written.
__device__ __forceinline__ void store(float* out, const float (&acc)[NWC][4][4], const Place& at, int r0, int pr,
                                      int pc, int L, int H, int dd, float mul) {
  const long long rs = static_cast<long long>(H) * dd;
  float* base = out + static_cast<long long>(at.b) * L * rs + static_cast<long long>(at.h) * dd + at.c_lo * CW +
                pc * 4;
#pragma unroll
  for (int j = 0; j < NWC; ++j) {
    if (j >= at.nwin) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + pr * 4 + i;
      if (row < L)
        *reinterpret_cast<float4*>(base + row * rs + j * CW) =
            make_float4(acc[j][i][0] * mul, acc[j][i][1] * mul, acc[j][i][2] * mul, acc[j][i][3] * mul);
    }
  }
}

}  // namespace f32

}  // namespace wide

}  // namespace flash_sm90
