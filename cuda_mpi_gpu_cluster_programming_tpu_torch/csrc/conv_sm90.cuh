// The Hopper conv mainloop of all six conv kernels: conv2d.cu (vcol: plain,
// k_block, hpool), conv_block.cu's conv step, conv_im2col.cu (a 1 x 1 conv
// over xcol), conv_taps.cu (a stride-1 conv over the space-to-depth input:
// plain, k_block, hpool), conv_g8.cu (the same over the g8 packing, its four
// output phases as columns: conv_phase_tiles) and conv_pairs.cu (its own
// operand, Pairs below).
//
// A conv is one implicit GEMM: rows are output pixels, columns output
// channels, and the reduction runs over kg = (fy*F + fx)*C + c from 0, the
// row-major order of the HWIO weights viewed as a (KG, K) matrix. The
// operand (Conv, or Pairs) says where term kg of a pixel and weight row kg
// live: its pixel origin (pixel()), its A gather (Loop::load_a) and its B
// rows (Loop::load_b) are overloads, so each operand compiles its own
// kernels and a Conv caller's code is what it was before Pairs existed. A block of
// 256 threads computes a BM x BN tile in BK = 32-term slices that a
// STAGES-deep ring of shared-memory buffers brings in ahead of the math:
//   * fp32 (T = float): FFMA (TF32 is out by the port's fp32 contract) in a
//     fixed two-level order: each block of FOLD stages' terms, kg in
//     [b*FOLD*BK, (b+1)*FOLD*BK), is one fmaf chain from 0 (a partial), and
//     the partials are added into the output's total in block order. The
//     blocks are fixed by the absolute term index, so any two tile shapes,
//     and any two callers whose terms agree, give the same bits; a padding
//     tap is a zero term of its block. One chain of all KG terms (2400 at
//     conv2) rounded 2.1x cuDNN's error on same-sign sums; 64-term partials
//     cut the longest chain to 64 + KG / 64 terms. The totals live in shared
//     memory after the pixel origins (ACC floats a thread, read and written
//     as float4), so the partials take no registers beyond the accumulators.
//     A thread owns TM pixels (TY apart) x 8 channels (two runs of 4, BN/2
//     apart) and reads them as 8- and 16-byte shared loads: 2 terms of a
//     pixel, 4 channels of a term.
//   * bf16 (T = bf16; int8w, whose int8 weights widen to bf16 exactly): the
//     tensor cores, mma.sync.m16n8k16 with fp32 accumulators and ldmatrix
//     (.trans for the row-major weights), the k16 steps in kg order from 0.
//     An element's sum depends only on its row of A, its column of B and the
//     steps taken, never on the tile or the warp that computed it, so every
//     caller running this loop gets the same bits: conv2d's modes among
//     themselves and conv_block.cu against the staged conv2d.
// The pixel operand is gathered channel-major: consecutive threads copy
// consecutive 16-byte runs of one pixel's channels with cp.async (src-size 0
// zero-fills a padding pixel or a term past KG), which needs C to be a
// multiple of the 16-byte vector and a 16-byte aligned base. A slice of 32
// terms at kg % 32 == 0 then never crosses a tap when C % 32 == 0 (conv2:
// C = 96), and a 16-byte run never does when C % VEC == 0. Otherwise (conv1:
// C = 3) each thread gathers a run of terms one by one with a (fy, fx, c)
// cursor (4-byte cp.async in fp32, plain loads in bf16). The weights come the
// same way: 16-byte cp.async rows of the (KG, K) matrix where K % VEC == 0
// (zeros past KG and K), else element by element; int8w's 16-byte rows are
// loaded into registers a stage ahead and widened into shared memory.
// Bound on the H100: operations (conv1 27 GFLOP, conv2 115 GFLOP at batch
// 128): FFMA at 67 TFLOP/s in fp32, the tensor cores at 989 in bf16.
#pragma once

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "sm90_ptx.cuh"

namespace {
namespace sm90 {

constexpr int THREADS = 256;
constexpr int BK = 32;  // reduction terms a stage holds
constexpr int FOLD = 2;  // fp32: stages a partial sum covers (64 terms)
constexpr int SMEM_LIMIT = 232448;  // the 227 KB a block may opt into

// ------------------------------------------------------------------ operands

// Which output pixel row q of a tile is: q < q_end; image n0 + q / per_img,
// conv row r0 + (q % per_img) / Wo, column (q % per_img) % Wo.
struct PixMap {
  int q_end, per_img, n0, r0, Wo;
};

// A pixel's gather origin: `off`, the offset in x of its window's top-left
// tap (n, iy0, ix0), channel 0 (negative at a padded corner; only taps inside
// the image are read), and (iy0, ix0) packed as two 16-bit halves for the
// bounds test (a pixel past q_end gets a row no tap reaches, so it reads
// zeros). 8 bytes a pixel: H, W and both pads stay below 2^14 (MAX_DIM).
struct Pix {
  int off, yx;
  __device__ __forceinline__ int iy0() const { return yx >> 16; }
  __device__ __forceinline__ int ix0() const { return static_cast<int16_t>(yx & 0xffff); }
};
static_assert(sizeof(Pix) == 8, "a tile keeps BM * 8 bytes of pixel origins");

constexpr int MAX_DIM = 1 << 14;

// The conv's operands: x (N, H, W, C) and w (F, F, C, K) = (KG, K) row-major,
// x zero-padded by pad_h rows and pad_w columns on each side (the row-sharded
// tier's convs are VALID on H, their halos holding the rows, and padded on W).
// vec_a / vec_b: the 16-byte copies apply (C resp. K a multiple of the vector,
// 16 for int8 weights, and the base 16-byte aligned).
template <typename T, typename WT>
struct Conv {
  using Elem = T;
  using WElem = WT;
  using Pixel = Pix;
  const T* x;
  const WT* w;
  int H, W, C, K, F, stride, pad_h, KG;
  int vec_a, vec_b;
  int pad_w;
};

// The pairs operand of conv_pairs.cu, packed by the wrapper from the
// space-to-depth input xs (N, Hs, Ws, cs) and weights ws (fq, fq, cs, K):
//   xp = xpair (N, Hs, Ws - 1, 2cs)  xs columns j and j + 1 side by side;
//   wp = wpair (fq, m, 2cs, K)       taps (qh, 2p) and (qh, 2p + 1) stacked;
//   xs, wl = wlast (fq, cs, K)       the leftover tap qw = fq - 1 (odd fq;
//                                    both null for even fq), m = fq / 2.
// Term kg of output pixel (n, oy, ox): row qh = kg / per_qh, then the m
// pairs left to right (2cs terms each: xpair pixel (oy + qh, ox + 2p)),
// then the leftover (cs terms: xs pixel (oy + qh, ox + fq - 1)). That is
// taps' (and xcol's) term (qh*fq + qw)*cs + c term for term: pair p's first
// cs terms are tap 2p's channels, its next cs tap 2p + 1's. Every window is
// in bounds (the packing pads), so no term is tested against an image edge.
struct PairPix {
  int p, s;  // offsets of (n, oy, ox) in xpair and of (n, oy, ox + fq - 1) in xs; p = -1: past q_end
};
static_assert(sizeof(PairPix) == 8, "a tile keeps BM * 8 bytes of pixel origins");

template <typename T>
struct Pairs {
  using Elem = T;
  using WElem = T;
  using Pixel = PairPix;
  const T* xp;
  const T* xs;
  const T* wp;
  const T* wl;
  int Hs, Ws, cs, fq, K, KG;
  int m, nseg, pair_terms, per_qh;  // pairs a row, segments a row (m + the leftover), m * 2cs, terms a row
  int vec_a, vec_b;

  // Weight row kg: wpair's row (qh, j) for the pairs' terms, wlast's (qh, j - pair_terms) after them.
  __device__ __forceinline__ const T* row(int kg) const {
    const int qh = kg / per_qh;
    const int j = kg - qh * per_qh;
    if (j < pair_terms) return wp + (static_cast<size_t>(qh) * pair_terms + j) * K;
    return wl + (static_cast<size_t>(qh) * cs + (j - pair_terms)) * K;
  }
};

template <typename T, typename WT>
__device__ __forceinline__ Pix pixel(const Conv<T, WT>& g, const PixMap& pm, int q) {
  if (q >= pm.q_end) return Pix{0, static_cast<int>(0xC0000000u)};  // iy0 = -2^14
  const int n = pm.n0 + q / pm.per_img;
  const int r = q % pm.per_img;
  const int iy0 = (pm.r0 + r / pm.Wo) * g.stride - g.pad_h;
  const int ix0 = (r % pm.Wo) * g.stride - g.pad_w;
  return Pix{n * g.H * g.W * g.C + (iy0 * g.W + ix0) * g.C,
             static_cast<int>((static_cast<unsigned>(iy0) << 16) | (static_cast<unsigned>(ix0) & 0xffffu))};
}

template <typename T>
__device__ __forceinline__ PairPix pixel(const Pairs<T>& g, const PixMap& pm, int q) {
  if (q >= pm.q_end) return PairPix{-1, 0};
  const int n = pm.n0 + q / pm.per_img;
  const int r = q % pm.per_img;
  const int row = n * g.Hs + pm.r0 + r / pm.Wo;  // s2d row (n, oy)
  const int ox = r % pm.Wo;
  return PairPix{(row * (g.Ws - 1) + ox) * 2 * g.cs, (row * g.Ws + ox + g.fq - 1) * g.cs};
}

template <typename T, typename WT>
__device__ __forceinline__ bool inside(const Conv<T, WT>& g, int iy, int ix) {
  return static_cast<unsigned>(iy) < static_cast<unsigned>(g.H) && static_cast<unsigned>(ix) < static_cast<unsigned>(g.W);
}

// ------------------------------------------------------------------ tile configs

// BM x BN tile of element type T (the shared-memory and math type S is T:
// float on FFMA, bf16 on the tensor cores). Every caller steps BK terms a
// stage: in bf16 the zero k-steps that pad KG to a multiple of BK are part of
// the tensor-core sequence the callers share.
template <typename T, int BM_, int BN_>
struct Cfg {
  using S = T;
  static constexpr bool MMA = std::is_same<T, port::bf16>::value;
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int VEC = 16 / static_cast<int>(sizeof(S));  // elements in 16 bytes
  static constexpr int SA = MMA ? BK + 8 : BK + 4;                // A row stride (pixel rows)
  static constexpr int SB = MMA ? BN + 8 : BN;                    // B row stride (term rows)
  static constexpr int STAGES = MMA ? 4 : 3;
  // blocks an SM keeps (conv_tiles' launch bound): two bf16 blocks hide the
  // gather's latency; one fp32 block keeps its 8 x 8 FFMA tile out of spills
  static constexpr int MIN_BLOCKS = MMA ? 2 : 1;
  static constexpr int A_ELEMS = BM * SA, B_ELEMS = BK * SB;
  static constexpr int STAGE_BYTES = (A_ELEMS + B_ELEMS) * static_cast<int>(sizeof(S));
  // A, vector path: CPR 16-byte runs per pixel row, AV pixels a thread
  static constexpr int CPR = BK / VEC;
  static constexpr int AV = BM * CPR / THREADS;
  // A, scalar path: one pixel a thread, a run of AR terms
  static constexpr int AR = BM * BK / THREADS;
  // B: BV 16-byte runs, or BS elements, a thread
  static constexpr int BV = BK * BN / VEC / THREADS;
  static constexpr int BS = BK * BN / THREADS;
  // FFMA: TX x TY threads, a thread TM pixels x 8 channels
  static constexpr int TX = BN / 8, TY = THREADS / TX, TM = BM / TY;
  // MMA: WARPS_M x WARPS_N warps, a warp WM x 32: MT m16 tiles x 4 n8 tiles
  static constexpr int WARPS_N = BN / 32, WARPS_M = 8 / WARPS_N, WM = BM / WARPS_M, MT = WM / 16;
  static constexpr int ACC = MMA ? MT * 4 * 4 : TM * 8;  // accumulators a thread
  // fp32: the running totals of the partials, ACC floats a thread, [e / 4][thread] as float4
  static constexpr int TOT_BYTES = MMA ? 0 : ACC * THREADS * 4;
  // the stages, then the tile's pixel origins (Pix per pixel row), then the fp32 totals
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + BM * 8 + TOT_BYTES;
  static_assert(AV >= 1 && AR >= 1 && BV >= 1 && BM * CPR % THREADS == 0 && THREADS % BM == 0, "loaders");
  static_assert(MMA ? (WARPS_M * WARPS_N == 8 && WM % 16 == 0) : (TM * TY == BM && TX * 8 == BN), "tiles");
  static_assert(STAGE_BYTES % 16 == 0, "every stage starts 16-byte aligned");
  static_assert(MMA || ACC % 4 == 0, "fp32 totals go in float4 rows");

  // Tile coordinates (pixel row m, channel column n) of accumulator e.
  __device__ __forceinline__ static void coord(int e, int& m, int& n) {
    const int tid = threadIdx.x;
    if constexpr (MMA) {
      const int lane = tid & 31, warp = tid >> 5;
      const int mt = e / 16, nt = (e / 4) % 4, r = e % 4;
      m = (warp / WARPS_N) * WM + mt * 16 + (lane >> 2) + (r >= 2 ? 8 : 0);
      n = (warp % WARPS_N) * 32 + nt * 8 + (lane & 3) * 2 + (r & 1);
    } else {
      const int i = e / 8, j = e % 8;
      m = tid / TX + TY * i;
      n = (j < 4 ? 0 : BN / 2) + (tid % TX) * 4 + (j & 3);
    }
  }
};

// ------------------------------------------------------------------ the mainloop

// How a mainloop gathers the pixel operand: as g.vec_a says at run time, or
// fixed at compile time (conv_tiles instantiates both, so each kernel carries
// one gather and the registers of that one only).
enum AMode { A_ANY, A_VEC, A_SCALAR };

template <class C, typename T, typename WT>
struct Loop {
  using S = typename C::S;
  // int8 weights with 16-byte rows: one 16-byte global load a thread per
  // stage, fetched into registers a stage ahead and widened into shared
  // memory after the math (cp.async cannot widen)
  static constexpr bool B8 = std::is_same<WT, int8_t>::value;
  static constexpr int B8_RUNS = BK * C::BN / 16;  // 16-weight runs a stage
  static_assert(!B8 || B8_RUNS <= THREADS, "one int8 run a thread at most");

  static constexpr int E = static_cast<int>(sizeof(S));  // bytes an element

  // The A slice of one stage (shared address As): BM pixels x BK terms from k0.
  template <int AM>
  __device__ __forceinline__ static void load_a(const Conv<T, WT>& g, const Pix* pix, uint32_t As, int k0) {
    const int tid = threadIdx.x;
    if (AM == A_VEC || (AM == A_ANY && g.vec_a)) {
      const int kc = tid % C::CPR;
      const int kg = k0 + kc * C::VEC;
      const int fy = kg / (g.F * g.C);
      const int rem = kg - fy * g.F * g.C;
      const int fx = rem / g.C;
      const int c = rem - fx * g.C;
      const bool kin = kg < g.KG;
      const int tap = (fy * g.W + fx) * g.C + c;  // from a window's top-left tap
#pragma unroll
      for (int e = 0; e < C::AV; ++e) {
        const int m = tid / C::CPR + (THREADS / C::CPR) * e;
        const Pix pa = pix[m];
        const bool ok = kin && inside(g, pa.iy0() + fy, pa.ix0() + fx);
        const T* src = ok ? g.x + (pa.off + tap) : g.x;
        cp_async16(As + E * (m * C::SA + kc * C::VEC), src, ok);
      }
      return;
    }
    // term by term with a (fy, fx, c) cursor: 4-byte cp.async in fp32, loads in bf16
    const int m = tid % C::BM;
    const int kr = (tid / C::BM) * C::AR;
    int kg = k0 + kr;
    int fy = kg / (g.F * g.C);
    const int rem = kg - fy * g.F * g.C;
    int fx = rem / g.C;
    int c = rem - fx * g.C;
    const Pix pa = pix[m];
    const uint32_t row = As + E * (m * C::SA + kr);
#pragma unroll 4
    for (int j = 0; j < C::AR; ++j, ++kg) {
      const bool ok = kg < g.KG && inside(g, pa.iy0() + fy, pa.ix0() + fx);
      const T* src = ok ? g.x + (pa.off + (fy * g.W + fx) * g.C + c) : g.x;
      if constexpr (C::MMA) {
        st_shared(row + E * j, ok ? *src : port::from_f32<S>(0.f));
      } else {
        cp_async4(row + E * j, src, ok);
      }
      if (++c == g.C) {
        c = 0;
        if (++fx == g.F) {
          fx = 0;
          ++fy;
        }
      }
    }
  }

  // The B slice of one stage (shared address Bs): BK terms from k0 x BN
  // channels from n0 (zeros past KG and K), where it does not go through registers.
  __device__ __forceinline__ static void load_b(const Conv<T, WT>& g, uint32_t Bs, int k0, int n0) {
    const int tid = threadIdx.x;
    if constexpr (std::is_same<WT, S>::value) {
      if (g.vec_b) {
        constexpr int RUNS = C::BN / C::VEC;  // 16-byte runs per term row
#pragma unroll
        for (int e = 0; e < C::BV; ++e) {
          const int i = tid + THREADS * e;
          const int row = i / RUNS, col = (i % RUNS) * C::VEC;
          const int kg = k0 + row, n = n0 + col;
          const bool ok = kg < g.KG && n < g.K;
          cp_async16(Bs + E * (row * C::SB + col), ok ? g.w + static_cast<size_t>(kg) * g.K + n : g.w, ok);
        }
        return;
      }
    }
#pragma unroll
    for (int e = 0; e < C::BS; ++e) {
      const int i = tid + THREADS * e;
      const int row = i / C::BN, col = i % C::BN;
      const int kg = k0 + row, n = n0 + col;
      S v = port::from_f32<S>(0.f);
      if (kg < g.KG && n < g.K) v = port::from_f32<S>(port::to_f32(g.w[static_cast<size_t>(kg) * g.K + n]));
      st_shared(Bs + E * (row * C::SB + col), v);
    }
  }

  // The pairs operand's A slice: a 16-byte run never crosses a segment (2cs
  // and cs are multiples of the vector where vec_a holds), so each run finds
  // its (qh, segment, channel) once a stage; else term by term with a
  // (qh, segment, channel) cursor.
  template <int AM>
  __device__ __forceinline__ static void load_a(const Pairs<T>& g, const PairPix* pix, uint32_t As, int k0) {
    const int tid = threadIdx.x;
    if (AM == A_VEC || (AM == A_ANY && g.vec_a)) {
      const int kc = tid % C::CPR;
      const int kg = k0 + kc * C::VEC;
      const int qh = kg / g.per_qh;
      const int j = kg - qh * g.per_qh;
      const bool kin = kg < g.KG;
      const bool left = j >= g.pair_terms;  // the leftover tap's run
      // the run's offset from the pixel's origin in xs (leftover) or xpair (pair j / 2cs: column + 2p, so
      // 4cs a pair, and the run's channel j % 2cs)
      const int tap = left ? qh * g.Ws * g.cs + (j - g.pair_terms)
                           : qh * (g.Ws - 1) * 2 * g.cs + j + (j / (2 * g.cs)) * 2 * g.cs;
#pragma unroll
      for (int e = 0; e < C::AV; ++e) {
        const int m = tid / C::CPR + (THREADS / C::CPR) * e;
        const PairPix pa = pix[m];
        const bool ok = kin && pa.p >= 0;
        const T* src = !ok ? g.xp : left ? g.xs + (pa.s + tap) : g.xp + (pa.p + tap);
        cp_async16(As + E * (m * C::SA + kc * C::VEC), src, ok);
      }
      return;
    }
    const int m = tid % C::BM;
    const int kr = (tid / C::BM) * C::AR;
    int kg = k0 + kr;
    int qh = kg / g.per_qh;
    int j = kg - qh * g.per_qh;
    int seg = j < g.pair_terms ? j / (2 * g.cs) : g.m;
    int c = j - seg * 2 * g.cs;
    const PairPix pa = pix[m];
    const uint32_t row = As + E * (m * C::SA + kr);
#pragma unroll 4
    for (int t = 0; t < C::AR; ++t, ++kg) {
      const bool pair = seg < g.m;
      const bool ok = kg < g.KG && pa.p >= 0;
      const T* src = !ok    ? g.xp
                     : pair ? g.xp + (pa.p + qh * (g.Ws - 1) * 2 * g.cs + seg * 4 * g.cs + c)
                            : g.xs + (pa.s + qh * g.Ws * g.cs + c);
      if constexpr (C::MMA) {
        st_shared(row + E * t, ok ? *src : port::from_f32<S>(0.f));
      } else {
        cp_async4(row + E * t, src, ok);
      }
      if (++c == (pair ? 2 * g.cs : g.cs)) {
        c = 0;
        if (++seg == g.nseg) {
          seg = 0;
          ++qh;
        }
      }
    }
  }

  // The pairs operand's B slice: the rows of wpair and wlast in kg order (zeros past KG and K).
  __device__ __forceinline__ static void load_b(const Pairs<T>& g, uint32_t Bs, int k0, int n0) {
    const int tid = threadIdx.x;
    if (g.vec_b) {
      constexpr int RUNS = C::BN / C::VEC;
#pragma unroll
      for (int e = 0; e < C::BV; ++e) {
        const int i = tid + THREADS * e;
        const int row = i / RUNS, col = (i % RUNS) * C::VEC;
        const int kg = k0 + row, n = n0 + col;
        const bool ok = kg < g.KG && n < g.K;
        cp_async16(Bs + E * (row * C::SB + col), ok ? g.row(kg) + n : g.wp, ok);
      }
      return;
    }
#pragma unroll
    for (int e = 0; e < C::BS; ++e) {
      const int i = tid + THREADS * e;
      const int row = i / C::BN, col = i % C::BN;
      const int kg = k0 + row, n = n0 + col;
      S v = port::from_f32<S>(0.f);
      if (kg < g.KG && n < g.K) v = g.row(kg)[n];
      st_shared(Bs + E * (row * C::SB + col), v);
    }
  }

  // int8 weights, 16-byte rows: this thread's run of the stage at k0 (zeros past KG and K) ...
  __device__ __forceinline__ static int4 fetch_b8(const Conv<T, WT>& g, int k0, int n0) {
    const int i = threadIdx.x;
    const int row = i / (C::BN / 16), col = (i % (C::BN / 16)) * 16;
    const int kg = k0 + row, n = n0 + col;
    if (i >= B8_RUNS || kg >= g.KG || n >= g.K) return make_int4(0, 0, 0, 0);
    return __ldg(reinterpret_cast<const int4*>(g.w + static_cast<size_t>(kg) * g.K + n));
  }

  // ... and its 16 weights widened (exactly) to bf16 into the stage's B slice: two 16-byte stores.
  __device__ __forceinline__ static void put_b8(int4 raw, uint32_t Bs) {
    const int i = threadIdx.x;
    if (i >= B8_RUNS) return;
    const int row = i / (C::BN / 16), col = (i % (C::BN / 16)) * 16;
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    uint32_t h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(static_cast<float>(b[2 * j]), static_cast<float>(b[2 * j + 1]));
      h[j] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    const uint32_t dst = Bs + E * (row * C::SB + col);
    st_shared_v4(dst, h[0], h[1], h[2], h[3]);
    st_shared_v4(dst + 16, h[4], h[5], h[6], h[7]);
  }

  // acc += the stage at shared address `buf_s` (generic pointer `buf`), term by term in order.
  __device__ __forceinline__ static void compute(uint32_t buf_s, const S* buf, float (&acc)[C::ACC]) {
    const int tid = threadIdx.x;
    if constexpr (C::MMA) {
      const int lane = tid & 31, warp = tid >> 5;
      const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
      // this lane's row addresses; the tile, k-step and matrix offsets are immediates
      const uint32_t a_row = buf_s + E * ((wm * C::WM + (lane & 15)) * C::SA + (lane >> 4) * 8);
      const uint32_t b_row = buf_s + E * (C::A_ELEMS + (lane & 15) * C::SB + wn * 32 + (lane >> 4) * 8);
#pragma unroll 1
      for (int ks = 0; ks < BK / 16; ++ks) {
        // two n8 tiles of B at a time, each against the m16 tiles of A in turn:
        // 8 fragment registers live (A is read twice a k-step)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, b_row + E * (ks * 16 * C::SB + np * 16));
#pragma unroll
          for (int mt = 0; mt < C::MT; ++mt) {
            uint32_t af[4];
            ldmatrix_x4(af, a_row + E * (mt * 16 * C::SA + ks * 16));
            mma_bf16(acc + (mt * 4 + 2 * np) * 4, af, bf[0], bf[1]);
            mma_bf16(acc + (mt * 4 + 2 * np + 1) * 4, af, bf[2], bf[3]);
          }
        }
      }
    } else {
      const S* As = buf;
      const S* Bs = buf + C::A_ELEMS;
      const int tx = tid % C::TX, ty = tid / C::TX;
#pragma unroll
      for (int k2 = 0; k2 < BK; k2 += 2) {
        float2 a[C::TM];
#pragma unroll
        for (int i = 0; i < C::TM; ++i)
          a[i] = *reinterpret_cast<const float2*>(As + (ty + C::TY * i) * C::SA + k2);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float4 b0 = *reinterpret_cast<const float4*>(Bs + (k2 + q) * C::SB + tx * 4);
          const float4 b1 = *reinterpret_cast<const float4*>(Bs + (k2 + q) * C::SB + C::BN / 2 + tx * 4);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < C::TM; ++i) {
            const float av = q == 0 ? a[i].x : a[i].y;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(av, bv[j], acc[i * 8 + j]);
          }
        }
      }
    }
  }
};

// acc = the tile of pixel rows [q0, q0 + BM) of `pm` times weight columns
// [n0, n0 + BN), over all KG terms in order (fp32: a partial a block of FOLD
// stages, added into the totals in block order). `stages` is the block's C::SMEM_BYTES of
// shared memory; it is free again when this returns.
template <class C, int AM = A_ANY, class G>
__device__ __forceinline__ void mainloop(const G& g, const PixMap& pm, int q0, int n0, unsigned char* stages,
                                         float (&acc)[C::ACC]) {
  using L = Loop<C, typename G::Elem, typename G::WElem>;
  using S = typename C::S;
  using P = typename G::Pixel;
  constexpr int STAGE = C::A_ELEMS + C::B_ELEMS;  // elements
  const uint32_t ring = smem_addr(stages);
#pragma unroll
  for (int e = 0; e < C::ACC; ++e) acc[e] = 0.f;
  // the tile's pixel origins, once, into shared memory after the stages: read
  // there at every stage rather than held in registers
  P* pa = reinterpret_cast<P*>(stages + C::STAGES * C::STAGE_BYTES);
  for (int m = threadIdx.x; m < C::BM; m += THREADS) pa[m] = pixel(g, pm, q0 + m);
  // fp32: this thread's totals, float4 e/4 of thread t at [e/4][t] (16-byte rows: no bank conflicts)
  float4* tot = reinterpret_cast<float4*>(stages + C::STAGES * C::STAGE_BYTES + C::BM * 8) + threadIdx.x;
  __syncthreads();
  const bool b8 = L::B8 && g.vec_b;  // int8 weights through registers, a stage ahead
  const int KT = (g.KG + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < KT) {
      const uint32_t buf = ring + s * C::STAGE_BYTES;
      L::template load_a<AM>(g, pa, buf, s * BK);
      if (b8) {
        if constexpr (L::B8) L::put_b8(L::fetch_b8(g, s * BK, n0), buf + L::E * C::A_ELEMS);
      } else {
        L::load_b(g, buf + L::E * C::A_ELEMS, s * BK, n0);
      }
    }
    cp_async_commit();
  }
  int4 next_b8 = make_int4(0, 0, 0, 0);
  if constexpr (L::B8) {  // int8 weights come only with a Conv
    if (b8 && C::STAGES - 1 < KT) next_b8 = L::fetch_b8(g, (C::STAGES - 1) * BK, n0);
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // stage kt has landed; every thread is done with stage kt - 1's buffer
    const int nk = kt + C::STAGES - 1;
    if (nk < KT) {
      const uint32_t buf = ring + (nk % C::STAGES) * C::STAGE_BYTES;
      L::template load_a<AM>(g, pa, buf, nk * BK);
      if (b8) {
        L::put_b8(next_b8, buf + L::E * C::A_ELEMS);
      } else {
        L::load_b(g, buf + L::E * C::A_ELEMS, nk * BK, n0);
      }
    }
    cp_async_commit();
    if constexpr (L::B8) {
      if (b8 && nk + 1 < KT) next_b8 = L::fetch_b8(g, (nk + 1) * BK, n0);
    }
    const int cur = kt % C::STAGES;
    if constexpr (C::MMA) {
      L::compute(ring + cur * C::STAGE_BYTES, reinterpret_cast<const S*>(stages) + cur * STAGE, acc);
    } else {
      // a block's partial: one chain from 0 over its FOLD stages, then into the totals (the first stored)
      if (kt % FOLD == 0) {
#pragma unroll
        for (int e = 0; e < C::ACC; ++e) acc[e] = 0.f;
      }
      L::compute(ring + cur * C::STAGE_BYTES, reinterpret_cast<const S*>(stages) + cur * STAGE, acc);
      if (kt % FOLD == FOLD - 1 || kt == KT - 1) {
#pragma unroll
        for (int e = 0; e < C::ACC; e += 4) {
          float4 t = make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
          if (kt >= FOLD) {
            const float4 o = tot[(e / 4) * THREADS];
            t = make_float4(__fadd_rn(o.x, t.x), __fadd_rn(o.y, t.y), __fadd_rn(o.z, t.z), __fadd_rn(o.w, t.w));
          }
          tot[(e / 4) * THREADS] = t;
        }
      }
    }
  }
  if constexpr (!C::MMA) {
#pragma unroll
    for (int e = 0; e < C::ACC; e += 4) {
      const float4 t = tot[(e / 4) * THREADS];
      acc[e] = t.x, acc[e + 1] = t.y, acc[e + 2] = t.z, acc[e + 3] = t.w;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The epilogue of every caller: fp32 bias, ReLU (jnp.maximum(v, 0): -0.0 to
// +0.0, a NaN stays NaN), one cast.
template <typename T, typename B>
__device__ __forceinline__ T epilogue(float acc, const B* bias, int n, int relu) {
  float v = acc + port::to_f32(bias[n]);
  if (relu && v <= 0.f) v = 0.f;
  return port::from_f32<T>(v);
}

// ------------------------------------------------------------------ conv2d kernels

// (N, Ho, Wo, K) output; grid (pixel tiles, channel tiles). G: Conv<T, T> or Pairs<T>.
template <class C, int AM, class G>
__global__ void __launch_bounds__(THREADS, C::MIN_BLOCKS)
conv_tiles(G g, const typename G::Elem* __restrict__ bias, typename G::Elem* __restrict__ y, int M, int Ho, int Wo,
           int relu) {
  using T = typename G::Elem;
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  float acc[C::ACC];
  mainloop<C, AM>(g, PixMap{M, Ho * Wo, 0, 0, Wo}, q0, n0, smem, acc);
  // A thread's accumulators come in runs of RUN neighbouring channels (bf16:
  // pairs, fp32: fours): one 4- or 16-byte store each where K allows it.
  constexpr int RUN = C::MMA ? 2 : 4;
  const bool whole = g.K % RUN == 0;
#pragma unroll
  for (int e = 0; e < C::ACC; e += RUN) {
    int m, n;
    C::coord(e, m, n);
    const int q = q0 + m, ch = n0 + n;
    if (q >= M) continue;
    T* dst = y + static_cast<size_t>(q) * g.K + ch;
    if (whole && ch + RUN <= g.K) {
      if constexpr (C::MMA) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __halves2bfloat162(epilogue<T>(acc[e], bias, ch, relu), epilogue<T>(acc[e + 1], bias, ch + 1, relu));
      } else {
        *reinterpret_cast<float4*>(dst) =
            make_float4(epilogue<T>(acc[e], bias, ch, relu), epilogue<T>(acc[e + 1], bias, ch + 1, relu),
                        epilogue<T>(acc[e + 2], bias, ch + 2, relu), epilogue<T>(acc[e + 3], bias, ch + 3, relu));
      }
    } else {
#pragma unroll
      for (int j = 0; j < RUN; ++j)
        if (ch + j < g.K) dst[j] = epilogue<T>(acc[e + j], bias, ch + j, relu);
    }
  }
}

// (N, Ho, Wo, K) output of a conv whose g.K = 4K columns are the four output
// phases (conv_g8.cu): column j = (2ph + pw)K + ch of phase pixel (n, a, b),
// one of N x Ho2 x Wo2, is output pixel (n, 2a + ph, 2b + pw), channel ch; a
// phase pixel past Ho or Wo (odd Ho or Wo) is not written. The mainloop is
// conv_tiles', so an element's sum is what a grid with a dimension for each
// phase would give. grid (pixel tiles, column tiles).
template <class C, int AM, typename T>
__global__ void __launch_bounds__(THREADS, C::MIN_BLOCKS)
conv_phase_tiles(Conv<T, T> g, const T* __restrict__ bias, T* __restrict__ y, int M, int Ho2, int Wo2, int K,
                 int Ho, int Wo, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  float acc[C::ACC];
  mainloop<C, AM>(g, PixMap{M, Ho2 * Wo2, 0, 0, Wo2}, q0, n0, smem, acc);
  // column col of phase pixel q: its place in y (null past Ho or Wo) and its channel
  auto place = [&](int q, int col, int& ch) -> T* {
    const int ph = col / K;
    ch = col - ph * K;
    const int img = q / (Ho2 * Wo2), r = q - img * (Ho2 * Wo2);
    const int oy = 2 * (r / Wo2) + (ph >> 1), ox = 2 * (r % Wo2) + (ph & 1);
    return oy < Ho && ox < Wo ? y + ((static_cast<size_t>(img) * Ho + oy) * Wo + ox) * K + ch : nullptr;
  };
  // Runs of RUN neighbouring columns as in conv_tiles: one vector store where
  // K is a multiple of the run (a run then never straddles two phases), else
  // one store a column.
  constexpr int RUN = C::MMA ? 2 : 4;
  const bool whole = K % RUN == 0;
#pragma unroll
  for (int e = 0; e < C::ACC; e += RUN) {
    int m, n;
    C::coord(e, m, n);
    const int q = q0 + m, col = n0 + n;
    if (q >= M) continue;
    if (whole) {
      int ch = 0;
      T* dst = col < g.K ? place(q, col, ch) : nullptr;
      if (dst == nullptr) continue;
      if constexpr (C::MMA) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __halves2bfloat162(epilogue<T>(acc[e], bias, ch, relu), epilogue<T>(acc[e + 1], bias, ch + 1, relu));
      } else {
        *reinterpret_cast<float4*>(dst) =
            make_float4(epilogue<T>(acc[e], bias, ch, relu), epilogue<T>(acc[e + 1], bias, ch + 1, relu),
                        epilogue<T>(acc[e + 2], bias, ch + 2, relu), epilogue<T>(acc[e + 3], bias, ch + 3, relu));
      }
    } else {
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        int ch = 0;
        T* dst = col + j < g.K ? place(q, col + j, ch) : nullptr;
        if (dst != nullptr) *dst = epilogue<T>(acc[e + j], bias, ch, relu);
      }
    }
  }
}

// (N, Hp, Wo, K) output: conv, then the H-axis max of a pw / ps pool. A block
// owns a band of pooled rows of one image and BN channels, computes the conv
// rows the band's windows need into shared memory after the stages (cast:
// exactly the values conv_tiles writes), then takes the H max in the pool's
// tap order (common.cuh's max_step). grid (channel tiles, bands, images).
template <class C, typename T>
__global__ void __launch_bounds__(THREADS, 1)
conv_hpool(Conv<T, T> g, const T* __restrict__ bias, T* __restrict__ y, int Wo, int pw, int ps, int Hp, int band,
           int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* rows = reinterpret_cast<T*>(smem + C::SMEM_BYTES);  // [conv rows][Wo][BN]
  const int tid = threadIdx.x;
  const int n = blockIdx.z, n0 = blockIdx.x * C::BN;
  const int py0 = blockIdx.y * band, py1 = min(Hp, py0 + band);
  const int npix = ((py1 - 1 - py0) * ps + pw) * Wo;
  const PixMap pm{npix, npix, n, py0 * ps, Wo};
  for (int p0 = 0; p0 < npix; p0 += C::BM) {
    float acc[C::ACC];
    mainloop<C>(g, pm, p0, n0, smem, acc);
#pragma unroll
    for (int e = 0; e < C::ACC; ++e) {
      int m, nn;
      C::coord(e, m, nn);
      const int pl = p0 + m, ch = n0 + nn;
      if (pl < npix && ch < g.K) rows[static_cast<size_t>(pl) * C::BN + nn] = epilogue<T>(acc[e], bias, ch, relu);
    }
  }
  __syncthreads();
  for (int i = tid; i < (py1 - py0) * Wo * C::BN; i += THREADS) {
    const int cl = i % C::BN;
    const int rest = i / C::BN;
    const int ox = rest % Wo, dpy = rest / Wo;
    const int ch = n0 + cl;
    if (ch >= g.K) continue;
    const T* col = rows + static_cast<size_t>(dpy * ps * Wo + ox) * C::BN + cl;
    T best = col[0];
    float bf = port::to_f32(best);
    for (int fy = 0; fy < pw; ++fy) port::max_step(best, bf, col[static_cast<size_t>(fy) * Wo * C::BN]);
    y[((static_cast<size_t>(n) * Hp + py0 + dpy) * Wo + ox) * g.K + ch] = best;
  }
}

// Pooled rows per hpool block, at most (fewer where the band's conv rows and
// the stages would pass the 227 KB a block may have).
constexpr int HPOOL_BAND = 4;

template <typename T>
Conv<T, T> make_conv(const void* x, const void* w, int H, int W, int C, int K, int F, int stride, int pad_h,
                     int pad_w) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  return Conv<T, T>{static_cast<const T*>(x), static_cast<const T*>(w), H, W, C, K, F, stride, pad_h, F * F * C,
                    C % VEC == 0 && port::aligned16(x), K % VEC == 0 && port::aligned16(w), pad_w};
}

// The gather packs window origins into 16 bits (Pix): larger images are refused.
template <typename T, typename WT>
bool fits(const Conv<T, WT>& g) {
  return g.H < MAX_DIM && g.W < MAX_DIM && g.pad_h < MAX_DIM && g.pad_w < MAX_DIM;
}

// Pairs' origins are plain offsets (the wrapper keeps its operands below 2^31 elements).
template <typename T>
bool fits(const Pairs<T>&) {
  return true;
}

template <typename T>
Pairs<T> make_pairs(const void* xp, const void* xs, const void* wp, const void* wl, int Hs, int Ws, int cs, int fq,
                    int K) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const int m = fq / 2, odd = xs != nullptr;
  const int per_qh = m * 2 * cs + (odd ? cs : 0);
  return Pairs<T>{static_cast<const T*>(xp), static_cast<const T*>(xs), static_cast<const T*>(wp),
                  static_cast<const T*>(wl), Hs, Ws, cs, fq, K, fq * per_qh, m, m + odd, m * 2 * cs, per_qh,
                  cs % VEC == 0 && port::aligned16(xp) && (!odd || port::aligned16(xs)),
                  K % VEC == 0 && port::aligned16(wp) && (!odd || port::aligned16(wl))};
}

// conv_tiles of tile config C over the operand g on the stream. Returns the launch's CUDA error.
template <class C, class G>
int launch_tiles_cfg(const G& g, const void* b, void* y, int N, int Ho, int Wo, int relu, cudaStream_t stream) {
  using T = typename G::Elem;
  if (!fits(g)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = g.vec_a ? conv_tiles<C, A_VEC, G> : conv_tiles<C, A_SCALAR, G>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = N * Ho * Wo;
  dim3 grid(port::blocks_for(M, C::BM), port::blocks_for(g.K, C::BN));
  kernel<<<grid, THREADS, C::SMEM_BYTES, stream>>>(g, static_cast<const T*>(b), static_cast<T*>(y), M, Ho, Wo,
                                                   relu);
  return static_cast<int>(cudaGetLastError());
}

// conv_tiles on the stream: k_block in {0, 64, 128} (K % k_block == 0 when
// not 0) sets the channels a block owns: 64 runs the 128 x 64 tile, 0 and
// 128 the 128 x 128 one. Returns the launch's CUDA error.
template <typename T>
int launch_tiles(const Conv<T, T>& g, const void* b, void* y, int N, int Ho, int Wo, int relu, int k_block,
                 void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (k_block == 64) return launch_tiles_cfg<Cfg<T, 128, 64>>(g, b, y, N, Ho, Wo, relu, st);
  return launch_tiles_cfg<Cfg<T, 128, 128>>(g, b, y, N, Ho, Wo, relu, st);
}

// conv_hpool on the stream (pool window pw, stride ps, Hp pooled rows), on
// the 128 x 64 tile. Returns the CUDA error of its set-up or launch.
template <typename T>
int launch_hpool(const Conv<T, T>& g, const void* b, void* y, int N, int Wo, int relu, int pw, int ps, int Hp,
                 void* stream) {
  using C = Cfg<T, 128, 64>;
  if (!fits(g)) return static_cast<int>(cudaErrorInvalidValue);
  auto bytes = [&](int bd) {
    return C::SMEM_BYTES + static_cast<size_t>((bd - 1) * ps + pw) * Wo * C::BN * sizeof(T);
  };
  int band = std::min(HPOOL_BAND, Hp);
  while (band > 1 && bytes(band) > static_cast<size_t>(SMEM_LIMIT)) --band;
  auto kernel = conv_hpool<C, T>;
  // A band past what the card allows is refused here, with this error code.
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes(band)));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(port::blocks_for(g.K, C::BN), port::blocks_for(Hp, band), N);
  kernel<<<grid, THREADS, bytes(band), static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const T*>(b), static_cast<T*>(y), Wo, pw, ps, Hp, band, relu);
  return static_cast<int>(cudaGetLastError());
}

// conv_phase_tiles on the stream, on the 128 x 128 tile: g's 4K columns are
// the phases of the (N, Ho, Wo, K) output, its pixels the N x ceil(Ho/2) x
// ceil(Wo/2) phase pixels. Returns the launch's CUDA error.
template <typename T>
int launch_phases(const Conv<T, T>& g, const void* b, void* y, int N, int Ho, int Wo, int K, int relu,
                  void* stream) {
  using C = Cfg<T, 128, 128>;
  if (!fits(g) || g.K != 4 * K) return static_cast<int>(cudaErrorInvalidValue);
  const int Ho2 = (Ho + 1) / 2, Wo2 = (Wo + 1) / 2;
  auto kernel = g.vec_a ? conv_phase_tiles<C, A_VEC, T> : conv_phase_tiles<C, A_SCALAR, T>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = N * Ho2 * Wo2;
  dim3 grid(port::blocks_for(M, C::BM), port::blocks_for(g.K, C::BN));
  kernel<<<grid, THREADS, C::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const T*>(b), static_cast<T*>(y), M, Ho2, Wo2, K, Ho, Wo, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace
