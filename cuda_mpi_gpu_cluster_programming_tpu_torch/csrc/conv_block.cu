// One fused block on NHWC/HWIO tensors: conv (+ int8w rescale) + bias + ReLU
// + VALID max-pool (+ cross-channel LRN), one launch, one write.
//
// Replaces the TPU kernel _block_kernel (cuda_mpi_gpu_cluster_programming_tpu/
// ops/megakernel.py) behind conv_block_pallas and int8w_conv_block_pallas.
// Per output element it computes, in this order:
//   1. the conv sum in fp32: one fmaf per term in the fixed order
//      kg = (fy*F + fx)*C + c from 0, zeros outside the padded image, exactly
//      the chain of conv2d.cu;
//   2. int8w only: acc * scale[k] (rounded, never fused into an FMA) on the
//      uncast fp32 accumulator;
//   3. + bias in fp32, ReLU (a NaN stays NaN), one cast to the interior type
//      MID (x's type; bf16 for int8w): what the staged chain writes to HBM;
//   4. the VALID pw x pw / ps max-pool on MID values, NaN-propagating, in
//      maxpool.cu's tap order;
//   5. block 2 only: LRN in fp32 with lrn.cu's rounded window sum, powf and
//      divide, cast to OUT (x's type; fp32 for int8w).
// So fp32 and bf16 outputs are bitwise those of the staged kernel chain
// conv2d -> maxpool2d (-> lrn). int8w is not bitwise to its staged chain,
// which rounds the accumulator to bf16 before the host rescale.
//
// Operand types: fp32; bf16 (widened in registers); int8w = bf16 activations
// and int8 weights loaded as bytes and widened exactly (a quarter of fp32's
// weight bytes). Scale and int8w bias are fp32.
//
// Bound on the H100 SXM: operations, in every dtype. At batch 128:
//   block 1 (227x227x3 -> 27x27x96, F=11 s=4): 27.0 GFLOP; 115 MB in fp32;
//   block 2 (27x27x96 -> 13x13x256, F=5 s=1 p=2, + LRN): 114.7 GFLOP; 60 MB.
// fp32 on FFMA (67 TFLOP/s): 0.403 ms and 1.711 ms. bf16 and int8w against the
// tensor cores' 989 TFLOP/s: 0.027 ms and 0.116 ms. This kernel stays on FFMA
// (no wgmma, no TMA): making it fast is later work.
//
// Design. The TPU keeps one whole image per program in VMEM; here one image
// of conv1 output (1.16 MB in fp32) is far past the 227 KB of shared memory
// a block has. So a block owns one image, a band of `band` pooled rows and a
// channel range, and walks its pooled rows in order. For each pooled row it
// computes only the conv rows the pool window needs that it does not hold
// yet (3 for the first row, then 2: the 3/2 window shares one row) into a
// ring of pw conv rows in shared memory, then pools (and normalises) that
// row from the ring and writes it. Only the first conv row of each band after
// the first is computed twice: 3 of 55 rows in block 1, 1 of 27 in block 2.
// The conv step is an implicit GEMM over (new pixels x channels) chunks,
// reduction slices of BK terms staged in static shared memory, a TM x TN
// register tile per thread; a thread's channels are TX apart, so the weight
// reads of a warp fall in distinct banks.
// LRN needs channel neighbours +-2: a block-2 launch keeps ALL channels of
// its band in the ring (3 x 27 x 256 x 4 B = 83 KB in fp32, above the 48 KB
// of static shared memory, so dynamic, raised by cudaFuncSetAttribute) and
// computes them in chunks of 256; a pooled neighbour is re-maxed from the
// ring where LRN reads it (9 compares), no halo and no second buffer.
// Without LRN a block takes 32 channels, which keeps the ring at 21 KB for
// block 1 and gives the card 3x more blocks.
#include "common.cuh"

namespace {

constexpr int BK = 16;  // reduction terms staged per step

// TY x TX threads; each computes TM pixels (TY apart) x TN channels (TX
// apart). QA threads load one pixel's BK-term slice, BK/QA terms each.
template <int TY_, int TX_, int TM_, int TN_, int QA_>
struct Tiling {
  static constexpr int TY = TY_, TX = TX_, TM = TM_, TN = TN_, QA = QA_;
  static constexpr int THREADS = TY * TX;
  static constexpr int BM = TY * TM;  // pixels per GEMM chunk
  static constexpr int KT = TX * TN;  // channels per GEMM chunk
  static_assert(QA * BM <= THREADS && BK % QA == 0, "A loader");
  static_assert((BK * KT) % THREADS == 0, "B loader");
};
// Block without LRN: 112 pixels (two conv1 rows of 55) x 32 channels.
using PlainTiling = Tiling<16, 8, 7, 4, 1>;
// Block with LRN: 56 pixels (two conv2 rows of 27) x 256 channels.
using LrnTiling = Tiling<8, 32, 7, 8, 4>;

struct Geometry {
  int N, H, W, C, K, F, stride, pad, Ho, Wo;
  int pw, ps, Hp, Wp, band;  // pool window and stride, pooled dims, pooled rows per block
  int lrn_size;
  float lrn_a, lrn_beta, lrn_k;  // lrn_a = alpha or alpha/size, folded by the caller
};

// The pooled value at (pooled row whose window starts at conv row `top`,
// column px, ring channel cl), as maxpool.cu takes it: start from tap (0,0),
// keep the first of equal values, let a NaN win.
template <typename MID>
__device__ __forceinline__ MID pool_at(const MID* ring, const Geometry& g, int cr, int top,
                                       int px, int cl) {
  const int x0 = px * g.ps;
  MID best = ring[(static_cast<size_t>(top % g.pw) * g.Wo + x0) * cr + cl];
  float bf = port::to_f32(best);
  for (int fy = 0; fy < g.pw; ++fy) {
    const MID* row = ring + static_cast<size_t>((top + fy) % g.pw) * g.Wo * cr;
    for (int fx = 0; fx < g.pw; ++fx) {
      const MID v = row[static_cast<size_t>(x0 + fx) * cr + cl];
      const float vf = port::to_f32(v);
      if (vf > bf || vf != vf) {
        best = v;
        bf = vf;
      }
    }
  }
  return best;
}

template <class Tl, bool LRN, typename X, typename WT, typename BT, typename MID, typename OUT>
__global__ void __launch_bounds__(Tl::THREADS)
conv_block_kernel(const X* __restrict__ x, const WT* __restrict__ w,
                  const BT* __restrict__ bias, const float* __restrict__ scale,
                  OUT* __restrict__ y, Geometry g) {
  static_assert(LRN || sizeof(OUT) == sizeof(MID), "a block without LRN writes the pooled MID");
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  MID* ring = reinterpret_cast<MID*>(ring_bytes);  // [pw][Wo][cr]
  __shared__ float As[BK][Tl::BM];
  __shared__ float Bs[BK][Tl::KT];

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int c_lo = LRN ? 0 : blockIdx.x * Tl::KT;
  const int c_hi = LRN ? g.K : min(g.K, c_lo + Tl::KT);
  const int cr = c_hi - c_lo;
  const int py0 = blockIdx.y * g.band;
  const int py1 = min(g.Hp, py0 + g.band);
  const int KG = g.F * g.F * g.C;
  const X* xn = x + static_cast<size_t>(n) * g.H * g.W * g.C;

  const int tx = tid % Tl::TX;
  const int ty = tid / Tl::TX;
  constexpr int A_TERMS = BK / Tl::QA;
  const int a_pix = tid % Tl::BM;
  const int a_part = tid / Tl::BM;
  const bool a_loader = a_part < Tl::QA;

  int have = py0 * g.ps;  // conv rows before `have` are in the ring (none yet)
  for (int py = py0; py < py1; ++py) {
    const int top = py * g.ps;
    const int r_lo = max(have, top);
    const int npix = (top + g.pw - r_lo) * g.Wo;  // the new conv rows' pixels
    for (int kc = c_lo; kc < c_hi; kc += Tl::KT) {
      for (int m0 = 0; m0 < npix; m0 += Tl::BM) {
        const int ap = m0 + a_pix;
        const bool a_ok = a_loader && ap < npix;
        int iy0 = 0, ix0 = 0;
        if (a_ok) {
          const int dr = ap / g.Wo;
          iy0 = (r_lo + dr) * g.stride - g.pad;
          ix0 = (ap - dr * g.Wo) * g.stride - g.pad;
        }
        float acc[Tl::TM][Tl::TN];
#pragma unroll
        for (int i = 0; i < Tl::TM; ++i)
#pragma unroll
          for (int j = 0; j < Tl::TN; ++j) acc[i][j] = 0.f;

        for (int k0 = 0; k0 < KG; k0 += BK) {
          if (a_loader) {
            const int kg = k0 + a_part * A_TERMS;
            int cy = kg / (g.F * g.C);
            const int rem = kg - cy * g.F * g.C;
            int cx = rem / g.C;
            int cc = rem - cx * g.C;
#pragma unroll
            for (int j = 0; j < A_TERMS; ++j) {
              float v = 0.f;
              const int iy = iy0 + cy;
              const int ix = ix0 + cx;
              if (a_ok && kg + j < KG && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
                v = port::to_f32(xn[(static_cast<size_t>(iy) * g.W + ix) * g.C + cc]);
              }
              As[a_part * A_TERMS + j][a_pix] = v;
              if (++cc == g.C) {
                cc = 0;
                if (++cx == g.F) {
                  cx = 0;
                  ++cy;
                }
              }
            }
          }
#pragma unroll
          for (int e = 0; e < BK * Tl::KT / Tl::THREADS; ++e) {
            const int i = tid + e * Tl::THREADS;
            const int row = i / Tl::KT;
            const int col = i % Tl::KT;
            const int kg = k0 + row;
            const int ch = kc + col;
            Bs[row][col] = (kg < KG && ch < c_hi)
                               ? port::to_f32(w[static_cast<size_t>(kg) * g.K + ch])
                               : 0.f;
          }
          __syncthreads();
#pragma unroll
          for (int kk = 0; kk < BK; ++kk) {
            float a[Tl::TM], b[Tl::TN];
#pragma unroll
            for (int i = 0; i < Tl::TM; ++i) a[i] = As[kk][ty + Tl::TY * i];
#pragma unroll
            for (int j = 0; j < Tl::TN; ++j) b[j] = Bs[kk][tx + Tl::TX * j];
#pragma unroll
            for (int i = 0; i < Tl::TM; ++i)
#pragma unroll
              for (int j = 0; j < Tl::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
          __syncthreads();
        }

        // Epilogue into the ring: (rescale), bias, ReLU, cast to MID.
#pragma unroll
        for (int i = 0; i < Tl::TM; ++i) {
          const int p = m0 + ty + Tl::TY * i;
          if (p >= npix) continue;
          const int dr = p / g.Wo;
          MID* dst = ring + (static_cast<size_t>((r_lo + dr) % g.pw) * g.Wo + (p - dr * g.Wo)) * cr;
#pragma unroll
          for (int j = 0; j < Tl::TN; ++j) {
            const int ch = kc + tx + Tl::TX * j;
            if (ch >= c_hi) continue;
            float v = acc[i][j];
            if (scale != nullptr) v = __fmul_rn(v, scale[ch]);
            v = v + port::to_f32(bias[ch]);
            if (v < 0.f) v = 0.f;
            dst[ch - c_lo] = port::from_f32<MID>(v);
          }
        }
      }
    }
    have = top + g.pw;
    __syncthreads();

    // Pool (and normalise) pooled row py from the ring; one write.
    OUT* out_row = y + static_cast<size_t>(n * g.Hp + py) * g.Wp * g.K;
    for (int i = tid; i < g.Wp * cr; i += Tl::THREADS) {
      const int px = i / cr;
      const int cl = i - px * cr;
      OUT* dst = out_row + static_cast<size_t>(px) * g.K + c_lo + cl;
      if constexpr (LRN) {
        const int half = g.lrn_size / 2;
        const int lo = cl - half < 0 ? 0 : cl - half;
        const int hi = cl + half > g.K - 1 ? g.K - 1 : cl + half;
        float s = 0.f;
        for (int j = lo; j <= hi; ++j) {
          const float v = port::to_f32(pool_at(ring, g, cr, top, px, j));
          s = __fadd_rn(s, __fmul_rn(v, v));
        }
        const float sc = __fadd_rn(g.lrn_k, __fmul_rn(g.lrn_a, s));
        const float v = port::to_f32(pool_at(ring, g, cr, top, px, cl));
        *dst = port::from_f32<OUT>(__fdiv_rn(v, powf(sc, g.lrn_beta)));
      } else {
        *dst = pool_at(ring, g, cr, top, px, cl);
      }
    }
    __syncthreads();
  }
}

template <class Tl, bool LRN, typename X, typename WT, typename BT, typename MID, typename OUT>
int launch(const void* x, const void* w, const void* b, const void* scale, void* y,
           const Geometry& g, void* stream) {
  auto kernel = conv_block_kernel<Tl, LRN, X, WT, BT, MID, OUT>;
  const int cr = LRN ? g.K : (g.K < Tl::KT ? g.K : Tl::KT);
  const size_t ring = sizeof(MID) * g.pw * g.Wo * cr;
  // A ring past what the card allows is refused here, with this error code.
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(ring));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(LRN ? 1 : port::blocks_for(g.K, Tl::KT), port::blocks_for(g.Hp, g.band), g.N);
  kernel<<<grid, Tl::THREADS, ring, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const X*>(x), static_cast<const WT*>(w), static_cast<const BT*>(b),
      static_cast<const float*>(scale), static_cast<OUT*>(y), g);
  return static_cast<int>(cudaGetLastError());
}

// X (activations), WT (weights), BT (bias), MID (interior), OUT (with LRN).
template <typename X, typename WT, typename BT, typename MID, typename OUT_LRN>
int dispatch(const void* x, const void* w, const void* b, const void* scale, void* y, int N,
             int H, int W, int C, int K, int F, int stride, int pad, int Ho, int Wo, int pw,
             int ps, int Hp, int Wp, int band, int lrn, int lrn_size, float lrn_a,
             float lrn_beta, float lrn_k, void* stream) {
  const Geometry g{N, H, W, C, K, F, stride, pad, Ho, Wo, pw, ps, Hp, Wp, band,
                   lrn_size, lrn_a, lrn_beta, lrn_k};
  if (lrn) return launch<LrnTiling, true, X, WT, BT, MID, OUT_LRN>(x, w, b, scale, y, g, stream);
  return launch<PlainTiling, false, X, WT, BT, MID, MID>(x, w, b, scale, y, g, stream);
}

}  // namespace

#define CONV_BLOCK_ARGS                                                                    \
  const void *x, const void *w, const void *b, const void *scale, void *y, int N, int H,  \
      int W, int C, int K, int F, int stride, int pad, int Ho, int Wo, int pw, int ps,    \
      int Hp, int Wp, int band, int lrn, int lrn_size, float lrn_a, float lrn_beta,       \
      float lrn_k, void *stream
#define CONV_BLOCK_PASS                                                                  \
  x, w, b, scale, y, N, H, W, C, K, F, stride, pad, Ho, Wo, pw, ps, Hp, Wp, band, lrn,  \
      lrn_size, lrn_a, lrn_beta, lrn_k, stream

extern "C" int conv_block_f32(CONV_BLOCK_ARGS) {
  return dispatch<float, float, float, float, float>(CONV_BLOCK_PASS);
}

extern "C" int conv_block_bf16(CONV_BLOCK_ARGS) {
  return dispatch<port::bf16, port::bf16, port::bf16, port::bf16, port::bf16>(CONV_BLOCK_PASS);
}

// int8w: bf16 activations, int8 weights, fp32 bias and scale; bf16 interior;
// bf16 out of a block without LRN, fp32 out of the LRN.
extern "C" int conv_block_int8w(CONV_BLOCK_ARGS) {
  return dispatch<port::bf16, int8_t, float, port::bf16, float>(CONV_BLOCK_PASS);
}
