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
//   3. + bias in fp32, ReLU (-0.0 to +0.0, a NaN stays NaN), one cast to the interior type
//      MID (x's type; bf16 for int8w): what the staged chain writes to HBM;
//   4. the VALID pw x pw / ps max-pool on MID values, NaN-propagating, in
//      maxpool.cu's tap order;
//   5. block 2 only: LRN in fp32 with lrn.cu's rounded window sum, powf and
//      divide, cast to OUT (x's type; fp32 for int8w).
// So fp32 and bf16 outputs are bitwise those of the staged kernel chain
// conv2d -> maxpool2d (-> lrn). int8w is not bitwise to its staged chain,
// which rounds the accumulator to bf16 before the host rescale.
//
// Operand types: fp32; bf16; int8w = bf16 activations and int8 weights
// loaded as bytes and widened exactly to bf16 at the copy into shared memory
// (a quarter of fp32's weight bytes). Scale and int8w bias are fp32.
//
// Bound on the H100 SXM: operations, in every dtype. At batch 128:
//   block 1 (227x227x3 -> 27x27x96, F=11 s=4): 27.0 GFLOP; 115 MB in fp32;
//   block 2 (27x27x96 -> 13x13x256, F=5 s=1 p=2, + LRN): 114.7 GFLOP; 60 MB.
// fp32 on FFMA (67 TFLOP/s): 0.403 ms and 1.711 ms. bf16 and int8w against the
// tensor cores' 989 TFLOP/s: 0.027 ms and 0.116 ms.
//
// Design. The TPU keeps one whole image per program in VMEM; here one image
// of conv1 output (1.16 MB in fp32) is far past the 227 KB of shared memory
// a block has. So a block owns one image, a band of `band` pooled rows and a
// channel range, and walks its pooled rows in order. For each pooled row it
// computes only the conv rows the pool windows need that it does not hold
// yet (3 for the first row, then 2: the 3/2 window shares one row) into a
// ring of conv rows in shared memory, then pools (and normalises) those
// rows from the ring and writes them. Only the first conv row of each band after
// the first is computed twice: 3 of 55 rows in block 1, 1 of 27 in block 2.
// The conv step is conv2d.cu's: the Hopper mainloop of conv_sm90.cuh over
// (new pixels x channels) tiles, fp32 as the same fmaf chain, bf16 and int8w
// as the same mma.sync.m16n8k16 steps in kg order, its stages in shared
// memory before the ring. Block 1 (no LRN) takes a 128 x 128 tile: the
// 110 new pixels of a pooled row, and all of conv1's 96 channels. Block 2
// (LRN) in bf16 and int8w walks two pooled rows a step: their 108 new pixels
// (4 conv rows of 27) are one 128 x 128 tile, in two channel chunks, and the
// ring holds the 5 conv rows they read. In fp32 it walks one: 54 new pixels,
// a 64 x 128 tile, a ring of 3 rows (beside a 5-row fp32 ring only short
// stages fit, and those ran slower on the H100).
// LRN needs channel neighbours +-2: a block-2 launch keeps ALL channels of
// its band in the ring (3 x 27 x 256 x 4 B = 83 KB in fp32; bf16 5 x 27 x
// 256 x 2 B = 69 KB) and a pooled neighbour is re-maxed from the ring where
// LRN reads it (9 compares), no halo and no second buffer.
#include "conv_sm90.cuh"

namespace {

struct Geometry {
  int N, H, W, C, K, F, stride, pad, Ho, Wo;
  int pw, ps, Hp, Wp, band;  // pool window and stride, pooled dims, pooled rows per block
  int lrn_size;
  float lrn_a, lrn_beta, lrn_k;  // lrn_a = alpha or alpha/size, folded by the caller
};

// The pooled value at (pooled row whose window starts at conv row `top`,
// column px, ring channel cl): start from tap (0,0), then take a tap that is
// greater or a NaN. The ring holds only the kernel's own ReLU output, which
// sends -0.0 to +0.0, so no window holds -0.0 and this is common.cuh's
// max_step (jnp.maximum's rule) without its signed-zero test, which would
// lengthen the chain a tap and cost FUSE=block time for no bit.
// The ring holds `rows` conv rows, conv row r in slot r % rows.
template <typename MID>
__device__ __forceinline__ MID pool_at(const MID* ring, const Geometry& g, int rows, int cr, int top,
                                       int px, int cl) {
  const int x0 = px * g.ps;
  MID best = ring[(static_cast<size_t>(top % rows) * g.Wo + x0) * cr + cl];
  float bf = port::to_f32(best);
  for (int fy = 0; fy < g.pw; ++fy) {
    const MID* row = ring + static_cast<size_t>((top + fy) % rows) * g.Wo * cr;
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

// R pooled rows a step: their new conv rows are one GEMM of up to R*ps*Wo pixels.
template <class C, int R, bool LRN, typename X, typename WT, typename BT, typename MID, typename OUT>
__global__ void __launch_bounds__(sm90::THREADS, 1)
conv_block_kernel(sm90::Conv<X, WT> cv, const BT* __restrict__ bias, const float* __restrict__ scale,
                  OUT* __restrict__ y, Geometry g) {
  static_assert(LRN || sizeof(OUT) == sizeof(MID), "a block without LRN writes the pooled MID");
  extern __shared__ __align__(128) unsigned char smem[];
  MID* ring = reinterpret_cast<MID*>(smem + C::SMEM_BYTES);  // [rows][Wo][cr], after the stages
  const int rows = (R - 1) * g.ps + g.pw;  // the conv rows R pooled rows read

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int c_lo = LRN ? 0 : blockIdx.x * C::BN;
  const int c_hi = LRN ? g.K : min(g.K, c_lo + C::BN);
  const int cr = c_hi - c_lo;
  const int py0 = blockIdx.y * g.band;
  const int py1 = min(g.Hp, py0 + g.band);

  int have = py0 * g.ps;  // conv rows before `have` are in the ring (none yet)
  for (int py = py0; py < py1; py += R) {
    const int nr = min(R, py1 - py);  // pooled rows this step
    const int top = py * g.ps;
    const int last = top + (nr - 1) * g.ps + g.pw;  // one past the last conv row they read
    const int r_lo = max(have, top);
    const int npix = (last - r_lo) * g.Wo;  // the new conv rows' pixels
    const sm90::PixMap pm{npix, npix, n, r_lo, g.Wo};
    for (int kc = c_lo; kc < c_hi; kc += C::BN) {
      for (int m0 = 0; m0 < npix; m0 += C::BM) {
        float acc[C::ACC];
        sm90::mainloop<C>(cv, pm, m0, kc, smem, acc);
        // Epilogue into the ring: (rescale), bias, ReLU, cast to MID.
#pragma unroll
        for (int e = 0; e < C::ACC; ++e) {
          int m, nn;
          C::coord(e, m, nn);
          const int p = m0 + m, ch = kc + nn;
          if (p >= npix || ch >= c_hi) continue;
          const int dr = p / g.Wo;
          float v = acc[e];
          if (scale != nullptr) v = __fmul_rn(v, scale[ch]);
          v = v + port::to_f32(bias[ch]);
          if (v <= 0.f) v = 0.f;  // -0.0 too, as jnp.maximum(v, 0); a NaN stays
          ring[(static_cast<size_t>((r_lo + dr) % rows) * g.Wo + (p - dr * g.Wo)) * cr + ch - c_lo] =
              port::from_f32<MID>(v);
        }
      }
    }
    have = last;
    __syncthreads();

    // Pool (and normalise) pooled rows py .. py + nr - 1 from the ring; one write.
    for (int i = tid; i < nr * g.Wp * cr; i += sm90::THREADS) {
      const int pr = i / (g.Wp * cr);
      const int rest = i - pr * g.Wp * cr;
      const int px = rest / cr;
      const int cl = rest - px * cr;
      const int ptop = top + pr * g.ps;
      OUT* dst = y + (static_cast<size_t>(n * g.Hp + py + pr) * g.Wp + px) * g.K + c_lo + cl;
      if constexpr (LRN) {
        const int half = g.lrn_size / 2;
        const int lo = cl - half < 0 ? 0 : cl - half;
        const int hi = cl + half > g.K - 1 ? g.K - 1 : cl + half;
        float s = 0.f;
        for (int j = lo; j <= hi; ++j) {
          const float v = port::to_f32(pool_at(ring, g, rows, cr, ptop, px, j));
          s = __fadd_rn(s, __fmul_rn(v, v));
        }
        const float sc = __fadd_rn(g.lrn_k, __fmul_rn(g.lrn_a, s));
        const float v = port::to_f32(pool_at(ring, g, rows, cr, ptop, px, cl));
        *dst = port::from_f32<OUT>(__fdiv_rn(v, powf(sc, g.lrn_beta)));
      } else {
        *dst = pool_at(ring, g, rows, cr, ptop, px, cl);
      }
    }
    __syncthreads();
  }
}

template <class C, int R, bool LRN, typename X, typename WT, typename BT, typename MID, typename OUT>
int launch(const void* x, const void* w, const void* b, const void* scale, void* y,
           const Geometry& g, void* stream) {
  auto kernel = conv_block_kernel<C, R, LRN, X, WT, BT, MID, OUT>;
  const int cr = LRN ? g.K : (g.K < C::BN ? g.K : C::BN);
  const size_t bytes = C::SMEM_BYTES + sizeof(MID) * ((R - 1) * g.ps + g.pw) * g.Wo * cr;
  // A ring past what the card allows is refused here, with this error code.
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int VEC = C::VEC;
  const sm90::Conv<X, WT> cv{static_cast<const X*>(x), static_cast<const WT*>(w), g.H, g.W, g.C, g.K, g.F,
                             g.stride, g.pad, g.F * g.F * g.C, g.C % VEC == 0 && port::aligned16(x),
                             g.K % (std::is_same<X, WT>::value ? VEC : 16) == 0 && port::aligned16(w)};
  if (!sm90::fits(cv)) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(LRN ? 1 : port::blocks_for(g.K, C::BN), port::blocks_for(g.Hp, g.band), g.N);
  kernel<<<grid, sm90::THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      cv, static_cast<const BT*>(b), static_cast<const float*>(scale), static_cast<OUT*>(y), g);
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
  // Block 2 (LRN), bf16 and int8w: two pooled rows a step, their 108 new pixels one 128-row tile
  // beside a 5-row ring of all channels. fp32, whose ring is twice the bytes: one pooled row a step,
  // its 54 new pixels a 64-row tile with 3 stages. Block 1: one pooled row, 110 pixels.
  if (lrn) {
    if constexpr (sizeof(X) == 4) {
      return launch<sm90::Cfg<X, 64, 128>, 1, true, X, WT, BT, MID, OUT_LRN>(x, w, b, scale, y, g, stream);
    } else {
      return launch<sm90::Cfg<X, 128, 128>, 2, true, X, WT, BT, MID, OUT_LRN>(x, w, b, scale, y, g, stream);
    }
  }
  return launch<sm90::Cfg<X, 128, 128>, 1, false, X, WT, BT, MID, MID>(x, w, b, scale, y, g, stream);
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
