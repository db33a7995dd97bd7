// Phase-packed conv + bias + ReLU: the "g8" conv body, for a stride s >= 2.
//
// Replaces the TPU kernel _conv_g8_kernel (cuda_mpi_gpu_cluster_programming_tpu/
// ops/pallas_kernels.py) with its epilogue _conv_epilogue. Operands, packed by
// the wrapper (ops/packing.py, bitwise the JAX package's packers):
//   xs8 (N, Hs8, Ws8, G)        space_to_depth(pad(x)) at g = 2s, G = g*g*C
//                               (conv1: 192 channels against taps' 48), with
//                               Hs8 >= Ho2 + fq8 - 1 and Ws8 >= Wo2 + fq8 - 1;
//   w8  (2, 2, fq8, fq8, G, K)  weights_to_phase_depth(w): phase (ph, pw)'s
//                               filter at offset (ph*s, pw*s) in a zero frame
//                               of fq8*g rows and columns, fq8 = ceil((F+s)/g).
// Output pixel (oy, ox) = (2a + ph, 2b + pw), one of the 2 x 2 output phases,
// is the taps conv of xs8 at (a, b) with phase (ph, pw)'s weight frame: input
// row oy*s + fy is a*g + (ph*s + fy), so every phase reads the same g-rows
// [a, a + fq8) and the phase's offset lives in the frame's zeros. Ho2 =
// ceil(Ho/2), Wo2 = ceil(Wo/2).
//
// The reduction runs in the order kg = (qh*fq8 + qw)*G + c over all fq8*fq8*G
// terms, the frame's zeros included (conv1: 768 terms per output against
// vcol's 363; a zero weight adds an exact zero). Its order of the non-zero
// terms is not the taps order, so g8 agrees with the other conv bodies within
// the conv tolerance, not bitwise.
//
// Bound on the H100: operations (FFMA), as conv2d.cu. Design: the shared
// implicit-GEMM engine (conv_engine.cuh) with its s2d window operand policy
// over xs8, on a grid whose third dimension is the output phase. A block takes
// its phase's weight frame and writes its pixels straight to their place in
// the (N, Ho, Wo, K) output, so there is no de-interleave pass (the TPU
// version transposes its phase-major output on the host). A phase pixel past
// Ho or Wo (odd Ho or Wo) reads the packing's zero padding and is not written.
#include "conv_engine.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(engine::THREADS)
conv_g8_kernel(engine::S2dOp<T> op, const T* __restrict__ bias, T* __restrict__ y, int N, int Ho, int Wo,
               int Ho2, int Wo2, int relu) {
  using namespace engine;
  __shared__ Tile sm;
  const int ph = blockIdx.z >> 1;
  const int pw = blockIdx.z & 1;
  op.w += static_cast<size_t>(blockIdx.z) * op.KG * op.K;  // this phase's weight frame
  const int tid = threadIdx.x;
  const int per_image = Ho2 * Wo2;
  const int M = N * per_image;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  int an = 0, aa = 0, ab = 0;
  const bool ok = m0 + tid < M;
  if (ok) {
    an = (m0 + tid) / per_image;
    const int r = m0 + tid - an * per_image;
    aa = r / Wo2;
    ab = r - aa * Wo2;
  }
  float acc[TM][TN];
  accumulate(op, op.loader(ok, an, aa, ab), n0, sm, acc);

  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
    const int n = m / per_image;
    const int r = m - n * per_image;
    const int oy = 2 * (r / Wo2) + ph;
    const int ox = 2 * (r % Wo2) + pw;
    if (oy >= Ho || ox >= Wo) continue;
    T* out = y + ((static_cast<size_t>(n) * Ho + oy) * Wo + ox) * op.K;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int ch = n0 + tx * TN + j;
      if (ch < op.K) out[ch] = epilogue(acc[i][j], bias, ch, relu);
    }
  }
}

template <typename T>
int launch(const void* xs8, const void* w8, const void* b, void* y, int N, int Hs8, int Ws8, int G, int K,
           int fq8, int Ho, int Wo, int relu, void* stream) {
  const engine::S2dOp<T> op{static_cast<const T*>(xs8), static_cast<const T*>(w8), K, fq8 * fq8 * G,
                            Hs8, Ws8, G, fq8};
  const int Ho2 = (Ho + 1) / 2;
  const int Wo2 = (Wo + 1) / 2;
  dim3 grid(port::blocks_for(static_cast<long long>(N) * Ho2 * Wo2, engine::BM),
            port::blocks_for(K, engine::BN), 4);
  conv_g8_kernel<T><<<grid, engine::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      op, static_cast<const T*>(b), static_cast<T*>(y), N, Ho, Wo, Ho2, Wo2, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define CONV_G8_ARGS                                                                         \
  const void *xs8, const void *w8, const void *b, void *y, int N, int Hs8, int Ws8, int G, int K, \
      int fq8, int Ho, int Wo, int relu, void *stream
#define CONV_G8_PASS xs8, w8, b, y, N, Hs8, Ws8, G, K, fq8, Ho, Wo, relu, stream

extern "C" int conv_g8_f32(CONV_G8_ARGS) { return launch<float>(CONV_G8_PASS); }

extern "C" int conv_g8_bf16(CONV_G8_ARGS) { return launch<port::bf16>(CONV_G8_PASS); }
