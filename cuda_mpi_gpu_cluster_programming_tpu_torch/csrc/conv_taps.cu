// Space-to-depth conv + bias + ReLU: the "taps" conv body.
//
// Replaces the TPU kernel _conv_kernel (cuda_mpi_gpu_cluster_programming_tpu/
// ops/pallas_kernels.py) with its epilogue _conv_epilogue, including the
// hpool fusion and the k_block grid. Operands, packed by the wrapper
// (ops/packing.py, bitwise the JAX package's packers):
//   xs (N, Hs, Ws, cs)     space_to_depth(pad(x)), cs = s*s*C, with
//                          Hs >= Ho + fq - 1 and Ws >= Wo + fq - 1;
//   ws (fq, fq, cs, K)     weights_to_depth(w), zero taps past F;
// fq = ceil(F / s). Output row oy, tap (qh, qw) reads s2d pixel
// (oy + qh, ox + qw): every window is unit-stride and in bounds, so the
// kernel never tests a pixel against the image edge.
//
// The reduction runs in the TPU kernel's fixed order, qh outer, qw, then the
// cs channels (kg = (qh*fq + qw)*cs + c, the row-major order of ws viewed as
// a (fq*fq*cs, K) matrix), one fmaf per term. The fq*cs terms of one qh row
// are contiguous in xs (pixel ox + qw + 1 follows ox + qw), so the gather is
// a pointer that steps by one and jumps once per qh row; conv2d.cu's cursor
// walks C = 3 channels at a time on conv1 instead. The zero taps past F
// (conv1: 3 x 3 x 16 tap positions against 11 x 11) are summed as exact
// zeros: 19% more FMAs on conv1, none on conv2 (s = 1).
//
// Bound on the H100: operations (FFMA), as conv2d.cu. Design: the shared
// implicit-GEMM engine (conv_engine.cuh) with its s2d window operand policy.
#include "conv_engine.cuh"

namespace {

template <typename T>
int launch(const void* xs, const void* w, const void* b, void* y, int N, int Hs, int Ws, int cs,
           int K, int fq, int Ho, int Wo, int relu, int k_block, int pw, int ps, int Hp, void* stream) {
  const engine::S2dOp<T> op{static_cast<const T*>(xs), static_cast<const T*>(w), K, fq * fq * cs,
                     Hs, Ws, cs, fq};
  return pw > 0 ? engine::launch_hpool(op, b, y, N, Wo, relu, pw, ps, Hp, stream)
                : engine::launch_tiles(op, b, y, N, Ho, Wo, relu, k_block, stream);
}

}  // namespace

// k_block and pw/ps/Hp as in conv2d.cu.
#define CONV_TAPS_ARGS                                                                      \
  const void *xs, const void *w, const void *b, void *y, int N, int Hs, int Ws, int cs, int K, \
      int fq, int Ho, int Wo, int relu, int k_block, int pw, int ps, int Hp, void *stream
#define CONV_TAPS_PASS xs, w, b, y, N, Hs, Ws, cs, K, fq, Ho, Wo, relu, k_block, pw, ps, Hp, stream

extern "C" int conv_taps_f32(CONV_TAPS_ARGS) { return launch<float>(CONV_TAPS_PASS); }

extern "C" int conv_taps_bf16(CONV_TAPS_ARGS) { return launch<port::bf16>(CONV_TAPS_PASS); }
