// im2col GEMM + bias + ReLU: the "fused" conv body.
//
// Replaces the TPU kernel _conv_fused_kernel (cuda_mpi_gpu_cluster_programming_tpu/
// ops/pallas_kernels.py) with _conv_epilogue. As in the JAX package, the
// im2col is tensor code outside the kernel (the wrapper, ops/cuda_kernels.py
// _im2col_operands over ops/packing.py):
//   xcol (M, KD)   M = N*Ho*Wo output pixels, KD = fq*fq*cs: the s2d
//                  windows of taps (qh, qw) concatenated in that order
//                  (conv1 432, conv2 2400);
//   w    (KD, K)   weights_to_depth(w) viewed as a matrix.
// The GEMM (M, KD) x (KD, K) is a 1 x 1 conv over an "image" of N x Ho x Wo
// pixels with KD channels, which is what it hands the Hopper mainloop of
// conv_sm90.cuh (make_conv with W = Wo, F = 1, stride 1, no padding): each
// pixel's KD terms are one contiguous row of xcol, gathered in 16-byte
// cp.async runs (KD is a multiple of the vector at both stages). The terms
// run in kd order, the taps order: fp32 the mainloop's 64-term partials (the bits of
// conv_taps.cu), bf16 the mainloop's mma.sync k-steps (the bits of
// conv_pairs.cu, and of conv2d.cu at stride 1).
//
// Bound on the H100: operations, as conv2d.cu (FFMA in fp32, the tensor
// cores in bf16). xcol adds bytes on top: at batch 128 about 0.67 GB (conv1)
// and 0.90 GB (conv2) in fp32, written by the packing and read once here.
#include "conv_sm90.cuh"

namespace {

template <typename T>
int launch(const void* a, const void* w, const void* b, void* y, int N, int Ho, int Wo, int KD, int K,
           int relu, void* stream) {
  const auto g = sm90::make_conv<T>(a, w, Ho, Wo, KD, K, /*F=*/1, /*stride=*/1, /*pad_h=*/0, /*pad_w=*/0);
  return sm90::launch_tiles_cfg<sm90::Cfg<T, 128, 128>>(g, b, y, N, Ho, Wo, relu,
                                                        static_cast<cudaStream_t>(stream));
}

}  // namespace

// xcol (N*Ho*Wo, KD), w (KD, K), b (K,) -> y (N*Ho*Wo, K).
#define CONV_IM2COL_ARGS                                                                     \
  const void *xcol, const void *w, const void *b, void *y, int N, int Ho, int Wo, int KD, int K, \
      int relu, void *stream
#define CONV_IM2COL_PASS xcol, w, b, y, N, Ho, Wo, KD, K, relu, stream

extern "C" int conv_im2col_f32(CONV_IM2COL_ARGS) { return launch<float>(CONV_IM2COL_PASS); }

extern "C" int conv_im2col_bf16(CONV_IM2COL_ARGS) { return launch<port::bf16>(CONV_IM2COL_PASS); }
