// Direct convolution (cross-correlation) + bias + ReLU on NHWC/HWIO tensors:
// the "vcol" conv body.
//
// Replaces the TPU kernel _conv_vcol_kernel (cuda_mpi_gpu_cluster_programming_tpu/
// ops/pallas_kernels.py) with its epilogue _conv_epilogue, including the
// epilogue's hpool fusion and the k_block grid. It computes the same
// function without the TPU's space-to-depth repacking: strided reads are
// cheap here, so the kernel indexes the padded input directly.
//
// Shape of the work: an implicit GEMM. Rows are output pixels m = (n, oy, ox)
// (M = N*Ho*Wo), columns are output channels (K), and the reduction runs
// over kg = (fy*F + fx)*C + c (KG = F*F*C), exactly the row-major order of
// the HWIO weight tensor viewed as a (KG, K) matrix.
//
// Bound on the H100: operations. conv1 at batch 128 is 27 GFLOP against
// 0.23 GB of tensors, conv2 115 GFLOP against 0.11 GB: far above the ridge in
// both dtypes. fp32 runs on FFMA (the fp32 contract forbids TF32), bf16 on
// the tensor cores. Design: the Hopper mainloop of conv_sm90.cuh, a 128 x 128
// tile (128 x 64 for k_block = 64 and hpool) of 256 threads, a 3-stage (fp32)
// or 4-stage (bf16) cp.async ring of 32-term slices, the pixels gathered
// channel-major in 16-byte runs (conv2, C = 96) or term by term (conv1,
// C = 3); fp32 in the mainloop's two-level order, a partial a 64-term block
// in kg order (bitwise conv_taps.cu's at stride 1), bf16 as mma.sync.m16n8k16 steps in kg order
// (the same steps as conv_block.cu's conv, so the fused block stays bitwise
// the staged chain).
#include "conv_sm90.cuh"

namespace {

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int N, int H, int W, int C, int K, int F,
           int stride, int pad_h, int pad_w, int Ho, int Wo, int relu, int k_block, int pw, int ps, int Hp,
           void* stream) {
  const auto g = sm90::make_conv<T>(x, w, H, W, C, K, F, stride, pad_h, pad_w);
  return pw > 0 ? sm90::launch_hpool(g, b, y, N, Wo, relu, pw, ps, Hp, stream)
                : sm90::launch_tiles(g, b, y, N, Ho, Wo, relu, k_block, stream);
}

}  // namespace

// pad_h, pad_w: zero rows and columns on each side of x (the row-sharded tier
// runs pad_h = 0, its halos holding the rows). k_block: 0, or the output
// channels one block owns (K % k_block == 0). pw > 0: write the H-axis max of
// a pw / ps pool, (N, Hp, Wo, K).
#define CONV2D_ARGS                                                                          \
  const void *x, const void *w, const void *b, void *y, int N, int H, int W, int C, int K,      \
      int F, int stride, int pad_h, int pad_w, int Ho, int Wo, int relu, int k_block, int pw, \
      int ps, int Hp, void *stream
#define CONV2D_PASS x, w, b, y, N, H, W, C, K, F, stride, pad_h, pad_w, Ho, Wo, relu, k_block, pw, ps, Hp, stream

extern "C" int conv2d_bias_relu_f32(CONV2D_ARGS) { return launch<float>(CONV2D_PASS); }

extern "C" int conv2d_bias_relu_bf16(CONV2D_ARGS) { return launch<port::bf16>(CONV2D_PASS); }
