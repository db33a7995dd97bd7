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
// (oy + qh, ox + qw): every window is unit-stride and in bounds.
//
// So taps is a stride-1, unpadded conv of xs (an N x Hs x Ws image of cs
// channels) with the HWIO weights ws (F = fq), which is what it hands the
// Hopper mainloop of conv_sm90.cuh. The TPU kernel's order, qh outer, qw,
// then the cs channels (kg = (qh*fq + qw)*cs + c), is the mainloop's
// (fy*F + fx)*C + c term for term, and the terms are im2col's xcol columns:
// fp32 the mainloop's 64-term partials (the bits of conv_pairs.cu and conv_im2col.cu,
// and of conv2d.cu at stride 1, where the s2d order is vcol's), bf16 the
// mainloop's mma.sync k-steps (the same three-way bits). cs is a multiple of
// the 16-byte vector at both stages (48, 96), so each pixel's terms come in
// 16-byte cp.async runs. The zero taps past F (conv1: 3 x 3 x 16 tap
// positions against 11 x 11) are summed as exact zeros: 19% more terms on
// conv1, none on conv2 (s = 1).
//
// Bound on the H100: operations, as conv2d.cu (FFMA in fp32, the tensor
// cores in bf16). Design: the mainloop's 128 x 128 tile (128 x 64 for
// k_block = 64 and hpool), plain, k_block and hpool as conv2d.cu runs them.
#include "conv_sm90.cuh"

namespace {

template <typename T>
int launch(const void* xs, const void* w, const void* b, void* y, int N, int Hs, int Ws, int cs, int K, int fq,
           int Ho, int Wo, int relu, int k_block, int pw, int ps, int Hp, void* stream) {
  const auto g = sm90::make_conv<T>(xs, w, Hs, Ws, cs, K, fq, /*stride=*/1, /*pad_h=*/0, /*pad_w=*/0);
  return pw > 0 ? sm90::launch_hpool(g, b, y, N, Wo, relu, pw, ps, Hp, stream)
                : sm90::launch_tiles(g, b, y, N, Ho, Wo, relu, k_block, stream);
}

}  // namespace

// k_block and pw/ps/Hp as in conv2d.cu.
#define CONV_TAPS_ARGS                                                                      \
  const void *xs, const void *w, const void *b, void *y, int N, int Hs, int Ws, int cs, int K, \
      int fq, int Ho, int Wo, int relu, int k_block, int pw, int ps, int Hp, void *stream
#define CONV_TAPS_PASS xs, w, b, y, N, Hs, Ws, cs, K, fq, Ho, Wo, relu, k_block, pw, ps, Hp, stream

extern "C" int conv_taps_f32(CONV_TAPS_ARGS) { return launch<float>(CONV_TAPS_PASS); }

extern "C" int conv_taps_bf16(CONV_TAPS_ARGS) { return launch<port::bf16>(CONV_TAPS_PASS); }
