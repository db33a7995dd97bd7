// Phase-packed conv + bias + ReLU: the "g8" conv body, for a stride s >= 2.
//
// Replaces the TPU kernel _conv_g8_kernel (cuda_mpi_gpu_cluster_programming_tpu/
// ops/pallas_kernels.py) with its epilogue _conv_epilogue. Operands, packed by
// the wrapper (ops/packing.py, bitwise the JAX package's packers, then
// ops/cuda_kernels.py _g8_phase_columns):
//   xs8 (N, Hs8, Ws8, G)          space_to_depth(pad(x)) at g = 2s, G = g*g*C
//                                 (conv1: 192 channels against taps' 48), with
//                                 Hs8 >= Ho2 + fq8 - 1 and Ws8 >= Wo2 + fq8 - 1;
//   wcols (fq8, fq8, G, 4K)       weights_to_phase_depth(w) with its four phase
//                                 weight frames side by side: column
//                                 (2ph + pw)K + ch is phase (ph, pw)'s channel ch.
// A phase frame holds phase (ph, pw)'s filter at offset (ph*s, pw*s) in zeros
// of fq8*g rows and columns, fq8 = ceil((F+s)/g). Output pixel (oy, ox) =
// (2a + ph, 2b + pw) is the taps conv of xs8 at (a, b) with its phase's frame:
// input row oy*s + fy is a*g + (ph*s + fy), so every phase reads the same
// g-rows [a, a + fq8) and the phase's offset lives in the frame's zeros.
// Ho2 = ceil(Ho/2), Wo2 = ceil(Wo/2).
//
// So g8 is one GEMM: a stride-1, unpadded conv of xs8 (F = fq8) with 4K
// output columns, each phase pixel's A row gathered once for all four
// phases. The Hopper mainloop of conv_sm90.cuh runs it (conv_phase_tiles),
// its store sending column (2ph + pw)K + ch of phase pixel (n, a, b) to
// y[n, 2a + ph, 2b + pw, ch], so there is no de-interleave pass (the TPU
// version transposes its phase-major output on the host); a phase pixel
// past Ho or Wo (odd Ho or Wo) reads the packing's zero rows and is not
// written. The reduction runs kg = (qh*fq8 + qw)*G + c over all fq8*fq8*G
// terms, the frame's zeros included (conv1: 768 a column against vcol's 363;
// a zero weight adds an exact zero): fp32 one fmaf chain a term, bf16 the
// mainloop's mma.sync k-steps. That order of the non-zero terms is not the
// taps order, so g8 agrees with the other conv bodies within the conv
// tolerance, not bitwise.
//
// Bound on the H100: operations (conv1 59 GFLOP at batch 128 with the
// frames' zeros), FFMA in fp32, the tensor cores in bf16. Design: the
// mainloop's 128 x 128 tile; conv1 is 100,352 phase pixels x 768 terms x 384
// columns, three whole column tiles; G = 192 is a multiple of 32, so a
// 32-term slice never crosses a tap and the gather is 16-byte cp.async runs.
#include "conv_sm90.cuh"

namespace {

template <typename T>
int launch(const void* xs8, const void* wcols, const void* b, void* y, int N, int Hs8, int Ws8, int G, int K,
           int fq8, int Ho, int Wo, int relu, void* stream) {
  const auto g = sm90::make_conv<T>(xs8, wcols, Hs8, Ws8, G, 4 * K, fq8, /*stride=*/1, /*pad=*/0);
  return sm90::launch_phases(g, b, y, N, Ho, Wo, K, relu, stream);
}

}  // namespace

// K: the output channels (wcols has 4K columns).
#define CONV_G8_ARGS                                                                            \
  const void *xs8, const void *wcols, const void *b, void *y, int N, int Hs8, int Ws8, int G, int K, \
      int fq8, int Ho, int Wo, int relu, void *stream
#define CONV_G8_PASS xs8, wcols, b, y, N, Hs8, Ws8, G, K, fq8, Ho, Wo, relu, stream

extern "C" int conv_g8_f32(CONV_G8_ARGS) { return launch<float>(CONV_G8_PASS); }

extern "C" int conv_g8_bf16(CONV_G8_ARGS) { return launch<port::bf16>(CONV_G8_PASS); }
