// Paired-tap conv + bias + ReLU: the "pairs" conv body.
//
// Replaces the TPU kernels _conv_pairs_kernel (odd fq) and
// _conv_pairs_even_kernel (even fq), both over _pairs_acc
// (cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py), with
// _conv_epilogue. Operands, packed by the wrapper (ops/cuda_kernels.py
// _pairs_operands, over ops/packing.py):
//   xpair (N, Hs, Ws-1, 2cs)  column j's and j+1's s2d channels side by side;
//   wpair (fq, m, 2cs, K)     taps (qh, 2p) and (qh, 2p+1) stacked, m = fq/2;
//   xs    (N, Hs, Ws, cs)     the plain s2d input  } odd fq only: the leftover
//   wlast (fq, cs, K)         tap qw = fq - 1      } tap; null for even fq.
// On the TPU a pair is one matmul with a 2cs-deep contraction. Here the
// reduction of each output runs in the TPU kernel's fixed order: qh outer,
// then the pairs left to right (2cs terms each, from xpair column ox + 2p),
// then the leftover (cs terms from xs column ox + fq - 1). That is the taps
// order, and im2col's xcol order, term for term, with the same weight rows:
// so pairs gives the bits of conv_im2col.cu in both dtypes (the same A row,
// B column and k-steps), of conv2d.cu at stride 1 (where the s2d order is
// vcol's) and, in fp32, of conv_taps.cu (one fmaf chain in kg order).
//
// Bound on the H100: operations, as conv2d.cu (FFMA in fp32, the tensor
// cores in bf16); the pair operands cost 2x the input bytes. Design: the
// Hopper mainloop of conv_sm90.cuh with its Pairs operand (two pixel
// origins, into xpair and xs; a (qh, segment, channel) map a 16-byte run;
// wpair's and wlast's rows by kg), one 128 x 128 tile of 256 threads.
#include "conv_sm90.cuh"

namespace {

template <typename T>
int launch(const void* xp, const void* xs, const void* wp, const void* wl, const void* b, void* y,
           int N, int Hs, int Ws, int cs, int K, int fq, int Ho, int Wo, int relu, void* stream) {
  const bool odd = fq % 2 != 0;
  if (fq < 2 || odd != (xs != nullptr) || odd != (wl != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const auto g = sm90::make_pairs<T>(xp, xs, wp, wl, Hs, Ws, cs, fq, K);
  return sm90::launch_tiles_cfg<sm90::Cfg<T, 128, 128>>(g, b, y, N, Ho, Wo, relu,
                                                        static_cast<cudaStream_t>(stream));
}

}  // namespace

#define CONV_PAIRS_ARGS                                                                        \
  const void *xpair, const void *xs, const void *wpair, const void *wlast, const void *b, void *y, \
      int N, int Hs, int Ws, int cs, int K, int fq, int Ho, int Wo, int relu, void *stream
#define CONV_PAIRS_PASS xpair, xs, wpair, wlast, b, y, N, Hs, Ws, cs, K, fq, Ho, Wo, relu, stream

extern "C" int conv_pairs_f32(CONV_PAIRS_ARGS) { return launch<float>(CONV_PAIRS_PASS); }

extern "C" int conv_pairs_bf16(CONV_PAIRS_ARGS) { return launch<port::bf16>(CONV_PAIRS_PASS); }
