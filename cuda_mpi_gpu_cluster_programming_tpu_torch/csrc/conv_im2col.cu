// im2col GEMM + bias + ReLU: the "fused" conv body.
//
// Replaces the TPU kernel _conv_fused_kernel (cuda_mpi_gpu_cluster_programming_tpu/
// ops/pallas_kernels.py) with _conv_epilogue. As in the JAX package, the
// im2col is tensor code outside the kernel (the wrapper, ops/packing.py):
//   xcol (M, KD)   M = N*Ho*Wo output pixels, KD = fq*fq*cs: the s2d
//                  windows of taps (qh, qw) concatenated in that order
//                  (conv1 432, conv2 2400);
//   w    (KD, K)   weights_to_depth(w) viewed as a matrix.
// The kernel is one tiled GEMM (M, KD) x (KD, K) with fp32 accumulation, one
// fmaf per term in kd order (the taps order, so the same bits as "taps"),
// and the shared bias/ReLU/cast epilogue. Each pixel's KD terms are one
// contiguous row of xcol: a thread's staged slice is 16 consecutive values.
//
// Bound on the H100: operations (FFMA). xcol adds traffic on top: at batch
// 128 about 0.67 GB (conv1) and 0.90 GB (conv2) in fp32, written by the
// packing and read once here, still far below the FFMA time. Design: the shared
// implicit-GEMM engine (conv_engine.cuh) with a plain row-major A operand.
#include "conv_engine.cuh"

namespace {

template <typename T>
struct Im2colOp {
  using Elem = T;
  const T* a;
  const T* w;
  int K, KG;
  int Ho, Wo;

  struct Loader {
    const T* p;
    bool ok;

    __device__ __forceinline__ float next(bool valid) {
      const float v = (ok && valid) ? port::to_f32(*p) : 0.f;
      ++p;
      return v;
    }
  };

  __device__ __forceinline__ Loader loader(bool ok, int n, int oy, int ox) const {
    return Loader{a + ((static_cast<size_t>(n) * Ho + oy) * Wo + ox) * KG, ok};
  }
  __device__ __forceinline__ const T* row(int kg) const { return w + static_cast<size_t>(kg) * K; }
};

template <typename T>
int launch(const void* a, const void* w, const void* b, void* y, int N, int Ho, int Wo, int KD, int K,
           int relu, void* stream) {
  const Im2colOp<T> op{static_cast<const T*>(a), static_cast<const T*>(w), K, KD, Ho, Wo};
  return engine::launch_tiles(op, b, y, N, Ho, Wo, relu, 0, stream);
}

}  // namespace

// xcol (N*Ho*Wo, KD), w (KD, K), b (K,) -> y (N*Ho*Wo, K).
#define CONV_IM2COL_ARGS                                                                     \
  const void *xcol, const void *w, const void *b, void *y, int N, int Ho, int Wo, int KD, int K, \
      int relu, void *stream
#define CONV_IM2COL_PASS xcol, w, b, y, N, Ho, Wo, KD, K, relu, stream

extern "C" int conv_im2col_f32(CONV_IM2COL_ARGS) { return launch<float>(CONV_IM2COL_PASS); }

extern "C" int conv_im2col_bf16(CONV_IM2COL_ARGS) { return launch<port::bf16>(CONV_IM2COL_PASS); }
