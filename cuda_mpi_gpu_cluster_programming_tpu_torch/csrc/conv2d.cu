// Direct convolution (cross-correlation) + bias + ReLU on NHWC/HWIO tensors:
// the "vcol" conv body.
//
// Replaces the TPU kernel _conv_vcol_kernel (cuda_mpi_gpu_cluster_programming_tpu/
// ops/pallas_kernels.py) with its epilogue _conv_epilogue, including the
// epilogue's hpool fusion and the k_block grid. It computes the same
// function without the TPU's space-to-depth repacking: strided reads are
// cheap here, so the kernel indexes the padded input directly.
//
// Shape of the work: an implicit GEMM (conv_engine.cuh). Rows are output
// pixels m = (n, oy, ox) (M = N*Ho*Wo), columns are output channels (K), and
// the reduction runs over kg = (fy*F + fx)*C + c (KG = F*F*C), which is
// exactly the row-major order of the HWIO weight tensor viewed as a (KG, K)
// matrix.
//
// Bound on the H100: operations. conv1 at batch 128 is 27 GFLOP against
// 0.23 GB of tensors, conv2 115 GFLOP against 0.11 GB, far above the card's
// ~20 FLOP/byte fp32 ridge. The fp32 contract forbids the TF32 tensor-core
// path, so the ceiling is FFMA. Design against that bound: the engine's
// tiles (every loaded input value feeds BN FMAs and every weight BM); the
// input gather here keeps a running (fy, fx, c) cursor per thread instead of
// dividing per element, and reads zero outside the padded image.
// bf16: operands are loaded as bf16 and widened; the accumulation is the same
// fp32 FFMA chain. No wgmma/TMA yet: a later tuning step.
#include "conv_engine.cuh"

namespace {

template <typename T>
struct DirectOp {
  using Elem = T;
  const T* x;
  const T* w;
  int K, KG;
  int H, W, C, F, stride, pad;

  struct Loader {
    const T* xn;
    int iy0, ix0, H, W, C, F;
    bool ok;
    int cy, cx, cc;  // (fy, fx, c) of the next reduction term

    __device__ __forceinline__ float next(bool valid) {
      float v = 0.f;
      const int iy = iy0 + cy;
      const int ix = ix0 + cx;
      if (ok && valid && iy >= 0 && iy < H && ix >= 0 && ix < W) {
        v = port::to_f32(xn[(static_cast<size_t>(iy) * W + ix) * C + cc]);
      }
      if (++cc == C) {
        cc = 0;
        if (++cx == F) {
          cx = 0;
          ++cy;
        }
      }
      return v;
    }
  };

  __device__ __forceinline__ Loader loader(bool ok, int n, int oy, int ox) const {
    return Loader{x + static_cast<size_t>(n) * H * W * C, oy * stride - pad, ox * stride - pad,
                  H, W, C, F, ok, 0, 0, 0};
  }
  __device__ __forceinline__ const T* row(int kg) const { return w + static_cast<size_t>(kg) * K; }
};

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int N, int H, int W, int C, int K,
           int F, int stride, int pad, int Ho, int Wo, int relu, int k_block, int pw, int ps, int Hp,
           void* stream) {
  const DirectOp<T> op{static_cast<const T*>(x), static_cast<const T*>(w), K, F * F * C,
                       H, W, C, F, stride, pad};
  return pw > 0 ? engine::launch_hpool(op, b, y, N, Wo, relu, pw, ps, Hp, stream)
                : engine::launch_tiles(op, b, y, N, Ho, Wo, relu, k_block, stream);
}

}  // namespace

// k_block: 0, or the output channels one block owns (K % k_block == 0).
// pw > 0: write the H-axis max of a pw / ps pool, (N, Hp, Wo, K).
#define CONV2D_ARGS                                                                     \
  const void *x, const void *w, const void *b, void *y, int N, int H, int W, int C, int K, \
      int F, int stride, int pad, int Ho, int Wo, int relu, int k_block, int pw, int ps,   \
      int Hp, void *stream
#define CONV2D_PASS x, w, b, y, N, H, W, C, K, F, stride, pad, Ho, Wo, relu, k_block, pw, ps, Hp, stream

extern "C" int conv2d_bias_relu_f32(CONV2D_ARGS) { return launch<float>(CONV2D_PASS); }

extern "C" int conv2d_bias_relu_bf16(CONV2D_ARGS) { return launch<port::bf16>(CONV2D_PASS); }
