// Direct convolution (cross-correlation) + bias + ReLU on NHWC/HWIO tensors.
//
// Replaces the TPU kernel _conv_vcol_kernel (cuda_mpi_gpu_cluster_programming_tpu/
// ops/pallas_kernels.py) with its epilogue _conv_epilogue. It computes the same
// function without the TPU's space-to-depth repacking: strided reads are cheap
// here, so the kernel indexes the padded input directly.
//
// Shape of the work: an implicit GEMM. Rows are output pixels
// m = (n, oy, ox) (M = N*Ho*Wo), columns are output channels (K), and the
// reduction runs over kg = (fy*F + fx)*C + c (KG = F*F*C), which is exactly
// the row-major order of the HWIO weight tensor viewed as a (KG, K) matrix.
//
// Bound on the H100: operations. conv1 at batch 128 is 27 GFLOP against
// 0.23 GB of tensors, conv2 115 GFLOP against 0.11 GB, far above the card's
// ~20 FLOP/byte fp32 ridge. The fp32 contract forbids the TF32 tensor-core
// path, so the ceiling is FFMA. Design against that bound:
//   * a block owns a BM x BN output tile and walks the reduction in BK-wide
//     slices staged in shared memory (10 KB a block; no dynamic shared memory
//     needed), so every loaded input value feeds BN FMAs and every weight BM;
//   * each thread keeps a TM x TN register tile, 32 FMAs per 12 shared loads;
//   * the input gather keeps a running (fy, fx, c) cursor per thread instead
//     of dividing per element, and reads zero outside the padded image.
// Each output accumulates in fp32 with one fmaf per term in the fixed order
// kg = 0..KG-1. The epilogue adds the bias in fp32, applies ReLU (a NaN stays
// NaN, as with jnp.maximum) and casts once to the output type.
// bf16: operands are loaded as bf16 and widened; the accumulation is the same
// fp32 FFMA chain. No wgmma/TMA yet: a later tuning step.
#include "common.cuh"

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 32;   // output channels per block
constexpr int BK = 16;   // reduction terms staged per step
constexpr int TM = 8;    // pixels per thread
constexpr int TN = 4;    // channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 128
static_assert(THREADS == BM, "the A loader gives each thread one pixel row");
static_assert(BK * BN == 4 * THREADS, "the B loader gives each thread 4 weights");

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv2d_bias_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ bias, T* __restrict__ y, int N,
                        int H, int W, int C, int K, int F, int stride, int pad,
                        int Ho, int Wo, int relu) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int M = N * Ho * Wo;
  const int KG = F * F * C;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A loader: this thread's output pixel and the origin of its window.
  const int am = m0 + tid;
  const bool a_ok = am < M;
  int an = 0, aoy = 0, aox = 0;
  if (a_ok) {
    an = am / (Ho * Wo);
    const int r = am - an * Ho * Wo;
    aoy = r / Wo;
    aox = r - aoy * Wo;
  }
  const int iy0 = aoy * stride - pad;
  const int ix0 = aox * stride - pad;
  const T* xn = x + static_cast<size_t>(an) * H * W * C;
  int cy = 0, cx = 0, cc = 0;  // (fy, fx, c) of the next reduction term

  // B loader: one row of the slice, four neighbouring channels.
  const int b_row = tid / (BN / 4);
  const int b_col = (tid % (BN / 4)) * 4;

  // Compute mapping: a TM x TN register tile.
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < KG; k0 += BK) {
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float v = 0.f;
      const int iy = iy0 + cy;
      const int ix = ix0 + cx;
      if (a_ok && k0 + j < KG && iy >= 0 && iy < H && ix >= 0 && ix < W) {
        v = port::to_f32(xn[(static_cast<size_t>(iy) * W + ix) * C + cc]);
      }
      As[j][tid] = v;
      if (++cc == C) {
        cc = 0;
        if (++cx == F) {
          cx = 0;
          ++cy;
        }
      }
    }
    {
      const int kg = k0 + b_row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + b_col + j;
        Bs[b_row][b_col + j] =
            (kg < KG && n < K)
                ? port::to_f32(w[static_cast<size_t>(kg) * K + n])
                : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= K) continue;
      float v = acc[i][j] + port::to_f32(bias[n]);
      if (relu && v < 0.f) v = 0.f;
      y[static_cast<size_t>(m) * K + n] = port::from_f32<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int N, int H,
           int W, int C, int K, int F, int stride, int pad, int Ho, int Wo,
           int relu, void* stream) {
  const long long M = static_cast<long long>(N) * Ho * Wo;
  dim3 grid(port::blocks_for(M, BM), port::blocks_for(K, BN));
  conv2d_bias_relu_kernel<T><<<grid, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), N, H, W, C, K, F, stride,
      pad, Ho, Wo, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int conv2d_bias_relu_f32(const void* x, const void* w, const void* b,
                                    void* y, int N, int H, int W, int C, int K,
                                    int F, int stride, int pad, int Ho, int Wo,
                                    int relu, void* stream) {
  return launch<float>(x, w, b, y, N, H, W, C, K, F, stride, pad, Ho, Wo, relu,
                       stream);
}

extern "C" int conv2d_bias_relu_bf16(const void* x, const void* w,
                                     const void* b, void* y, int N, int H,
                                     int W, int C, int K, int F, int stride,
                                     int pad, int Ho, int Wo, int relu,
                                     void* stream) {
  return launch<port::bf16>(x, w, b, y, N, H, W, C, K, F, stride, pad, Ho, Wo,
                            relu, stream);
}
