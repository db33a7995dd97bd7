// Paired-tap conv + bias + ReLU: the "pairs" conv body.
//
// Replaces the TPU kernels _conv_pairs_kernel (odd fq) and
// _conv_pairs_even_kernel (even fq), both over _pairs_acc
// (cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py), with
// _conv_epilogue. Operands, packed by the wrapper (ops/packing.py):
//   xpair (N, Hs, Ws-1, 2cs)  column j's and j+1's s2d channels side by side;
//   wpair (fq, m, 2cs, K)     taps (qh, 2p) and (qh, 2p+1) stacked, m = fq/2;
//   xs    (N, Hs, Ws, cs)     the plain s2d input  } odd fq only: the leftover
//   wlast (fq, cs, K)         tap qw = fq - 1      } tap; null for even fq.
// On the TPU a pair is one matmul with a 2cs-deep contraction. Here the
// reduction of each output runs in the TPU kernel's fixed order: qh outer,
// then the pairs left to right (2cs terms each, from xpair column ox + 2p),
// then the leftover (cs terms from xs column ox + fq - 1), one fmaf per
// term. That is the taps order term for term, so on this card "pairs" and
// "taps" give the same bits; the variant stays because the tuner sweeps it
// and its operands cost 2x the input bytes.
//
// Bound on the H100: operations (FFMA), as conv2d.cu. Design: the shared
// implicit-GEMM engine (conv_engine.cuh) with this operand policy; each
// weight row is found from kg by one division per staged slice.
#include "conv_engine.cuh"

namespace {

template <typename T>
struct PairsOp {
  using Elem = T;
  const T* xp;  // xpair
  const T* xs;  // null for even fq
  const T* wp;  // wpair
  const T* wl;  // wlast, null for even fq
  int K, KG;
  int Hs, Ws, cs, fq, m;

  struct Loader {
    const T* xp0;  // xpair at (n, oy, ox)
    const T* xs0;  // xs at (n, oy, ox + fq - 1), or null
    size_t xp_row, xs_row;  // one s2d row of each
    int cs, m, nseg;
    bool ok;
    int qh, seg, c;  // the next term: qh row, segment (pair, or m = leftover), channel

    __device__ __forceinline__ float next(bool valid) {
      float v = 0.f;
      const bool pair = seg < m;
      if (ok && valid) {
        v = port::to_f32(pair ? xp0[qh * xp_row + static_cast<size_t>(seg) * 4 * cs + c]
                              : xs0[qh * xs_row + c]);
      }
      if (++c == (pair ? 2 * cs : cs)) {
        c = 0;
        if (++seg == nseg) {
          seg = 0;
          ++qh;
        }
      }
      return v;
    }
  };

  __device__ __forceinline__ Loader loader(bool ok, int n, int oy, int ox) const {
    const size_t pix = static_cast<size_t>(n) * Hs + oy;
    return Loader{xp + (pix * (Ws - 1) + ox) * 2 * cs,
                  xs != nullptr ? xs + (pix * Ws + ox + fq - 1) * cs : nullptr,
                  static_cast<size_t>(Ws - 1) * 2 * cs, static_cast<size_t>(Ws) * cs,
                  cs, m, m + (xs != nullptr ? 1 : 0), ok, 0, 0, 0};
  }

  __device__ __forceinline__ const T* row(int kg) const {
    const int pairs = m * 2 * cs;
    const int per_qh = pairs + (wl != nullptr ? cs : 0);
    const int qh = kg / per_qh;
    const int j = kg - qh * per_qh;
    if (j < pairs) return wp + (static_cast<size_t>(qh) * pairs + j) * K;
    return wl + (static_cast<size_t>(qh) * cs + (j - pairs)) * K;
  }
};

template <typename T>
int launch(const void* xp, const void* xs, const void* wp, const void* wl, const void* b, void* y,
           int N, int Hs, int Ws, int cs, int K, int fq, int Ho, int Wo, int relu, void* stream) {
  const int m = fq / 2;
  const bool odd = fq % 2 != 0;
  if (odd != (xs != nullptr) || odd != (wl != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const PairsOp<T> op{static_cast<const T*>(xp), static_cast<const T*>(xs), static_cast<const T*>(wp),
                      static_cast<const T*>(wl), K, fq * (m * 2 * cs + (odd ? cs : 0)),
                      Hs, Ws, cs, fq, m};
  return engine::launch_tiles(op, b, y, N, Ho, Wo, relu, 0, stream);
}

}  // namespace

#define CONV_PAIRS_ARGS                                                                        \
  const void *xpair, const void *xs, const void *wpair, const void *wlast, const void *b, void *y, \
      int N, int Hs, int Ws, int cs, int K, int fq, int Ho, int Wo, int relu, void *stream
#define CONV_PAIRS_PASS xpair, xs, wpair, wlast, b, y, N, Hs, Ws, cs, K, fq, Ho, Wo, relu, stream

extern "C" int conv_pairs_f32(CONV_PAIRS_ARGS) { return launch<float>(CONV_PAIRS_PASS); }

extern "C" int conv_pairs_bf16(CONV_PAIRS_ARGS) { return launch<port::bf16>(CONV_PAIRS_PASS); }
