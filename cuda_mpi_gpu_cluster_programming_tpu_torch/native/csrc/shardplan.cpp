// Native shard-geometry planner.
//
// C++ counterpart of parallel/plan.py: the exact per-shard output-row
// ownership math (the corrected form of the reference's mapRangeStart/End,
// v4_mpi_cuda/src/alexnet_mpi_cuda.cu:27-38) plus the convOutDim/poolOutDim
// shape helpers (v2_mpi_only/2.2_scatter_halo/include/alexnet.hpp:35-44 with
// V4's degenerate-size guards, v4_mpi_cuda/include/alexnet.hpp:28-33). The
// reference keeps this host-side geometry logic in C++; so do we. The Python
// planner remains the source of truth the forward builders use; this library
// is the native tier for out-of-process tools, held field for field to the
// Python planner by the port's tests (tests/test_torch_sharded.py).

#include <algorithm>
#include <cstdint>

namespace {

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Mirrors ops/shapes.py conv_out_dim.
int sp_conv_out_dim(int d, int f, int p, int s) {
  if (d <= 0 || f <= 0 || s <= 0) return 0;
  if (f > d + 2 * p) return 0;
  return (d - f + 2 * p) / s + 1;
}

// Mirrors ops/shapes.py pool_out_dim.
int sp_pool_out_dim(int d, int f, int s) {
  if (d <= 0 || f <= 0 || s <= 0) return 0;
  if (f > d) return 0;
  return (d - f) / s + 1;
}

// Field-for-field mirror of parallel/plan.py LayerPlan (geometry fields only;
// name/kind strings live on the Python side).
struct sp_layer_plan {
  int32_t kind;  // 0 conv, 1 pool, 2 pointwise
  int32_t filter_size;
  int32_t stride;
  int32_t padding;
  int32_t l_in;
  int32_t l_out;
  int32_t b_in;
  int32_t b_out;
  int32_t h_top;
  int32_t h_bot;
  int32_t s0_coef;
  int32_t s0_const;
  int32_t win_rows;
  int32_t pad_bot;
};

enum {
  SP_OK = 0,
  SP_ERR_DEGENERATE = -1,   // layer output length <= 0
  SP_ERR_WINDOW = -2,       // uniform window escapes the padded buffer
  SP_ERR_BAD_ARG = -3,      // n_shards < 1 or unknown kind
};

// Mirrors parallel/plan.py _plan_spatial_layer (kind 0/1) and the pointwise
// branch of make_shard_plan (kind 2).
int sp_plan_layer(int kind, int l_in, int n, int f, int s, int p,
                  sp_layer_plan* out) {
  if (n < 1 || kind < 0 || kind > 2 || out == nullptr) return SP_ERR_BAD_ARG;
  if (kind == 2) {  // pointwise (LRN): block-identical geometry, no halo
    int b = ceil_div(l_in, n);
    *out = {2, 1, 1, 0, l_in, l_in, b, b, 0, 0, 0, 0, b, 0};
    return SP_OK;
  }
  int l_out = kind == 0 ? sp_conv_out_dim(l_in, f, p, s) : sp_pool_out_dim(l_in, f, s);
  if (l_out <= 0) return SP_ERR_DEGENERATE;
  if (kind == 1) p = 0;
  int b_in = ceil_div(l_in, n);
  int b_out = ceil_div(l_out, n);

  int h_top = 0, h_bot = 0;
  for (int i = 0; i < n; ++i) {
    int own_start = i * b_out;
    int own_end = std::min((i + 1) * b_out, l_out);
    if (own_start >= own_end) continue;  // shard owns nothing; stays masked
    int need_start = own_start * s - p;
    int need_end = (own_end - 1) * s - p + f;  // exclusive
    h_top = std::max(h_top, i * b_in - need_start);
    h_bot = std::max(h_bot, need_end - (i + 1) * b_in);
  }
  h_top = std::max(h_top, 0);
  h_bot = std::max(h_bot, 0);

  int s0_coef = b_out * s - b_in;
  int s0_const = h_top - p;
  int win_rows = (b_out - 1) * s + f;
  int pad_bot = 0;
  for (int i = 0; i < n; ++i) {
    int s0 = std::max(0, i * s0_coef + s0_const);
    pad_bot = std::max(pad_bot, s0 + win_rows - (h_top + b_in + h_bot));
  }
  for (int i = 0; i < n; ++i) {
    int s0 = i * s0_coef + s0_const;
    if (std::min((i + 1) * b_out, l_out) <= i * b_out) continue;
    if (s0 < 0 || s0 + win_rows > h_top + b_in + h_bot + pad_bot) return SP_ERR_WINDOW;
  }
  *out = {static_cast<int32_t>(kind), f, s, p, l_in, l_out, b_in, b_out,
          h_top,  h_bot, s0_coef, s0_const, win_rows, pad_bot};
  return SP_OK;
}

// Plan a chain of layers: layer i consumes layer i-1's l_out. kinds/fs/ss/ps
// are parallel arrays of length n_layers. Returns SP_OK or the first error.
int sp_plan_chain(int n_layers, const int32_t* kinds, const int32_t* fs,
                  const int32_t* ss, const int32_t* ps, int l0, int n_shards,
                  sp_layer_plan* out) {
  if (n_layers < 1 || !kinds || !fs || !ss || !ps || !out) return SP_ERR_BAD_ARG;
  int l_cur = l0;
  for (int i = 0; i < n_layers; ++i) {
    int rc = sp_plan_layer(kinds[i], l_cur, n_shards, fs[i], ss[i], ps[i], &out[i]);
    if (rc != SP_OK) return rc;
    l_cur = out[i].l_out;
  }
  return SP_OK;
}

// Global output rows shard i owns: the mapRangeStart/End analogue
// (v4_mpi_cuda/src/alexnet_mpi_cuda.cu:27-38), exact-ownership form.
void sp_owned_range(int b_out, int l_out, int i, int32_t* start, int32_t* end) {
  *start = i * b_out;
  *end = std::min((i + 1) * b_out, l_out);  // end < start => shard owns nothing
}

}  // extern "C"
