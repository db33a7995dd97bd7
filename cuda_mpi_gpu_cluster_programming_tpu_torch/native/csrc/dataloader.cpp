// Synthetic-data pipeline of the port's native tier.
//
// The JAX package's native/csrc/dataloader.cpp, copied: the C++ counterpart of
// the course code's host-side data initialization, as a batched,
// multi-threaded prefetching loader. Modes:
//
//   0 "ones":    every element 1.0f (the deterministic cross-version input).
//   1 "uniform": uniform [0,1) from a splitmix64-seeded LCG: the course code's
//                rand()/RAND_MAX input made reproducible.
//
// Batch k's contents depend only on (seed, k), never on thread interleaving:
// workers claim batch indices from an atomic counter and results are
// delivered strictly in index order. The stream is the JAX package's bit for
// bit, so `--input native` gives both packages one input.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// splitmix64 (public-domain construction) for seed mixing; 64-bit LCG
// (Knuth MMIX multiplier) for the stream; top 24 bits -> float32 [0,1).
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

inline uint64_t lcg_next(uint64_t s) {
  return s * 6364136223846793005ULL + 1442695040888963407ULL;
}

inline float lcg_float(uint64_t s) {
  return static_cast<float>(s >> 40) * (1.0f / 16777216.0f);
}

void fill(int mode, uint64_t seed, int64_t n, float* out) {
  if (mode == 0) {
    for (int64_t i = 0; i < n; ++i) out[i] = 1.0f;
    return;
  }
  uint64_t s = splitmix64(seed);
  for (int64_t i = 0; i < n; ++i) {
    s = lcg_next(s);
    out[i] = lcg_float(s);
  }
}

struct Loader {
  int mode;
  uint64_t seed;
  int64_t batch_elems;
  int depth;     // max finished batches buffered ahead of the consumer
  std::vector<std::thread> workers;

  std::mutex mu;
  std::condition_variable cv_produced;  // consumer waits for ready[next_out]
  std::condition_variable cv_space;     // workers wait for buffer space
  std::condition_variable cv_drained;   // destroyer waits for consumers to leave
  std::map<int64_t, std::vector<float>> ready;
  std::atomic<int64_t> next_claim{0};
  int64_t next_out = 0;
  int consumers_inside = 0;
  bool stopping = false;

  void worker() {
    for (;;) {
      int64_t k = next_claim.fetch_add(1);
      {
        // Admission control BEFORE filling, so at most `depth` batches are
        // ever finished-or-in-flight ahead of the consumer.
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] { return stopping || k < next_out + depth; });
        if (stopping) return;
      }
      std::vector<float> buf(static_cast<size_t>(batch_elems));
      // Per-batch stream: seed mixed with batch index -> order-independent.
      fill(mode, seed + 0x517cc1b727220a95ULL * static_cast<uint64_t>(k + 1),
           batch_elems, buf.data());
      std::unique_lock<std::mutex> lk(mu);
      if (stopping) return;
      ready.emplace(k, std::move(buf));
      cv_produced.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Synchronous fill — the parity-test surface and the non-prefetching path.
void dl_fill(int mode, uint64_t seed, int64_t n, float* out) {
  fill(mode, seed, n, out);
}

void* dl_create(int mode, uint64_t seed, int64_t batch_elems, int depth,
                int n_workers) {
  if (batch_elems <= 0 || depth < 1 || n_workers < 1 || mode < 0 || mode > 1)
    return nullptr;
  auto* L = new Loader();
  L->mode = mode;
  L->seed = seed;
  L->batch_elems = batch_elems;
  L->depth = depth;
  for (int i = 0; i < n_workers; ++i)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

// Copy the next batch (in strict index order) into out. Returns the batch
// index (>= 0), or -1 if the loader is stopping.
int64_t dl_next(void* handle, float* out) {
  auto* L = static_cast<Loader*>(handle);
  std::vector<float> buf;
  int64_t k;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    ++L->consumers_inside;  // dl_destroy waits for us to leave before delete
    L->cv_produced.wait(lk, [&] {
      return L->stopping || L->ready.count(L->next_out) > 0;
    });
    if (L->stopping) {
      if (--L->consumers_inside == 0) L->cv_drained.notify_all();
      return -1;
    }
    k = L->next_out;
    buf = std::move(L->ready[k]);
    L->ready.erase(k);
    L->next_out = k + 1;
    L->cv_space.notify_all();
    if (--L->consumers_inside == 0) L->cv_drained.notify_all();
  }
  std::memcpy(out, buf.data(), sizeof(float) * static_cast<size_t>(L->batch_elems));
  return k;
}

void dl_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->stopping = true;
    L->cv_space.notify_all();
    L->cv_produced.notify_all();
    // A consumer may still be blocked inside dl_next; deleting the mutex
    // under it is UB. Wait for every consumer to observe `stopping` and exit.
    L->cv_drained.wait(lk, [&] { return L->consumers_inside == 0; });
  }
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
