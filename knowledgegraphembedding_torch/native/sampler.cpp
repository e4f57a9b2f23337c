// Native negative sampling for the host-side data pipeline: the port's own
// copy of knowledgegraphembedding_tpu/native/sampler.cpp, with the same
// algorithm and generator, so a seed gives the same negatives in both
// packages.
//
// The reference runs its rejection sampler in torch DataLoader worker
// processes (reference: codes/dataloader.py §TrainDataset.__getitem__
// ≈L32-60, one numpy in1d loop per positive). Here the whole batch is
// sampled by one OpenMP-parallel C++ routine: per positive, draw uniform
// entity ids, reject ids whose (key, id) encoding binary-searches into the
// sorted train-true set, until n survive. Distribution is identical to the
// reference's (first n of iid uniform draws over non-true entities).
//
// Plain C interface, loaded with ctypes by native/__init__.py.

#include <cstdint>
#include <cstddef>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// splitmix64: seeding mixer
static inline uint64_t splitmix64(uint64_t &x) {
  uint64_t z = (x += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// xoshiro256** — fast, high-quality PRNG for the sampling hot loop
struct Xoshiro256 {
  uint64_t s[4];
  explicit Xoshiro256(uint64_t seed) {
    uint64_t x = seed;
    for (int i = 0; i < 4; ++i) s[i] = splitmix64(x);
  }
  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }
  inline uint64_t next() {
    const uint64_t result = rotl(s[1] * 5, 7) * 9;
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  // Lemire's nearly-divisionless unbiased bounded draw
  inline uint64_t bounded(uint64_t range) {
    uint64_t x = next();
    __uint128_t m = (__uint128_t)x * (__uint128_t)range;
    uint64_t l = (uint64_t)m;
    if (l < range) {
      uint64_t t = (0 - range) % range;
      while (l < t) {
        x = next();
        m = (__uint128_t)x * (__uint128_t)range;
        l = (uint64_t)m;
      }
    }
    return (uint64_t)(m >> 64);
  }
};

static inline bool contains(const int64_t *arr, int64_t n, int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = lo + ((hi - lo) >> 1);
    if (arr[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo < n && arr[lo] == v;
}

}  // namespace

extern "C" {

// Sample out[b, j] ~ Uniform({0..nentity-1} \ true_set(key_b)) iid.
// true_enc: sorted array of key*nentity + true_entity encodings.
// *draws: the candidates drawn over the batch, kept and rejected.
void kge_sample_negatives(const int64_t *true_enc, int64_t n_true,
                          const int64_t *row_keys, int64_t batch,
                          int64_t nentity, int64_t n_neg, uint64_t seed,
                          int32_t *out, int64_t *draws) {
  int64_t total = 0;
#if defined(_OPENMP)
#pragma omp parallel for reduction(+ : total) schedule(static)
#endif
  for (int64_t b = 0; b < batch; ++b) {
    Xoshiro256 rng(seed * 0x9e3779b97f4a7c15ULL + (uint64_t)b);
    const int64_t base = row_keys[b] * nentity;
    int32_t *row = out + b * n_neg;
    int64_t got = 0;
    while (got < n_neg) {
      int64_t cand = (int64_t)rng.bounded((uint64_t)nentity);
      ++total;
      if (!contains(true_enc, n_true, base + cand)) {
        row[got++] = (int32_t)cand;
      }
    }
  }
  *draws = total;
}

// Count how many of the candidate encodings hit the true set (test hook).
int64_t kge_count_members(const int64_t *true_enc, int64_t n_true,
                          const int64_t *cand_enc, int64_t n_cand) {
  int64_t hits = 0;
#if defined(_OPENMP)
#pragma omp parallel for reduction(+ : hits) schedule(static)
#endif
  for (int64_t i = 0; i < n_cand; ++i) {
    if (contains(true_enc, n_true, cand_enc[i])) ++hits;
  }
  return hits;
}

int kge_openmp_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// Wired to the reference's -cpu/--cpu_num flag (codes/run.py §parse_args).
void kge_set_threads(int n) {
#if defined(_OPENMP)
  if (n > 0) omp_set_num_threads(n);
#else
  (void)n;
#endif
}

}  // extern "C"
