// The port's copy of csrc/test/test_threads.cpp (unchanged but for this line).
// Threaded stress test for the shared-state C API paths, intended to run
// under -fsanitize=thread (the race-detection tooling the reference lacked;
// its 3-thread init, reference: context.cpp:49-80, was never sanitized).
//
// Shared state exercised concurrently:
//   - one tokenizer used from all threads (tokenize is const / lock-free)
//   - the mutex-guarded global error table (errors.h) via failing calls
//     and get_last_error_extra_info reads
//   - error-description lookups
// Per-thread state: a DPM solver each (create/prepare/update/release churn).
//
// Exits non-zero on any cross-thread tokenization mismatch or unexpected
// status; TSan failures abort the process by themselves.
#include <atomic>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "sdtpu.h"

static const char* kPrompts[] = {
    "a photograph of an astronaut riding a horse",
    "the quick brown fox",
    "it's 123 things, isn't it?",
    "résumé café née 🚀",
    "",
};
static const int kNumPrompts = 5;
static const int kContext = 77;

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s ctokenizer.txt [threads] [iters]\n",
                 argv[0]);
    return 2;
  }
  const int threads = argc > 2 ? std::atoi(argv[2]) : 8;
  const int iters = argc > 3 ? std::atoi(argv[3]) : 200;

  sdtpu_tokenizer* tok = nullptr;
  if (sdtpu_tokenizer_create(argv[1], &tok) != SDTPU_NO_ERROR) {
    std::fprintf(stderr, "tokenizer create failed\n");
    return 1;
  }
  // golden ids, single-threaded
  std::vector<std::vector<int32_t>> golden(kNumPrompts,
                                           std::vector<int32_t>(kContext));
  for (int p = 0; p < kNumPrompts; ++p)
    if (sdtpu_tokenizer_tokenize(tok, kPrompts[p], kContext,
                                 golden[p].data()) != SDTPU_NO_ERROR)
      return 1;

  std::atomic<int> failures{0};
  auto worker = [&](int tid) {
    std::vector<int32_t> ids(kContext);
    sdtpu_dpm* dpm = nullptr;
    if (sdtpu_dpm_create(1000, 0.00085, 0.0120, &dpm) != SDTPU_NO_ERROR) {
      failures.fetch_add(1);
      return;
    }
    std::vector<float> x(16, 0.5f), eps(16, 0.1f);
    for (int it = 0; it < iters; ++it) {
      int p = (tid + it) % kNumPrompts;
      if (sdtpu_tokenizer_tokenize(tok, kPrompts[p], kContext, ids.data()) !=
              SDTPU_NO_ERROR ||
          std::memcmp(ids.data(), golden[p].data(),
                      kContext * sizeof(int32_t)) != 0) {
        failures.fetch_add(1);
        return;
      }
      // global error table: force a failure + read it back
      if (sdtpu_tokenizer_tokenize(tok, nullptr, kContext, ids.data()) ==
          SDTPU_NO_ERROR) {
        failures.fetch_add(1);
        return;
      }
      (void)sdtpu_get_last_error_extra_info(SDTPU_INVALID_ARGUMENT, nullptr);
      (void)sdtpu_get_error_description(SDTPU_RUNTIME_ERROR);
      // solver churn: out-of-order update must fail, ordered must succeed
      if (it % 50 == 0) {
        if (sdtpu_dpm_prepare(dpm, 4) != SDTPU_NO_ERROR) {
          failures.fetch_add(1);
          return;
        }
        for (int s = 0; s < 4; ++s)
          if (sdtpu_dpm_update(dpm, s, x.data(), eps.data(), x.size()) !=
              SDTPU_NO_ERROR) {
            failures.fetch_add(1);
            return;
          }
      }
    }
    sdtpu_dpm_release(dpm);
  };

  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker, t);
  for (auto& t : pool) t.join();
  sdtpu_tokenizer_release(tok);

  if (failures.load() != 0) {
    std::fprintf(stderr, "FAILED: %d worker failures\n", failures.load());
    return 1;
  }
  std::printf("OK threads=%d iters=%d\n", threads, iters);
  return 0;
}
