// Native runtime helpers for cluster_anywhere_tpu.
//
// TPU-native analogue of the reference's C++ data-plane fast paths
// (src/ray/object_manager/plasma/ memcpy paths and the futex-style
// semaphores of experimental mutable objects,
// src/ray/core_worker/experimental_mutable_object_manager.h):
//
//  - ca_parallel_copy: multi-threaded memcpy for large object payloads
//    (plasma splits big copies across threads the same way).
//  - ca_wait_u64_ge / ca_store_u64_wake: cross-process futex wait/notify on
//    8-byte shared-memory words — the blocking primitive under the shm
//    channels (no spin-polling, microsecond wakeups).
//
// Built with: g++ -O3 -shared -fPIC -pthread (see build.py).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <thread>
#include <vector>

#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------- memcpy

// Copy n bytes with up to `max_threads` threads. Threading only pays off for
// large buffers; callers should gate on size (we also gate here).
void ca_parallel_copy(void* dst, const void* src, uint64_t n,
                      int max_threads) {
  constexpr uint64_t kMinPerThread = 4ull << 20;  // 4 MiB
  int nthreads = max_threads > 0 ? max_threads : 4;
  uint64_t want = (uint64_t)(n / kMinPerThread);
  if (want < (uint64_t)nthreads) nthreads = (int)want;
  if (nthreads <= 1 || n < 2 * kMinPerThread) {
    memcpy(dst, src, n);
    return;
  }
  uint64_t chunk = (n + nthreads - 1) / nthreads;
  std::vector<std::thread> ts;
  ts.reserve(nthreads - 1);
  for (int i = 1; i < nthreads; i++) {
    uint64_t off = (uint64_t)i * chunk;
    if (off >= n) break;
    uint64_t len = (off + chunk <= n) ? chunk : n - off;
    ts.emplace_back([=] { memcpy((char*)dst + off, (const char*)src + off, len); });
  }
  memcpy(dst, src, chunk <= n ? chunk : n);
  for (auto& t : ts) t.join();
}

// ----------------------------------------------------------------- futex

static long futex(uint32_t* uaddr, int op, uint32_t val,
                  const struct timespec* timeout) {
  return syscall(SYS_futex, uaddr, op, val, timeout, nullptr, 0);
}

// Wait until the u64 at `addr` (8-byte aligned, shared mapping) is >= min_val.
// timeout_ns < 0 means wait forever. Returns 0 on success, -1 on timeout.
//
// The futex sleeps on the LOW 32 bits (little-endian): every increment of the
// u64 changes them, so a sleeper is always woken by a publish.
int ca_wait_u64_ge(const volatile uint64_t* addr, uint64_t min_val,
                   int64_t timeout_ns) {
  auto* a = reinterpret_cast<const std::atomic<uint64_t>*>(
      const_cast<const uint64_t*>(addr));
  struct timespec deadline;
  if (timeout_ns >= 0) {
    clock_gettime(CLOCK_MONOTONIC, &deadline);
    deadline.tv_sec += timeout_ns / 1000000000ll;
    deadline.tv_nsec += timeout_ns % 1000000000ll;
    if (deadline.tv_nsec >= 1000000000l) {
      deadline.tv_sec += 1;
      deadline.tv_nsec -= 1000000000l;
    }
  }
  // brief spin first: channel handoffs are often sub-microsecond
  for (int i = 0; i < 64; i++) {
    if (a->load(std::memory_order_acquire) >= min_val) return 0;
#if defined(__x86_64__)
    __builtin_ia32_pause();
#else
    std::this_thread::yield();
#endif
  }
  while (true) {
    uint64_t v = a->load(std::memory_order_acquire);
    if (v >= min_val) return 0;
    struct timespec ts;
    const struct timespec* tp = nullptr;
    if (timeout_ns >= 0) {
      struct timespec now;
      clock_gettime(CLOCK_MONOTONIC, &now);
      int64_t ns = (deadline.tv_sec - now.tv_sec) * 1000000000ll +
                   (deadline.tv_nsec - now.tv_nsec);
      if (ns <= 0) return -1;
      ts.tv_sec = ns / 1000000000ll;
      ts.tv_nsec = ns % 1000000000ll;
      tp = &ts;
    }
    uint32_t low = (uint32_t)v;
    long rc = futex((uint32_t*)addr, FUTEX_WAIT, low, tp);
    if (rc == -1 && errno == ETIMEDOUT) return -1;
    // EAGAIN (value changed) / EINTR: loop and re-check
  }
}

// Release-store a u64 then wake all futex waiters on it.
void ca_store_u64_wake(volatile uint64_t* addr, uint64_t val) {
  auto* a = reinterpret_cast<std::atomic<uint64_t>*>(
      const_cast<uint64_t*>(addr));
  a->store(val, std::memory_order_release);
  futex((uint32_t*)addr, FUTEX_WAKE, INT32_MAX, nullptr);
}

// Wake all futex waiters WITHOUT storing — for close()-style nudges where a
// blind read-modify-store could roll back a concurrent publish.
void ca_wake_u64(volatile uint64_t* addr) {
  futex((uint32_t*)addr, FUTEX_WAKE, INT32_MAX, nullptr);
}

// Like ca_wait_u64_ge, but also watches a flag word: returns 2 as soon as
// (*flag_addr & flag_mask) != 0 (a close() that wakes this word is observed
// immediately instead of being re-slept through). 0 = value reached,
// -1 = timeout.
int ca_wait_u64_ge_flag(const volatile uint64_t* addr, uint64_t min_val,
                        const volatile uint64_t* flag_addr, uint64_t flag_mask,
                        int64_t timeout_ns) {
  auto* a = reinterpret_cast<const std::atomic<uint64_t>*>(
      const_cast<const uint64_t*>(addr));
  auto* fa = reinterpret_cast<const std::atomic<uint64_t>*>(
      const_cast<const uint64_t*>(flag_addr));
  struct timespec deadline;
  if (timeout_ns >= 0) {
    clock_gettime(CLOCK_MONOTONIC, &deadline);
    deadline.tv_sec += timeout_ns / 1000000000ll;
    deadline.tv_nsec += timeout_ns % 1000000000ll;
    if (deadline.tv_nsec >= 1000000000l) {
      deadline.tv_sec += 1;
      deadline.tv_nsec -= 1000000000l;
    }
  }
  for (int i = 0; i < 64; i++) {
    if (a->load(std::memory_order_acquire) >= min_val) return 0;
    if (fa->load(std::memory_order_acquire) & flag_mask) return 2;
#if defined(__x86_64__)
    __builtin_ia32_pause();
#else
    std::this_thread::yield();
#endif
  }
  while (true) {
    uint64_t v = a->load(std::memory_order_acquire);
    if (v >= min_val) return 0;
    if (fa->load(std::memory_order_acquire) & flag_mask) return 2;
    struct timespec ts;
    const struct timespec* tp = nullptr;
    if (timeout_ns >= 0) {
      struct timespec now;
      clock_gettime(CLOCK_MONOTONIC, &now);
      int64_t ns = (deadline.tv_sec - now.tv_sec) * 1000000000ll +
                   (deadline.tv_nsec - now.tv_nsec);
      if (ns <= 0) return -1;
      ts.tv_sec = ns / 1000000000ll;
      ts.tv_nsec = ns % 1000000000ll;
      tp = &ts;
    }
    futex((uint32_t*)addr, FUTEX_WAIT, (uint32_t)v, tp);
  }
}

// Plain acquire load (symmetry helper for the Python side).
uint64_t ca_load_u64(const volatile uint64_t* addr) {
  auto* a = reinterpret_cast<const std::atomic<uint64_t>*>(
      const_cast<const uint64_t*>(addr));
  return a->load(std::memory_order_acquire);
}

}  // extern "C"
