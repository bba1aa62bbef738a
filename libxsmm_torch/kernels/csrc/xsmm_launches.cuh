// The launch log of one library. Each launch site calls note_launch with
// the kernel it launches, and xsmm_launch_log hands back the host address
// of every kernel launched so far with its count. The package's lowering
// text (lowering.py) resolves each address to its entry's mangled name, so
// a text names the instantiation that ran, not every instantiation of its
// kernel. kernels/_build.py hashes this header into the name of every
// library it builds.

#pragma once

#include <mutex>

namespace xsmm_log {
constexpr int CAP = 256;   // more than the entries of any one library
static std::mutex mu;
static const void* fn[CAP];
static long long count[CAP];
static int used = 0;
static bool full = false;
}  // namespace xsmm_log

template <typename... A>
static inline void note_launch(void (*kern)(A...)) {
  const void* f = reinterpret_cast<const void*>(kern);
  std::lock_guard<std::mutex> lock(xsmm_log::mu);
  for (int i = 0; i < xsmm_log::used; ++i) {
    if (xsmm_log::fn[i] == f) {
      ++xsmm_log::count[i];
      return;
    }
  }
  if (xsmm_log::used == xsmm_log::CAP) {
    xsmm_log::full = true;
    return;
  }
  xsmm_log::fn[xsmm_log::used] = f;
  xsmm_log::count[xsmm_log::used++] = 1;
}

// up to `cap` (host address, launches) pairs, in the order of their first
// launch; returns how many kernels were launched, or -1 when more were
// launched than the log holds
extern "C" int xsmm_launch_log(const void** fns, long long* counts,
                               int cap) {
  std::lock_guard<std::mutex> lock(xsmm_log::mu);
  if (xsmm_log::full) return -1;
  for (int i = 0; i < xsmm_log::used && i < cap; ++i) {
    fns[i] = xsmm_log::fn[i];
    counts[i] = xsmm_log::count[i];
  }
  return xsmm_log::used;
}
