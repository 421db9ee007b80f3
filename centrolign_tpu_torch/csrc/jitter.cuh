// Timing jitter for hunting races: JITTER(site) at each hand-off between
// threads, warps, blocks or launches of a kernel.
//
// In the plain build (no CENTROLIGN_JITTER) JITTER(site) is ((void)0): the
// kernels are the same machine code as without it. The jitter build
// (ops/_build.py, -DCENTROLIGN_JITTER=1, lib<name>_jit-<hash>.so) makes it
// a __nanosleep of h % max_ns nanoseconds, h a hash of a seed, the block,
// the warp, the site and a count of the site's calls, so each seeded run
// shifts every hand-off by another pseudo-random delay. A race that loses
// only under a rare interleaving then shows as an output that differs from
// the plain version's; a spin that can deadlock shows as a launch that
// does not end. The seed and max_ns are set on every card by
// centrolign_jitter_set, which only the jitter build exports; max_ns 0
// (the default) sleeps nothing.
#pragma once

#ifdef CENTROLIGN_JITTER

#include <cstdint>
#include <cuda_runtime.h>

namespace centrolign_jitter {

constexpr int kSites = 16;       // counters a site, one per block mod 32
__device__ unsigned long long g_seed;
__device__ unsigned int g_max_ns;
__device__ unsigned int g_count[kSites * 32];

__device__ __forceinline__ void sleep(int site) {
  const unsigned int max_ns = *(volatile unsigned int*)&g_max_ns;
  if (max_ns == 0) return;
  const unsigned int block =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const unsigned int n =
      atomicAdd(&g_count[(site % kSites) * 32 + (block & 31)], 1u);
  uint64_t h = g_seed ^ ((uint64_t)site << 56) ^ ((uint64_t)n << 24);
  h ^= (uint64_t)block * 0x9E3779B97F4A7C15ull;
  h ^= (uint64_t)(threadIdx.x >> 5) * 0xC2B2AE3D27D4EB4Full;
  // splitmix64's finaliser
  h ^= h >> 30;
  h *= 0xBF58476D1CE4E5B9ull;
  h ^= h >> 27;
  h *= 0x94D049BB133111EBull;
  h ^= h >> 31;
  __nanosleep((unsigned int)(h % max_ns));
}

}  // namespace centrolign_jitter

#define JITTER(site) centrolign_jitter::sleep(site)

// The seed and the largest sleep of every later launch of this library's
// kernels, on every card; the site counters start again from 0.
extern "C" int centrolign_jitter_set(unsigned long long seed,
                                     unsigned int max_ns) {
  int prev = 0, n = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaGetDeviceCount(&n);
  static const unsigned int zeros[centrolign_jitter::kSites * 32] = {};
  for (int d = 0; d < n && err == cudaSuccess; ++d) {
    err = cudaSetDevice(d);
    if (err == cudaSuccess)
      err = cudaMemcpyToSymbol(centrolign_jitter::g_seed, &seed,
                               sizeof(seed));
    if (err == cudaSuccess)
      err = cudaMemcpyToSymbol(centrolign_jitter::g_max_ns, &max_ns,
                               sizeof(max_ns));
    if (err == cudaSuccess)
      err = cudaMemcpyToSymbol(centrolign_jitter::g_count, zeros,
                               sizeof(zeros));
  }
  cudaSetDevice(prev);
  return (int)err;
}

#else

#define JITTER(site) ((void)0)

#endif
