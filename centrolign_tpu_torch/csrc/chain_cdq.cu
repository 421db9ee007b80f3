// SparseAffine chain-DP value scan on chain x chain inputs (sm_90a).
//
// chain_cdq_level_kernel replaces the lax.scan of centrolign_tpu/ops/
// chain_cdq.py::_cdq_scan: N dependent steps over the anchors in
// start-position order. Step t takes, over the anchors i published before it
// whose ends precede its start on both chains (pe1_i < ps1_t, pe2_i <
// ps2_t), the maxima of 7 channels: the gap-free channel (dp_i, anchors of
// the same shift) and the 6 piecewise channels (anchors of a larger shift
// for pw = 0, 2, 4, of a smaller one for pw = 1, 3, 5), each with its first
// index and the count of entries equal to it. One thread folds the 7 maxima
// in the reference's order and rounding, value = (f32)((f64)(f32)(v + w) -
// fc[pw]), and publishes row t: dp_t and the channel values
// (f32)((f64)dp_t -/+ cs[k]). The layout, the level schedule and the plain
// version are in ops/chain_cdq.py.
//
// The schedule. Most steps do not depend on one another: the level of row
// j is 1 + the largest level of a row i < j with pe1_i < ps1_j, the levels
// never fall in sorted order, and every query of a level reads only rows of
// lower levels, rows [0, q0) of the level [q0, q1) (ops/chain_cdq.py;
// native/chain_levels.cpp makes it on the host in O(N log N)). The kernel
// makes one step per level, not per anchor: benchdata/pair.fasta's 145,331
// anchors fall into 1,479 levels of 98 queries on average. It is exact: a
// row of the same level never passes a query's mask, rows after a query
// hold -FLT_MAX until their level is published, as in the sequential scan,
// and the reduction that combines partial results (greater wins; on equal
// values the lower index wins and the counts add) is associative and
// commutative, so any split of the rows gives the same triple. Without
// `prefix` (anchors that end before they start) every step scans all N
// rows, the unpublished ones at -FLT_MAX, as the JAX scan does.
//
// The design: one persistent launch of one block of 1,024 threads per SM
// runs every level of every problem of the batch, the problems one after
// the other. It is a cooperative launch (every block resident, checked
// against the occupancy API first; a launch that cannot be made returns an
// error and the wrapper raises) with a barrier on a global counter between
// phases; a CUDA graph of launches per level would pay a launch per level
// instead of a barrier. Each level, in chunks of at most `part_queries`
// queries:
//  1. stage: the rows to scan, [0, q0) with `prefix`, are cut into one
//     contiguous chunk per block; each block copies its chunk into shared
//     memory by cp.async (the 16-byte keys and both 16-byte sides of each
//     published row, 48 bytes a row, up to `stage_rows` rows at a time);
//  2. partials: the block's threads take the level's queries, each query
//     over `width` threads that split the chunk (width = 1,024 / the
//     queries rounded up to a power of two, so a level of 15 queries still
//     keeps every thread busy); the rows are read from shared memory as
//     broadcasts, each (query, channel) keeps its (max, first index, count)
//     in registers, and a warp butterfly (and shared memory past a warp)
//     makes one partial per query and channel per block;
//  3. barrier; fold and publish: a warp per query, the queries spread over
//     the blocks, merges the blocks' partials; its lane 0 folds them in the
//     reference's order and publishes the row; barrier.
// The table and the partials move between SMs through L2 only (cp.async.cg,
// __ldcg, release/acquire on the barrier). The f32/f64 arithmetic is
// written with _rn intrinsics so that nvcc cannot contract or reorder it,
// and maxima are taken by '>'.
//
// What bounds it on an H100: at the pair's size each level stages its
// lower rows from L2 once (about 108 M rows, 5 GB, over the launch),
// makes about 1.06e10 query x row tests over the 132 SMs, and pays two
// grid barriers, 2,959 in all. Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py, phase 8): 75.7 ms for the pair's 145,331 anchors,
// about 51 us a level (5,093 ms for the one-block loop before it). The
// tests and their reduction take about 35 us of a level and the barriers
// with the folds between them most of the rest (clock64 counters in a
// scratch build). Spreading the folds over the blocks took it from 96 to
// 76 ms; neither branch-free maxima nor 512 threads without register
// spills helped.

#include <cuda_runtime.h>

// JITTER(site) marks a hand-off between threads, warps, blocks or
// launches, which the jitter build delays (jitter.cuh); nothing in the
// plain build.
#include "jitter.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kChannels = 7;
constexpr int kRowBytes = 48;
constexpr float kNegF = -3.40282346638528859811704183484516925e+38f;  // -FLT_MAX

struct Best {
  float v;
  int idx;
  int cnt;
};

__device__ __forceinline__ Best empty_best() {
  return Best{-__int_as_float(0x7f800000), 0x7fffffff, 0};
}

// one candidate, in ascending index order within a thread
__device__ __forceinline__ void take(Best& a, float x, int i) {
  if (x > a.v) {
    a.v = x;
    a.idx = i;
    a.cnt = 1;
  } else if (x == a.v) {
    if (a.cnt == 0) a.idx = i;
    a.cnt += 1;
  }
}

__device__ __forceinline__ void merge(Best& a, float v, int idx, int cnt) {
  if (v > a.v) {
    a.v = v;
    a.idx = idx;
    a.cnt = cnt;
  } else if (v == a.v) {
    a.idx = min(a.idx, idx);
    a.cnt += cnt;
  }
}

// butterfly over the aligned groups of `width` lanes (a power of two up to
// 32); every lane of a group ends with the group's triple
__device__ __forceinline__ void lane_merge(Best (&b)[kChannels], int width) {
  for (int o = width >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      const float v = __shfl_xor_sync(0xffffffffu, b[c].v, o);
      const int idx = __shfl_xor_sync(0xffffffffu, b[c].idx, o);
      const int cnt = __shfl_xor_sync(0xffffffffu, b[c].cnt, o);
      merge(b[c], v, idx, cnt);
    }
  }
}

// row i on its side of qshift: gt = (channels 1, 3, 5, dp) for a larger
// shift (pw = 0, 2, 4), lt = (channels 2, 4, 6, dp) for a smaller one
// (pw = 1, 3, 5); dp also serves the gap-free channel
__device__ __forceinline__ void consider(Best (&b)[kChannels], int4 k,
                                         float4 r, int i, int ps1, int ps2,
                                         int qs) {
  if (k.x < ps1 && k.y < ps2 && k.w != 0) {
    if (k.z == qs) {
      take(b[0], r.w, i);
    } else if (k.z > qs) {  // constant indices keep b in registers
      take(b[1], r.x, i);
      take(b[3], r.y, i);
      take(b[5], r.z, i);
    } else {
      take(b[2], r.x, i);
      take(b[4], r.y, i);
      take(b[6], r.z, i);
    }
  }
}

__device__ __forceinline__ void publish(float4* gt, float4* lt, int t,
                                        float dp, const double* cs) {
  const double d = (double)dp;
  float lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = __double2float_rn(__dsub_rn(d, cs[k]));
    hi[k] = __double2float_rn(__dadd_rn(d, cs[k]));
  }
  gt[t] = make_float4(lo[0], lo[1], lo[2], dp);
  lt[t] = make_float4(hi[0], hi[1], hi[2], dp);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// every block of the grid arrives; `epoch` counts the arrivals to wait for
__device__ __forceinline__ void grid_barrier(unsigned long long* bar,
                                             unsigned long long& epoch) {
  epoch += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    JITTER(0);
    __threadfence();
    atomicAdd(bar, 1ull);
    JITTER(1);
    unsigned long long seen;
    do {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                   : "=l"(seen)
                   : "l"(bar)
                   : "memory");
    } while (seen < epoch);
    __threadfence();
  }
  __syncthreads();
}

// rows [c0, c1) of a problem into shared memory
__device__ __forceinline__ void stage(int4* s_key, float4* s_gt,
                                      float4* s_lt, const int4* key,
                                      const float4* gt, const float4* lt,
                                      int c0, int c1) {
  for (int i = threadIdx.x; i < c1 - c0; i += kThreads) {
    cp_async16(&s_key[i], &key[c0 + i]);
    cp_async16(&s_gt[i], &gt[c0 + i]);
    cp_async16(&s_lt[i], &lt[c0 + i]);
  }
  cp_async_wait_all();
  JITTER(2);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
    chain_cdq_level_kernel(const int4* __restrict__ key,
                           const int4* __restrict__ step,
                           const float2* __restrict__ wi,
                           const double* __restrict__ fc,
                           const double* __restrict__ cs,
                           const int* __restrict__ prefix,
                           const int4* __restrict__ levels, int n_levels,
                           float4* table, int4* part, int part_queries,
                           unsigned long long* bar, float* out_dp,
                           int* out_bp, uint8_t* out_tie,
                           uint8_t* out_struct, float* out_stored, int B,
                           int N, int stage_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* s_key = (int4*)smem;
  float4* s_gt = (float4*)(s_key + stage_rows);
  float4* s_lt = s_gt + stage_rows;
  __shared__ Best red[kWarps][kChannels];
  const int G = gridDim.x, g = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t stride = (size_t)G * kThreads;
  unsigned long long epoch = 0;

  // every table entry -FLT_MAX; every row's outputs those of a row without
  // a query (the padding rows keep them)
  const size_t rows = (size_t)B * N;
  const float4 neg4 = make_float4(kNegF, kNegF, kNegF, kNegF);
  for (size_t i = (size_t)g * kThreads + tid; i < 2 * rows; i += stride)
    table[i] = neg4;
  for (size_t i = (size_t)g * kThreads + tid; i < rows; i += stride) {
    out_dp[i] = wi[i].y;
    out_bp[i] = -1;
    out_tie[i] = 0;
    out_struct[i] = 255;
    out_stored[i] = kNegF;
  }
  grid_barrier(bar, epoch);

  for (int L = 0; L < n_levels; ++L) {
    const int4 lv = levels[L];  // (b, q0, q1, index of the level)
    const size_t base = (size_t)lv.x * N;
    const int4* key_b = key + base;
    const int4* step_b = step + base;
    float4* gt = table + 2 * base;
    float4* lt = gt + N;
    const int lim = prefix[lv.x] ? lv.y : N;
    const int chunk = (lim + G - 1) / G;
    const int active = chunk ? (lim + chunk - 1) / chunk : 0;
    const int r0 = g * chunk, r1 = min(lim, r0 + chunk);
    const bool once = r1 - r0 <= stage_rows;
    if (g < active && once) stage(s_key, s_gt, s_lt, key_b, gt, lt, r0, r1);

    for (int a0 = lv.y; a0 < lv.z; a0 += part_queries) {
      const int a1 = min(lv.z, a0 + part_queries);
      if (g < active) {
        for (int p0 = a0; p0 < a1; p0 += kThreads) {
          const int nq = min(a1 - p0, kThreads);
          const int shift = 31 - __clz(kThreads >> (32 - __clz(nq - 1)));
          const int width = 1 << shift;  // threads a query
          const int qi = tid >> shift, s = tid & (width - 1);
          const int t = p0 + qi;
          int4 st = make_int4(0, 0, 0, 0);  // (ps1, ps2, qshift, has_query)
          if (qi < nq) st = __ldg(&step_b[t]);
          Best b[kChannels];
#pragma unroll
          for (int c = 0; c < kChannels; ++c) b[c] = empty_best();
          for (int c0 = r0; c0 < r1; c0 += stage_rows) {
            const int c1 = min(r1, c0 + stage_rows);
            if (!once) {
              JITTER(3);
              __syncthreads();  // the last rows' readers are done
              stage(s_key, s_gt, s_lt, key_b, gt, lt, c0, c1);
            }
            if (st.w != 0) {
              for (int i = s; i < c1 - c0; i += width) {
                const int4 k = s_key[i];
                const float4 r = k.z > st.z ? s_gt[i] : s_lt[i];
                consider(b, k, r, c0 + i, st.x, st.y, st.z);
              }
            }
          }
          lane_merge(b, min(width, 32));
          if (width > 32) {
            if (lane == 0) {
#pragma unroll
              for (int c = 0; c < kChannels; ++c) red[warp][c] = b[c];
            }
            __syncthreads();
            if (s == 0) {
              for (int w = warp + 1; w < warp + (width >> 5); ++w) {
#pragma unroll
                for (int c = 0; c < kChannels; ++c)
                  merge(b[c], red[w][c].v, red[w][c].idx, red[w][c].cnt);
              }
            }
            __syncthreads();  // red is free for the next pass
          }
          if (s == 0 && qi < nq) {
            int4* out = part + ((size_t)g * part_queries + (t - a0)) *
                                   kChannels;
#pragma unroll
            for (int c = 0; c < kChannels; ++c)
              __stcg(&out[c], make_int4(__float_as_int(b[c].v), b[c].idx,
                                        b[c].cnt, 0));
          }
        }
      }
      if (active > 0) grid_barrier(bar, epoch);

      // fold and publish: a warp per query, the queries spread over the
      // blocks (the partials of a level's queries are read by as many SMs)
      for (int qi = g + G * warp; qi < a1 - a0; qi += G * kWarps) {
        const int t = a0 + qi;
        const int4 st = __ldg(&step_b[t]);
        Best b[kChannels];
#pragma unroll
        for (int c = 0; c < kChannels; ++c) b[c] = empty_best();
        if (st.w != 0) {
          for (int blk = lane; blk < active; blk += 32) {
            const int4* in = part + ((size_t)blk * part_queries + qi) *
                                        kChannels;
#pragma unroll
            for (int c = 0; c < kChannels; ++c) {
              const int4 x = __ldcg(&in[c]);
              merge(b[c], __int_as_float(x.x), x.y, x.z);
            }
          }
          lane_merge(b, 32);
        }
        if (lane == 0) {
          const float2 w_init = wi[base + t];
          const double* fc_t = fc + (base + t) * 6;
          float best = w_init.y, stored = kNegF;
          int bp = -1, tie = 0, strct = 255;
          // fold order: gap-free, then pw = 0..5 (anchorer.hpp:2381-2420)
#pragma unroll
          for (int c = 0; c < kChannels; ++c) {
            float value = __fadd_rn(b[c].v, w_init.x);
            if (c > 0)
              value = __double2float_rn(__dsub_rn((double)value, fc_t[c - 1]));
            if (b[c].cnt > 0 && value > best) {
              best = value;
              bp = b[c].idx;
              tie = b[c].cnt > 1;
              strct = c;
              stored = b[c].v;
            }
          }
          out_dp[base + t] = best;
          out_bp[base + t] = bp;
          out_tie[base + t] = (uint8_t)tie;
          out_struct[base + t] = (uint8_t)strct;
          out_stored[base + t] = stored;
          publish(gt, lt, t, best, cs + (base + t) * 3);
        }
      }
      grid_barrier(bar, epoch);
    }
  }
}

}  // namespace

extern "C" int chain_cdq_scan_launch(
    const int* key, const int* step, const float* wi, const double* fc,
    const double* cs, const int* prefix, const int* levels, int n_levels,
    float* table, int* part, int part_queries, unsigned long long* bar,
    float* dp, int* bp, uint8_t* tie, uint8_t* strct, float* stored,
    int n_problems, int n, int blocks, int stage_rows, void* stream) {
  if (n_problems < 0 || n < 0 || n_levels < 0 || part_queries < 1 ||
      blocks < 1 || stage_rows < 1)
    return (int)cudaErrorInvalidValue;
  if (n_problems == 0 || n == 0) return 0;
  const long long smem = (long long)stage_rows * kRowBytes;
  if (smem > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      chain_cdq_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // every block must be resident at once for the grid barrier
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, chain_cdq_level_kernel, kThreads, (size_t)smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1 || blocks > per_sm * sms)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  const int4* key4 = (const int4*)key;
  const int4* step4 = (const int4*)step;
  const float2* wi2 = (const float2*)wi;
  const int4* levels4 = (const int4*)levels;
  float4* table4 = (float4*)table;
  int4* part4 = (int4*)part;
  void* args[] = {&key4,  &step4,        &wi2,    &fc,     &cs,
                  &prefix, &levels4,     &n_levels, &table4, &part4,
                  &part_queries, &bar,   &dp,     &bp,     &tie,
                  &strct, &stored,       &n_problems, &n,  &stage_rows};
  err = cudaLaunchCooperativeKernel((const void*)chain_cdq_level_kernel,
                                    dim3(blocks), dim3(kThreads), args,
                                    (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
