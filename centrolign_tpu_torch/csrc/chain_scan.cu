// Free-gap sparse chaining's event scan on chain x chain inputs (sm_90a).
//
// chain_scan_level_kernel replaces the lax.scan of centrolign_tpu/ops/
// chain_scan.py::_event_scan: E dependent events over a value table of
// n_slots f32 slots. An insert stores its anchor's dp at its slot; a query
// takes the leftmost maximum of the table below its bound hi and, when it
// beats -FLT_MAX and cand = best + w beats the anchor's dp, sets dp to cand
// and records the winning slot (else -1). The event layout, the level
// schedule and the plain version are in ops/chain_scan.py; the host keeps
// the tie resolution and the traceback.
//
// The schedule. A query with hi > 0 sits one level above every insert
// before it, an insert has the level of its slot's query when that query
// came first (else 0: it stores the initial dp), and the levels never fall
// along the stream, so a level is a run of consecutive queries
// (native/chain_levels.cpp, O(E) on the host). benchdata/pair.fasta's
// 145,331 queries fall into 1,479 levels, its calibrations' 24,025 and
// 22,506 into about 1,500 each. A level-L query takes the leftmost maximum
// over the slots s < hi whose insert event precedes its own: each was
// written in a lower level and holds the value the sequential scan reads;
// a slot inserted later holds -FLT_MAX there and never wins, so the test
// on the insert's event index excludes it. A slot is a row of 8 bytes,
// (value, index of its insert event); the table starts as dp0, and a
// query's fold writes its slot's value when the insert comes after it.
//
// The design, as in csrc/chain_cdq.cu: one cooperative launch of one block
// of 1,024 threads per SM (every block resident, checked against the
// occupancy API first; the wrapper raises when the launch cannot be made),
// a barrier on a global counter between phases. Each level, in chunks of
// at most `part_queries` queries: the slots [0, max hi of the level) are
// cut into one contiguous chunk per block and staged into shared memory by
// cp.async (up to `stage_rows` slots at a time); each query of the level
// is tested against the staged slots by `width` threads that split the
// chunk, reading the slots as broadcasts and keeping (max, first slot); a
// warp butterfly (and shared memory past a warp) makes one partial per
// query per block; barrier; a warp per query, the queries spread over the
// blocks, merges the blocks' partials (greater wins, on equal values the
// lower slot), its lane 0 updates dp and the winner and writes the slot's
// value when its insert comes later (the query's event, dp and insert
// event loaded before the barrier); barrier. The table, dp and the
// partials move between SMs through L2 only (cp.async.cg, __ldcg,
// release/acquire on the barrier).
//
// What bounds it on an H100: about 1,500 levels of two grid barriers
// each, with the staging and the fold between them: the latency of a few
// round trips to L2 a level, not bytes or operations. Measured on an H100
// 80GB HBM3 at 700 W (chip_smoke.py, phase 8): 8.8 and 8.3 ms for the
// calibrations (about 5.6 us a level) and 18.3 ms for the pair's 145,331
// anchors (about 12.4 us a level), from 31, 28 and 466 ms for the
// one-block loop before it.

#include <cuda_runtime.h>

// JITTER(site) marks a hand-off between threads, warps, blocks or
// launches, which the jitter build delays (jitter.cuh); nothing in the
// plain build.
#include "jitter.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSlotBytes = 8;
constexpr float kNegF = -3.40282346638528859811704183484516925e+38f;  // -FLT_MAX
constexpr int kNone = 0x7fffffff;

__device__ __forceinline__ void merge(float& v, int& idx, float ov, int oi) {
  if (ov > v || (ov == v && oi < idx)) {
    v = ov;
    idx = oi;
  }
}

// butterfly over the aligned groups of `width` lanes (a power of two up to
// 32)
__device__ __forceinline__ void lane_merge(float& v, int& idx, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
    merge(v, idx, ov, oi);
  }
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

// slots [c0, c1) into shared memory, c0 even: 16 bytes (two slots) a copy;
// the slot table has a spare slot past the last, so the copy may read one
// slot beyond c1
__device__ __forceinline__ void stage(int2* s_row, const int2* row, int c0,
                                      int c1) {
  const int units = (c1 - c0 + 1) >> 1;
  for (int u = threadIdx.x; u < units; u += kThreads)
    cp_async16(&s_row[2 * u], &row[c0 + 2 * u]);
  cp_async_wait_all();
  JITTER(2);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
    chain_scan_level_kernel(const int4* __restrict__ ev,
                            const int4* __restrict__ steps, int n_steps,
                            const int* __restrict__ queries, float* dp,
                            int2* row, int2* part, int part_queries,
                            unsigned long long* bar, int* winner, int E,
                            int n_slots, int stage_rows) {
  extern __shared__ __align__(16) int2 s_row[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  const int G = gridDim.x, g = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int stride = G * kThreads;
  unsigned long long epoch = 0;

  // the table: dp0, no insert yet (the spare slots: -FLT_MAX, never
  // inserted); no winner
  for (int s = g * kThreads + tid; s < n_slots + 2; s += stride)
    row[s] = make_int2(__float_as_int(s < n_slots ? dp[s] : kNegF), kNone);
  for (int e = g * kThreads + tid; e < E; e += stride) winner[e] = -1;
  grid_barrier(bar, epoch);
  for (int e = g * kThreads + tid; e < E; e += stride) {
    const int4 x = __ldg(&ev[e]);  // (kind, slot, hi, weight bits)
    if (x.x == 1) row[x.y].y = e;
  }
  grid_barrier(bar, epoch);

  for (int L = 0; L < n_steps; ++L) {
    const int4 lv = steps[L];  // (q0, q1, hi, level)
    const int lim = lv.z;
    const int chunk = ((lim + G - 1) / G + 1) & ~1;  // even: 16-byte copies
    const int active = chunk ? (lim + chunk - 1) / chunk : 0;
    const int r0 = g * chunk, r1 = min(lim, r0 + chunk);
    const bool once = r1 - r0 <= stage_rows;
    if (g < active && once) stage(s_row, row, r0, r1);

    for (int a0 = lv.x; a0 < lv.y; a0 += part_queries) {
      const int a1 = min(lv.y, a0 + part_queries);
      if (g < active) {
        for (int p0 = a0; p0 < a1; p0 += kThreads) {
          const int nq = min(a1 - p0, kThreads);
          const int shift = 31 - __clz(kThreads >> (32 - __clz(nq - 1)));
          const int width = 1 << shift;  // threads a query
          const int qi = tid >> shift, s = tid & (width - 1);
          int e = 0, hi = 0;
          if (qi < nq) {
            e = __ldg(&queries[p0 + qi]);
            hi = __ldg(&ev[e]).z;
          }
          float v = kNegF;
          int idx = kNone;
          for (int c0 = r0; c0 < r1; c0 += stage_rows) {
            const int c1 = min(r1, c0 + stage_rows);
            if (!once) {
              JITTER(3);
              __syncthreads();  // the last slots' readers are done
              stage(s_row, row, c0, c1);
            }
            const int end = min(c1, hi) - c0;
            for (int i = s; i < end; i += width) {
              const int2 x = s_row[i];
              const float val = __int_as_float(x.x);
              if (x.y < e && val > v) {
                v = val;
                idx = c0 + i;
              }
            }
          }
          lane_merge(v, idx, min(width, 32));
          if (width > 32) {
            if (lane == 0) {
              red_v[warp] = v;
              red_i[warp] = idx;
            }
            __syncthreads();
            if (s == 0) {
              for (int w = warp + 1; w < warp + (width >> 5); ++w)
                merge(v, idx, red_v[w], red_i[w]);
            }
            __syncthreads();  // red is free for the next pass
          }
          if (s == 0 && qi < nq)
            __stcg(&part[(size_t)g * part_queries + (p0 + qi - a0)],
                   make_int2(__float_as_int(v), idx));
        }
      }
      // the fold's inputs that no partial changes, loaded before the
      // barrier: this warp's first query of the chunk, its event, its
      // slot's dp and insert event
      const int qf = g + G * warp;
      int fe = 0, fins = 0;
      int4 fx = make_int4(0, 0, 0, 0);
      float fdp = 0.f;
      if (lane == 0 && qf < a1 - a0) {
        fe = __ldg(&queries[a0 + qf]);
        fx = __ldg(&ev[fe]);
        fdp = __ldcg(&dp[fx.y]);
        fins = __ldcg(&row[fx.y].y);
      }
      if (active > 0) grid_barrier(bar, epoch);

      // fold: a warp per query, the queries spread over the blocks (the
      // partials of a level's queries are read by as many SMs)
      for (int qi = qf; qi < a1 - a0; qi += G * kWarps) {
        float v = kNegF;
        int idx = kNone;
        for (int blk = lane; blk < active; blk += 32) {
          const int2 x = __ldcg(&part[(size_t)blk * part_queries + qi]);
          merge(v, idx, __int_as_float(x.x), x.y);
        }
        lane_merge(v, idx, 32);
        if (lane == 0) {
          if (qi != qf) {
            fe = __ldg(&queries[a0 + qi]);
            fx = __ldg(&ev[fe]);
            fdp = __ldcg(&dp[fx.y]);
            fins = __ldcg(&row[fx.y].y);
          }
          const float cand = __fadd_rn(v, __int_as_float(fx.w));
          if (v > kNegF && cand > fdp) {
            fdp = cand;
            dp[fx.y] = cand;
            winner[fe] = idx;
          }
          // the slot's insert comes later: it stores this query's result
          if (fins > fe) row[fx.y].x = __float_as_int(fdp);
        }
      }
      grid_barrier(bar, epoch);
    }
  }
}

}  // namespace

extern "C" int chain_scan_event_launch(const int* ev, const int* steps,
                                       int n_steps, const int* queries,
                                       float* dp, int* row, int* part,
                                       int part_queries,
                                       unsigned long long* bar, int* winner,
                                       int n_events, int n_slots, int blocks,
                                       int stage_rows, void* stream) {
  if (n_events < 0 || n_slots < 0 || n_steps < 0 || part_queries < 1 ||
      blocks < 1 || stage_rows < 2 || stage_rows % 2 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_events == 0) return 0;
  const long long smem = (long long)stage_rows * kSlotBytes;
  if (smem > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      chain_scan_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // every block must be resident at once for the grid barrier
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, chain_scan_level_kernel, kThreads, (size_t)smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1 || blocks > per_sm * sms)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  const int4* ev4 = (const int4*)ev;
  const int4* steps4 = (const int4*)steps;
  int2* row2 = (int2*)row;
  int2* part2 = (int2*)part;
  void* args[] = {&ev4,     &steps4,       &n_steps, &queries,
                  &dp,      &row2,         &part2,   &part_queries,
                  &bar,     &winner,       &n_events, &n_slots,
                  &stage_rows};
  err = cudaLaunchCooperativeKernel((const void*)chain_scan_level_kernel,
                                    dim3(blocks), dim3(kThreads), args,
                                    (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
