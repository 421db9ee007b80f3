// Free-gap sparse chaining's event scan on chain x chain inputs (sm_90a).
//
// chain_scan_event replaces the lax.scan of centrolign_tpu/ops/
// chain_scan.py::_event_scan: E dependent events over a value table of
// n_slots f32 slots. An insert stores its anchor's dp at its slot; a query
// takes the leftmost maximum of the table below its bound hi and, when it
// beats -FLT_MAX and cand = best + w beats the anchor's dp, sets dp to cand
// and records the winning slot (else -1). The event layout and the plain
// version are in ops/chain_scan.py; the host keeps the tie resolution and
// the traceback.
//
// What bounds it on an H100: a query reads hi slots (4 bytes each) and the
// next event cannot start before it is done, so the work is O(n^2) bytes
// over about 2n dependent events: at the 145,331 anchors of
// benchdata/pair.fasta about 42 GB, at its two calibrations' 24,025 and
// 22,506 anchors about 1.2 GB each. One SM's bandwidth to the table (L2, or
// shared memory when the table fits) and the barriers per query bound it.
// Measured on an H100 80GB HBM3 at 700 W: 0.50 s for the 145,331 anchors
// (about 88 GB/s from L2), 31-33 ms for each calibration (shared memory).
//
// The design, a simple first version: one block of 1,024 threads and a
// loop over the events. Thread 0 applies the inserts, which no other
// thread reads until the barrier that opens the next query. A query
// scans slots [0, hi) only: every slot at or above hi is -FLT_MAX in the
// JAX scan's masked table and a query needs best > -FLT_MAX, so that is
// exact. Each thread keeps its share's (max, first slot), reading four
// slots at a time as a float4 with four such loads in flight (the tail
// below a multiple of 4 slot by slot); a warp butterfly and warp 0 over
// the warps combine them
// (greater wins, on equal values the lower slot); lane 0 decides. The
// table lies in shared memory when it has at most 32,768 slots (the
// calibration problems of pair.fasta), else in device memory. dp is read
// and written by thread 0 only.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSharedBytes = 232448 - 1024;
constexpr float kNegF = -3.40282346638528859811704183484516925e+38f;  // -FLT_MAX

__device__ __forceinline__ void take(float& v, int& idx, float x, int i) {
  if (x > v) {
    v = x;
    idx = i;
  }
}

__device__ __forceinline__ void take4(float& v, int& idx, float4 a, int i) {
  take(v, idx, a.x, i);
  take(v, idx, a.y, i + 1);
  take(v, idx, a.z, i + 2);
  take(v, idx, a.w, i + 3);
}

__device__ __forceinline__ void merge(float& v, int& idx, float ov, int oi) {
  if (ov > v || (ov == v && oi < idx)) {
    v = ov;
    idx = oi;
  }
}

__device__ __forceinline__ void warp_merge(float& v, int& idx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
    merge(v, idx, ov, oi);
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads, 1)
    chain_scan_event_kernel(const int4* __restrict__ ev, float* dp,
                            float* val_global, int* winner, int E,
                            int n_slots) {
  extern __shared__ __align__(16) float val_shared[];
  __shared__ float red_v[kMaxThreads / 32];
  __shared__ int red_i[kMaxThreads / 32];
  float* val = kShared ? val_shared : val_global;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;

  for (int i = tid; i < n_slots; i += nt) val[i] = kNegF;
  __syncthreads();

  for (int e = 0; e < E; ++e) {
    const int4 x = __ldg(&ev[e]);  // (kind, slot, hi, weight bits)
    if (x.x != 0) {
      if (tid == 0) {
        val[x.y] = dp[x.y];
        winner[e] = -1;
      }
      continue;
    }
    __syncthreads();  // the inserts before this query, the last query's red
    float v = kNegF;
    int idx = 0x7fffffff;
    const int hi = x.z, hi4 = hi >> 2;
    const float4* val4 = (const float4*)val;
    int q = tid;  // thread q takes slots 4q .. 4q + 3, four float4s ahead
    for (; q + 3 * nt < hi4; q += 4 * nt) {
      float4 a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = val4[q + u * nt];
#pragma unroll
      for (int u = 0; u < 4; ++u) take4(v, idx, a[u], 4 * (q + u * nt));
    }
    for (; q < hi4; q += nt) take4(v, idx, val4[q], 4 * q);
    if (tid < hi - 4 * hi4) take(v, idx, val[4 * hi4 + tid], 4 * hi4 + tid);
    warp_merge(v, idx);
    if (lane == 0) {
      red_v[warp] = v;
      red_i[warp] = idx;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < nwarps ? red_v[lane] : kNegF;
      idx = lane < nwarps ? red_i[lane] : 0x7fffffff;
      warp_merge(v, idx);
      if (lane == 0) {
        const float cand = __fadd_rn(v, __int_as_float(x.w));
        const float cur = dp[x.y];
        if (v > kNegF && cand > cur) {
          dp[x.y] = cand;
          winner[e] = idx;
        } else {
          winner[e] = -1;
        }
      }
    }
  }
}

}  // namespace

extern "C" int chain_scan_event_launch(const int* ev, float* dp, float* val,
                                       int* winner, int n_events,
                                       int n_slots, int shared, int threads,
                                       void* stream) {
  if (n_events < 0 || n_slots < 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_events == 0) return 0;
  if (shared) {
    const int smem = n_slots * 4;
    if ((long long)n_slots * 4 > kMaxSharedBytes)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        chain_scan_event_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    chain_scan_event_kernel<true><<<1, threads, smem, (cudaStream_t)stream>>>(
        (const int4*)ev, dp, val, winner, n_events, n_slots);
  } else {
    if (val == nullptr) return (int)cudaErrorInvalidValue;
    chain_scan_event_kernel<false><<<1, threads, 0, (cudaStream_t)stream>>>(
        (const int4*)ev, dp, val, winner, n_events, n_slots);
  }
  return (int)cudaGetLastError();
}
