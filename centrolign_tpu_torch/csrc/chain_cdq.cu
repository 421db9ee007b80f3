// SparseAffine chain-DP value scan on chain x chain inputs (sm_90a).
//
// chain_cdq_scan replaces the lax.scan of centrolign_tpu/ops/chain_cdq.py::
// _cdq_scan: N dependent steps over the anchors in start-position order.
// Step t takes, over the anchors i published before it whose ends precede
// its start on both chains (pe1_i < ps1_t, pe2_i < ps2_t), the maxima of 7
// channels: the gap-free channel (dp_i, anchors of the same shift) and the
// 6 piecewise channels (anchors of a larger shift for pw = 0, 2, 4, of a
// smaller one for pw = 1, 3, 5), each with its first index and the count
// of entries equal to it. One thread folds the 7 maxima in the reference's
// order and rounding, value = (f32)((f64)(f32)(v + w) - fc[pw]), and
// publishes row t: dp_t and the channel values (f32)((f64)dp_t -/+ cs[k]).
// The layout and the plain version are in ops/chain_cdq.py.
//
// What bounds it on an H100: each step reads the keys of every earlier
// anchor (16 bytes each) and the channel values of those that pass (16
// bytes), so the work is O(N^2) bytes over N dependent steps: at the
// N = 145,331 anchors of benchdata/pair.fasta about 340 GB over 145,331
// steps. The table (N x 16 bytes of keys, N x 32 of values) stays in the
// 50 MB L2, so a step is bound by one SM's bandwidth to L2 and the latency
// of its loads, plus the block's reduction and the barriers between steps.
// Measured on an H100 80GB HBM3 at 700 W: 5.04 s for those 145,331 steps,
// about 35 us a step or 67 GB/s from L2, several times the native engine's
// time on the host; spreading the table over a cluster's SMs is left to a
// redesign.
//
// The design, a simple and exact first version: one block of 1,024
// threads per problem (the grid is the batch), a loop over the steps.
// A published row is two float4s, one per side of the shift: (the three
// channels of a larger shift, dp) and (the three of a smaller one, dp), so
// a row that passes costs one 16-byte load, whatever its side. Each thread
// scans its strided share of the rows, four keys and then their four value
// loads in flight, keeping per channel (max, first index, count of
// equals); a warp butterfly
// and a pass of warp 0 over the warps' results combine them ("greater wins;
// on equal values the lower index wins and the counts add"); lane 0 folds
// and publishes. Rows are sorted by ps1, so when every anchor has
// pe1 >= ps1 no row at or after t can pass pe1 < ps1_t and a step scans
// rows [0, t) only (`prefix`, computed on the host); otherwise it scans
// all N rows, the unpublished ones holding their initial -FLT_MAX as in
// the JAX scan. The f32/f64 arithmetic is written with _rn intrinsics so
// that nvcc cannot contract or reorder it, and maxima are taken by '>'.
// A step without a query publishes its initial value and scans nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kChannels = 7;
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

__device__ __forceinline__ void warp_merge(Best (&b)[kChannels]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      const float v = __shfl_xor_sync(0xffffffffu, b[c].v, o);
      const int idx = __shfl_xor_sync(0xffffffffu, b[c].idx, o);
      const int cnt = __shfl_xor_sync(0xffffffffu, b[c].cnt, o);
      merge(b[c], v, idx, cnt);
    }
  }
}

// row i's values on its side of qshift: gt[i] = (channels 1, 3, 5, dp) for
// a larger shift (pw = 0, 2, 4), lt[i] = (channels 2, 4, 6, dp) for a
// smaller one (pw = 1, 3, 5); dp also serves the gap-free channel
__device__ __forceinline__ float4 side(const float4* gt, const float4* lt,
                                       int4 k, int i, int qs) {
  return k.z > qs ? gt[i] : lt[i];
}

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

__global__ void __launch_bounds__(kMaxThreads, 1)
    chain_cdq_scan_kernel(const int4* __restrict__ key,
                          const int4* __restrict__ step,
                          const float2* __restrict__ wi,
                          const double* __restrict__ fc,
                          const double* __restrict__ cs,
                          const int* __restrict__ prefix, float* table,
                          float* out_dp, int* out_bp, uint8_t* out_tie,
                          uint8_t* out_struct, float* out_stored, int N) {
  __shared__ Best red[kMaxThreads / 32][kChannels];
  const size_t base = (size_t)blockIdx.x * N;
  key += base;
  step += base;
  wi += base;
  fc += base * 6;
  cs += base * 3;
  float4* gt = (float4*)table + base * 2;
  float4* lt = gt + N;
  out_dp += base;
  out_bp += base;
  out_tie += base;
  out_struct += base;
  out_stored += base;
  const bool pre = prefix[blockIdx.x] != 0;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;

  for (size_t i = tid; i < (size_t)N * 8; i += nt)
    table[base * 8 + i] = kNegF;
  __syncthreads();

  for (int t = 0; t < N; ++t) {
    const int4 st = step[t];  // (ps1, ps2, qshift, has_query)
    if (st.w == 0) {
      if (tid == 0) {
        const float init = wi[t].y;
        out_dp[t] = init;
        out_bp[t] = -1;
        out_tie[t] = 0;
        out_struct[t] = 255;
        out_stored[t] = kNegF;
        publish(gt, lt, t, init, cs + (size_t)t * 3);
      }
      __syncthreads();
      continue;
    }
    Best b[kChannels];
#pragma unroll
    for (int c = 0; c < kChannels; ++c) b[c] = empty_best();
    const int lim = pre ? t : N;
    int i = tid;
    for (; i + 3 * nt < lim; i += 4 * nt) {
      int4 k[4];
      float4 r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) k[u] = __ldg(&key[i + u * nt]);
#pragma unroll
      for (int u = 0; u < 4; ++u) r[u] = side(gt, lt, k[u], i + u * nt, st.z);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        consider(b, k[u], r[u], i + u * nt, st.x, st.y, st.z);
    }
    for (; i < lim; i += nt) {
      const int4 k = __ldg(&key[i]);
      consider(b, k, side(gt, lt, k, i, st.z), i, st.x, st.y, st.z);
    }
    warp_merge(b);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kChannels; ++c) red[warp][c] = b[c];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int c = 0; c < kChannels; ++c)
        b[c] = lane < nwarps ? red[lane][c] : empty_best();
      warp_merge(b);
      if (lane == 0) {
        const float2 w_init = wi[t];
        const double* fc_t = fc + (size_t)t * 6;
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
        out_dp[t] = best;
        out_bp[t] = bp;
        out_tie[t] = (uint8_t)tie;
        out_struct[t] = (uint8_t)strct;
        out_stored[t] = stored;
        publish(gt, lt, t, best, cs + (size_t)t * 3);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int chain_cdq_scan_launch(const int* key, const int* step,
                                     const float* wi, const double* fc,
                                     const double* cs, const int* prefix,
                                     float* table, float* dp, int* bp,
                                     uint8_t* tie, uint8_t* strct,
                                     float* stored, int n_problems, int n,
                                     int threads, void* stream) {
  if (n_problems < 0 || n < 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_problems == 0 || n == 0) return 0;
  chain_cdq_scan_kernel<<<n_problems, threads, 0, (cudaStream_t)stream>>>(
      (const int4*)key, (const int4*)step, (const float2*)wi, fc, cs, prefix,
      table, dp, bp, tie, strct, stored, n);
  return (int)cudaGetLastError();
}
