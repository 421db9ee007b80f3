// DAG x DAG PO-POA fill and traceback over topological anti-diagonals
// (sm_90a).
//
// popoa_dag_fill replaces the fill of centrolign_tpu/ops/popoa_dag.py
// (_fill_scan, run per job under vmap by _batch_fill_tb), a lax.scan over
// anti-diagonals: cell (r1, r2) of positions in the two topological orders
// depends only on cells of the diagonals r1 + r2 - s, s <= the longest
// edge span S, through each node's predecessor offsets (in-degree <= 4).
// It computes the same int32 recurrence cell for cell, with MININF =
// -2^30, and packs the same tie decisions into one int32 per cell:
//   bits 0-7   code + 7 * (k1 + 5 * k2): code = M source (0 diagonal,
//              2pw+1 I[pw], 2pw+2 D[pw]; first match in I0, D0, I1, ...),
//              k1/k2 = the diagonal's predecessor slots (K = boundary);
//   bits 8-17  per piece pw, digit 10^pw: I choice k + 5 * open;
//   bits 18-27 the same for D.
// With in-degree K <= 4 every slot, boundary included, is below 5, so the
// base-5 digits decode exactly. It also writes M at every sink pair.
//
// popoa_dag_traceback replaces _traceback_scan (a lax.while_loop) plus the
// sink-pair argmax before it: one thread per job picks the first best sink
// pair (s1-major), walks the backpointers until the walk enters the
// boundary row or column or ends at the source-pair corner, and writes
// (count, exit kind), (exit r1, exit r2), (score, best pair) and the pairs;
// the host finishes the lead gap (ops/popoa_dag.py::_assemble_result).
//
// No int32 value can wrap: M >= MININF everywhere (the diagonal term is
// MININF or a real score, the boundary vectors are >= MININF), so every
// I/D value with a real predecessor is >= MININF - (go + ge), and every
// term read is >= MININF - 2 (go + ge) - ge; the wrapper refuses gap
// penalties of 2^28 or more.
//
// What bounds them on an H100: as for the Gotoh fill (gotoh.cu), the
// fill is a wavefront with a block-wide barrier per diagonal, so a launch
// costs about its largest job's diagonal count times one step's latency;
// per cell it does a few dozen int32 compares and adds, far from any
// limit. The design: one block per job; threads over lanes r1 of the
// diagonal's in-matrix cells; the state of the last R = max(S1, S2) + 1
// diagonals of M, PM, PMk1, I[npw], D[npw] (R * V1 * (3 + 2 npw) int32)
// lives in shared memory where the launch's dynamic shared memory holds
// it, else in a per-job global scratch (the table says which); the
// predecessor slots are unrolled to K_MAX so their values stay in
// registers. The traceback is a pointer chase of at most V1 + V2
// dependent loads, bounded by memory latency; its rows for the whole
// launch cross to the host in one copy.
//
// Table row (int32, 24 columns) and data layout: see
// centrolign_tpu_torch/ops/popoa_dag.py (COL_*, G1_*, G2_*).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);   // MININF
constexpr int kNegHalf = kNeg / 2;
constexpr int kCols = 24;
constexpr int kMaxPw = 3;
constexpr int kMaxK = 4;

enum Col {
  kV1 = 0, kV2, kK1, kK2, kR, kNpw, kMatch, kMismatch,
  kGo = 8, kGe = 11,
  kG1 = 14, kG2, kN1, kN2, kSinkPos, kSinkM,
  kBpLo, kBpHi, kScratchLo, kScratchHi
};
enum G1Row { kLab1 = 0, kSrc1, kBcolM, kBdiag, kBdiagK1, kSink1, kDelta1 };
enum G2Row { kLab2 = 0, kSrc2, kBrowM, kSink2, kDelta2 };
// how a walk ended (ops/popoa_dag.py, _EXIT_*)
enum Exit { kExitRow = 1, kExitCol, kExitCorner, kExitNoAlignment, kExitLost };

struct DagJob {
  int V1, V2, K1, K2, R, npw, match, mismatch;
  int go[kMaxPw], ge[kMaxPw];
  int g1, g2, n1, n2, sinkpos, sinkm;
  int64_t bp_off, scratch_off;
};

__device__ DagJob load_job(const int* __restrict__ table, int job) {
  const int* p = table + (int64_t)job * kCols;
  DagJob j;
  j.V1 = p[kV1];
  j.V2 = p[kV2];
  j.K1 = p[kK1];
  j.K2 = p[kK2];
  j.R = p[kR];
  j.npw = p[kNpw];
  j.match = p[kMatch];
  j.mismatch = p[kMismatch];
  for (int pw = 0; pw < kMaxPw; ++pw) {
    j.go[pw] = p[kGo + pw];
    j.ge[pw] = p[kGe + pw];
  }
  j.g1 = p[kG1];
  j.g2 = p[kG2];
  j.n1 = p[kN1];
  j.n2 = p[kN2];
  j.sinkpos = p[kSinkPos];
  j.sinkm = p[kSinkM];
  j.bp_off = (int64_t)(uint32_t)p[kBpLo] | ((int64_t)p[kBpHi] << 32);
  j.scratch_off =
      (int64_t)(uint32_t)p[kScratchLo] | ((int64_t)p[kScratchHi] << 32);
  return j;
}

// in-matrix cells on the diagonals before d: diagonal d's offset in a
// job's backpointers (ops/popoa_dag.py::diag_offset)
__device__ __forceinline__ int64_t diag_offset(int64_t V1, int64_t V2,
                                               int64_t d) {
  const int64_t a = d <= V1 ? d * (d + 1) / 2
                            : V1 * (V1 + 1) / 2 + (d - V1) * V1;
  const int64_t t = d > V2 ? d - V2 : 0;
  return a - t * (t + 1) / 2;
}

__global__ void popoa_dag_fill_kernel(const int* __restrict__ table,
                                      const int* __restrict__ data,
                                      int* __restrict__ bp,
                                      int* __restrict__ sinkm,
                                      int* __restrict__ scratch) {
  extern __shared__ int smem[];
  const DagJob jb = load_job(table, blockIdx.x);
  const int V1 = jb.V1, V2 = jb.V2, R = jb.R, K1 = jb.K1, K2 = jb.K2;
  const int npw = jb.npw;
  int* ring = jb.scratch_off < 0 ? smem : scratch + jb.scratch_off;
  const int plane = R * V1;  // one state array's ring
  int* Mr = ring;
  int* PMr = ring + plane;
  int* PMk1r = ring + 2 * plane;
  int* Ir = ring + 3 * plane;          // + pw * plane
  int* Dr = ring + (3 + npw) * plane;  // + pw * plane
  const int* g1 = data + jb.g1;
  const int* g2 = data + jb.g2;
  int* bpj = bp + jb.bp_off;

  for (int d = 0; d < V1 + V2 - 1; ++d) {
    const int lo = max(0, d - V2 + 1), hi = min(d, V1 - 1);
    const int64_t doff = diag_offset(V1, V2, d);
    const int slot = d % R;
    for (int r1 = lo + threadIdx.x; r1 <= hi; r1 += blockDim.x) {
      const int r2 = d - r1;
      const bool src1 = g1[kSrc1 * V1 + r1] == 1;
      const bool src2 = g2[kSrc2 * V2 + r2] == 1;
      const int browM = g2[kBrowM * V2 + r2];
      const int bcolM = g1[kBcolM * V1 + r1];
      const int score = g1[kLab1 * V1 + r1] == g2[kLab2 * V2 + r2]
                            ? jb.match : -jb.mismatch;
      // ring offsets of the predecessors: (r1 - d1, r2) and (r1, r2 - d2)
      int d1[kMaxK], d2[kMaxK], at1[kMaxK], at2[kMaxK], m1[kMaxK], m2[kMaxK];
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        d1[k] = k < K1 ? g1[(kDelta1 + k) * V1 + r1] : 0;
        d2[k] = k < K2 ? g2[(kDelta2 + k) * V2 + r2] : 0;
        at1[k] = d1[k] > 0 ? ((d - d1[k]) % R) * V1 + r1 - d1[k] : 0;
        at2[k] = d2[k] > 0 ? ((d - d2[k]) % R) * V1 + r1 : 0;
        m1[k] = d1[k] > 0 ? Mr[at1[k]] : kNeg;
        m2[k] = d2[k] > 0 ? Mr[at2[k]] : kNeg;
      }

      // PM: column max over prev1 (+ the boundary row), last-wins argmax
      int PM = kNeg, PMk1 = 0;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (d1[k] > 0 && m1[k] >= PM) {
          PM = m1[k];
          PMk1 = k;
        }
      if (src1 && browM >= PM) {
        PM = browM;
        PMk1 = K1;
      }

      // diagonal: Q over the prev2 columns of PM (+ the boundary column
      // for source2 lanes); the source-pair corner wins only strictly
      int cv[kMaxK], ck[kMaxK];
      int Qmax = kNeg;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        cv[k] = d2[k] > 0 ? PMr[at2[k]] : kNeg;
        ck[k] = d2[k] > 0 ? PMk1r[at2[k]] : kNeg;
        Qmax = max(Qmax, cv[k]);
      }
      const int cvB = src2 ? g1[kBdiag * V1 + r1] : kNeg;
      const int ckB = g1[kBdiagK1 * V1 + r1];
      Qmax = max(Qmax, cvB);
      int k1s = 0;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (d2[k] > 0 && cv[k] == Qmax) k1s = max(k1s, ck[k]);
      if (cvB == Qmax) k1s = max(k1s, ckB);
      // first k2 in scan order: real slots ascending, the boundary last
      int k2s = (cvB == Qmax && ckB == k1s) ? K2 : 0;
#pragma unroll
      for (int k = kMaxK - 1; k >= 0; --k)
        if (d2[k] > 0 && cv[k] == Qmax && ck[k] == k1s) k2s = k;
      const bool corner_wins = src1 && src2 && 0 > Qmax;
      const int Qeff = corner_wins ? 0 : Qmax;
      if (corner_wins) {
        k1s = K1;
        k2s = K2;
      }
      int Mnew = Qeff > kNegHalf ? Qeff + score : kNeg;

      // gap pieces: value, then the choice digit (boundary open seeds it;
      // slots descending, extend then open, so the first adjacency slot
      // wins and open is preferred at that slot)
      int Iv[kMaxPw], Dv[kMaxPw];
      int ipack = 0, dpack = 0, mul = 1;
#pragma unroll
      for (int pw = 0; pw < kMaxPw; ++pw) {
        Iv[pw] = kNeg;
        Dv[pw] = kNeg;
        if (pw >= npw) continue;
        const int ge = jb.ge[pw], gpen = jb.go[pw] + ge;
        const int* Ip = Ir + pw * plane;
        const int* Dp = Dr + pw * plane;
        int opn[kMaxK], ext[kMaxK];

        const int ib = src1 ? browM - gpen : kNeg;
        int Inew = ib;
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          opn[k] = d1[k] > 0 ? m1[k] - gpen : kNeg;
          ext[k] = d1[k] > 0 ? Ip[at1[k]] - ge : kNeg;
          if (k < K1) Inew = max(Inew, max(opn[k], ext[k]));
        }
        int ich = ib == Inew ? K1 + 5 : 0;
#pragma unroll
        for (int k = kMaxK - 1; k >= 0; --k) {
          if (k >= K1) continue;
          if (ext[k] == Inew) ich = k;
          if (opn[k] == Inew) ich = k + 5;
        }

        // the boundary-column open is guarded (popoa_ref: only when real)
        const int db = src2 && bcolM > kNegHalf ? bcolM - gpen : kNeg;
        int Dnew = db;
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          opn[k] = d2[k] > 0 ? m2[k] - gpen : kNeg;
          ext[k] = d2[k] > 0 ? Dp[at2[k]] - ge : kNeg;
          if (k < K2) Dnew = max(Dnew, max(opn[k], ext[k]));
        }
        int dch = db == Dnew ? K2 + 5 : 0;
#pragma unroll
        for (int k = kMaxK - 1; k >= 0; --k) {
          if (k >= K2) continue;
          if (ext[k] == Dnew) dch = k;
          if (opn[k] == Dnew) dch = k + 5;
        }

        Mnew = max(Mnew, max(Inew, Dnew));
        Iv[pw] = Inew;
        Dv[pw] = Dnew;
        ipack += ich * mul;
        dpack += dch * mul;
        mul *= 10;
      }
      int code = 0;
#pragma unroll
      for (int pw = kMaxPw - 1; pw >= 0; --pw) {
        if (pw >= npw) continue;
        if (Dv[pw] == Mnew) code = 2 * pw + 2;
        if (Iv[pw] == Mnew) code = 2 * pw + 1;
      }

      const int at = slot * V1 + r1;
      Mr[at] = Mnew;
      PMr[at] = PM;
      PMk1r[at] = PMk1;
#pragma unroll
      for (int pw = 0; pw < kMaxPw; ++pw) {
        if (pw >= npw) continue;
        Ir[pw * plane + at] = Iv[pw];
        Dr[pw * plane + at] = Dv[pw];
      }
      bpj[doff + r1 - lo] =
          code + 7 * (k1s + 5 * k2s) + (ipack << 8) + (dpack << 18);
      const int s1 = g1[kSink1 * V1 + r1], s2 = g2[kSink2 * V2 + r2];
      if (s1 >= 0 && s2 >= 0) sinkm[jb.sinkm + s1 * jb.n2 + s2] = Mnew;
    }
    __syncthreads();
  }
}

__global__ void popoa_dag_traceback_kernel(const int* __restrict__ bp,
                                           const int* __restrict__ sinkm,
                                           const int* __restrict__ table,
                                           const int* __restrict__ data,
                                           int* __restrict__ out,
                                           int n_jobs, int cap) {
  const int job = blockIdx.x * blockDim.x + threadIdx.x;
  if (job >= n_jobs) return;
  const DagJob jb = load_job(table, job);
  const int V1 = jb.V1, V2 = jb.V2, K1 = jb.K1, K2 = jb.K2;
  int* rows = out + (int64_t)job * (cap + 3) * 2;

  // first best sink pair, s1-major
  const int* sm = sinkm + jb.sinkm;
  int best = 0, bv = sm[0];
  for (int i = 1; i < jb.n1 * jb.n2; ++i)
    if (sm[i] > bv) {
      bv = sm[i];
      best = i;
    }
  rows[4] = bv;
  rows[5] = best;
  if (bv <= kNegHalf) {
    rows[1] = kExitNoAlignment;  // no interior alignment
    return;
  }
  const int* g1 = data + jb.g1;
  const int* g2 = data + jb.g2;
  int r1 = data[jb.sinkpos + best / jb.n2];
  int r2 = data[jb.sinkpos + jb.n1 + best % jb.n2];
  const int* bpj = bp + jb.bp_off;

  int comp = 0, idx = cap + 2, count = 0, kind = kExitLost;
  for (int step = 0; step < V1 + V2; ++step) {
    const int d = r1 + r2;
    const int v = bpj[diag_offset(V1, V2, d) + r1 - max(0, d - V2 + 1)];
    const int diagcode = v & 255, ipack = (v >> 8) & 1023;
    const int dpack = (v >> 18) & 1023;
    const int c = comp == 0 ? diagcode % 7 : comp;
    ++count;
    if (c == 0) {  // diagonal
      rows[2 * idx] = r1;
      rows[2 * idx + 1] = r2;
      --idx;
      const int k1 = (diagcode / 7) % 5, k2 = (diagcode / 7) / 5;
      const bool b1 = k1 >= K1, b2 = k2 >= K2;
      if (b1 && b2) {
        kind = kExitCorner;
        break;
      }
      if (!b2) r2 -= g2[(kDelta2 + k2) * V2 + r2];
      if (b1) {
        kind = kExitRow;
        break;
      }
      r1 -= g1[(kDelta1 + k1) * V1 + r1];
      if (b2) {
        kind = kExitCol;
        break;
      }
      comp = 0;
    } else if (c & 1) {  // I[(c-1)/2]: consumes r1
      int dig = ipack;
      for (int pw = 0; pw < (c - 1) / 2; ++pw) dig /= 10;
      dig %= 10;
      rows[2 * idx] = r1;
      rows[2 * idx + 1] = -1;
      --idx;
      if (dig % 5 >= K1) {
        kind = kExitRow;
        break;
      }
      r1 -= g1[(kDelta1 + dig % 5) * V1 + r1];
      comp = dig / 5 == 1 ? 0 : c;
    } else {  // D[c/2-1]: consumes r2
      int dig = dpack;
      for (int pw = 0; pw < c / 2 - 1; ++pw) dig /= 10;
      dig %= 10;
      rows[2 * idx] = -1;
      rows[2 * idx + 1] = r2;
      --idx;
      if (dig % 5 >= K2) {
        kind = kExitCol;
        break;
      }
      r2 -= g2[(kDelta2 + dig % 5) * V2 + r2];
      comp = dig / 5 == 1 ? 0 : c;
    }
  }
  rows[0] = count;
  rows[1] = kind;
  rows[2] = r1;
  rows[3] = r2;
}

}  // namespace

extern "C" int popoa_dag_fill_launch(const int* table, const int* data,
                                     int* bp, int* sinkm, int* scratch,
                                     int n_jobs, int threads, int smem_bytes,
                                     void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        popoa_dag_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  popoa_dag_fill_kernel<<<n_jobs, threads, smem_bytes, (cudaStream_t)stream>>>(
      table, data, bp, sinkm, scratch);
  return (int)cudaGetLastError();
}

extern "C" int popoa_dag_traceback_launch(const int* bp, const int* sinkm,
                                          const int* table, const int* data,
                                          int* out, int n_jobs, int cap,
                                          int threads, void* stream) {
  const int blocks = (n_jobs + threads - 1) / threads;
  popoa_dag_traceback_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      bp, sinkm, table, data, out, n_jobs, cap);
  return (int)cudaGetLastError();
}
