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
// sink-pair argmax before it: one block of two warps per job picks the
// first best sink pair (s1-major) by a reduction, then one warp walks the
// backpointers until the walk enters the boundary row or column or ends at
// the source-pair corner, while the other streams the backpointers and
// delta words the walk can reach into shared memory; it writes (count,
// exit kind), (exit r1, exit r2), (score, best pair) and the pairs; the
// host finishes the lead gap (ops/popoa_dag.py::_assemble_result).
//
// No int32 value can wrap: M >= MININF everywhere (the diagonal term is
// MININF or a real score, the boundary vectors are >= MININF), so every
// I/D value with a real predecessor is >= MININF - (go + ge), and every
// term read is >= MININF - 2 (go + ge) - ge; the wrapper refuses gap
// penalties of 2^28 or more.
//
// What bounds the fill on an H100. A job is one block on one SM, and its
// diagonals are dependent steps, so a launch costs about its slowest job's
// diagonals times one step. A step costs the larger of the issue time of
// its cells (a cell is several hundred instructions, more with more
// predecessor slots, and an SM issues 128 thread-instructions a clock) and
// one cell's dependent chain plus a barrier. five.fasta's widest jobs (558
// and 559 lanes) are bound by issue: chip_smoke.py measures each of their
// launches at about 1.1 us a diagonal step on an H100 80GB HBM3 at 700 W
// (PERF.md). The next gain is to split a wide job over several SMs.
// The traceback is a pointer chase of at most V1 + V2 dependent steps,
// bounded by the latency of one step. A step reads only shared memory (the
// backpointer from a ring that a copier warp fills by cp.async ahead of the
// walk, both nodes' delta words from windows the copier stages, and two
// decode tables in place of divisions), so its chain is a few shared loads
// and the position update; its rows for the whole launch cross to the host
// in one copy.
//
// The fill's design. Lanes run along the job's short side, the "lane side"
// (graph 1 when V1 <= V2, else graph 2); the other side's position of a
// lane's cell on diagonal d is y = d - x. Each thread owns R lanes (x, x +
// the job's threads, ...) for the whole job and holds each lane's node in
// registers: label, boundary M, source flag, sink index, graph 1's bdiag
// and bdiag_k1, and its K deltas as the bytes of one word. The other side's
// nodes are staged once per job as one int4 record each (graph 1's bdiag
// beside them), and at R <= 2 a lane's next record is read a step ahead.
// The state of the last diagonals lives in rings indexed by lane, each plane
// only as deep as it is read: M at max(S1, S2) + 1 diagonals, PM, PMk1 and
// D[npw] (read at prev2) at S2 + 1, I[npw] (read at prev1) at S1 + 1; the
// slot of diagonal d - s comes from one rotating index per depth, moved once
// a diagonal. A predecessor along the lane side is another lane of the
// ring; along the other side it is the thread's own lane. Records and rings
// sit in shared memory where the launch's dynamic shared memory holds them
// (read and written by 32-bit shared addresses), else in the job's slice of
// global scratch in the same layout, where a warp's ring reads fall on
// consecutive lanes. A cell reads every ring value it needs first, without
// a branch (a slot with no predecessor reads a valid slot and discards the
// value), through 1, 2 or 4 predecessor slots, the fewest that hold the
// job's in-degrees. Maxima go through DPX (__vimax3_s32, __vibmax_s32)
// where the tie rules allow. One barrier a diagonal: a named barrier over
// the warps that hold lanes, __syncwarp when one warp does. The cell's
// arithmetic and tie rules, written in (r1, r2) terms, are those of
// _fill_scan whichever side carries the lanes.
//
// Table row (int32, 24 columns) and data layout: see
// centrolign_tpu_torch/ops/popoa_dag.py (COL_*, G1_*, G2_*).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);   // MININF
constexpr int kNegHalf = kNeg / 2;
constexpr int kCols = 24;
constexpr int kMaxPw = 3;
// a node's info word: sink index + 1 in bits 0-26, bdiag_k1 in bits 27-29
// (graph 1), is-source in bit 30
constexpr int kSinkMask = (1 << 27) - 1;
// threads a block of the fill may have at R lanes a thread
__host__ __device__ constexpr int max_threads(int R) {
  return R == 8 ? 1024 : R == 4 ? 640 : 512;
}

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
  int V1, V2, K1, K2, npw, match, mismatch;
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

// Node p of a graph block g (V nodes, K delta rows) as a record: (label,
// boundary M, info word, deltas as bytes); graph 1 also gives its bdiag.
// `span` takes the maximum of the node's deltas.
template <bool G1>
__device__ int4 node_record(const int* __restrict__ g, int V, int K, int p,
                            int* bdiag, int* span) {
  int deltas = 0;
  for (int k = 0; k < K; ++k) {
    const int dl = g[((G1 ? (int)kDelta1 : (int)kDelta2) + k) * V + p];
    deltas |= dl << (8 * k);
    *span = max(*span, dl);
  }
  const int src = g[(G1 ? (int)kSrc1 : (int)kSrc2) * V + p] == 1;
  const int sink = g[(G1 ? (int)kSink1 : (int)kSink2) * V + p];
  const int k1 = G1 ? g[kBdiagK1 * V + p] : 0;
  *bdiag = G1 ? g[kBdiag * V + p] : 0;
  return make_int4(g[(G1 ? (int)kLab1 : (int)kLab2) * V + p],
                   g[(G1 ? (int)kBcolM : (int)kBrowM) * V + p],
                   (sink + 1) | (k1 << 27) | (src << 30), deltas);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(smem_addr(p)),
               "r"(v) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}

// slot of diagonal d - s in a ring of depth P whose diagonal d is slot c
__device__ __forceinline__ int ring_slot(int c, int s, int P) {
  const int t = c - s;
  return t < 0 ? t + P : t;
}

__device__ __forceinline__ int delta_of(int deltas, int k) {
  return (int)__byte_perm((unsigned)deltas, 0u, 0x4440u + k);
}

// Where a job's state lives, as int offsets from its start: in shared
// memory, read and written by 32-bit shared addresses, or in global
// scratch.
struct SharedState {
  uint32_t base;  // byte address of the state in shared memory
  __device__ __forceinline__ int ld(int i) const {
    int v;
    asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(base + 4 * i));
    return v;
  }
  __device__ __forceinline__ int4 ld4(int i) const {
    int4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(base + 4 * i));
    return v;
  }
  __device__ __forceinline__ void st(int i, int v) const {
    asm volatile("st.shared.b32 [%0], %1;" ::"r"(base + 4 * i), "r"(v)
                 : "memory");
  }
  __device__ __forceinline__ void st4(int i, int4 v) const {
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(
                     base + 4 * i), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
  }
};

struct GlobalState {
  int* base;
  __device__ __forceinline__ int ld(int i) const { return base[i]; }
  __device__ __forceinline__ int4 ld4(int i) const {
    return *(const int4*)(base + i);
  }
  __device__ __forceinline__ void st(int i, int v) const { base[i] = v; }
  __device__ __forceinline__ void st4(int i, int4 v) const {
    *(int4*)(base + i) = v;
  }
};

// The rings of one job, as offsets in its state: M (depth dm), PM and
// PMk1 (depth d2), D[npw] (depth d2), I[npw] (depth d1), each row `L`
// lanes; `c*` the slot of the current diagonal in each depth.
struct Rings {
  int oM, oPM, oPK, oD, oI;  // oD + pw * planeD, oI + pw * planeI
  int L, dm, d1, d2, planeD, planeI, cM, c1, c2;
  int pw_off[kMaxPw];  // the plane a piece reads: its own, or 0 past npw
};

// One cell (r1, r2) on the current diagonal, at lane x: every ring value it
// reads is gathered first (the diagonals before), then the recurrence of
// _fill_scan, then the cell's state goes to the current diagonal's slots.
// n1 / n2: graph 1's and graph 2's node records, bdiag graph 1's. KC: the
// slots written out (K1, K2 <= KC); a slot past a node's in-degree has
// delta 0 and reads nothing.
template <bool LANE1, int KC, class State>
__device__ __forceinline__ void cell(const DagJob& jb, const Rings& g,
                                     const State& st, int x, const int4& n1,
                                     const int4& n2, int bdiag, int* bp_at,
                                     int* __restrict__ sinkm) {
  const int K1 = jb.K1, K2 = jb.K2, npw = jb.npw, L = g.L;
  const bool src1 = (n1.z >> 30) & 1, src2 = (n2.z >> 30) & 1;
  const int bcolM = n1.y, browM = n2.y;
  const int score = n1.x == n2.x ? jb.match : -jb.mismatch;

  // gather: M at prev1 and prev2, PM / PMk1 / D at prev2, I at prev1.
  // A slot without a predecessor (delta 0) reads the current diagonal's
  // slot and a piece past npw reads piece 0: every read is in the state,
  // and each value so read is discarded where it is used.
  int d1[KC], d2[KC], m1[KC], m2[KC], cv[KC], ck[KC];
  int ie[kMaxPw][KC], de[kMaxPw][KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    d1[k] = delta_of(n1.w, k);
    d2[k] = delta_of(n2.w, k);
    const int l1 = LANE1 ? x - d1[k] : x;
    const int l2 = LANE1 ? x : x - d2[k];
    const int aI1 = g.oI + ring_slot(g.c1, d1[k], g.d1) * L + l1;
    const int a2 = ring_slot(g.c2, d2[k], g.d2) * L + l2;
    m1[k] = st.ld(g.oM + ring_slot(g.cM, d1[k], g.dm) * L + l1);
    m2[k] = st.ld(g.oM + ring_slot(g.cM, d2[k], g.dm) * L + l2);
    const int pm = st.ld(g.oPM + a2);
    cv[k] = d2[k] > 0 ? pm : kNeg;
    ck[k] = st.ld(g.oPK + a2);
#pragma unroll
    for (int pw = 0; pw < kMaxPw; ++pw) {
      ie[pw][k] = st.ld(aI1 + g.pw_off[pw] * g.planeI);
      de[pw][k] = st.ld(g.oD + a2 + g.pw_off[pw] * g.planeD);
    }
  }

  // PM: column max over prev1 (+ the boundary row), last-wins argmax
  int PM = kNeg, PMk1 = 0;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    bool ge;
    const int mx = __vibmax_s32(m1[k], PM, &ge);
    const bool take = d1[k] > 0;
    PM = take ? mx : PM;
    PMk1 = take && ge ? k : PMk1;
  }
  if (src1 && browM >= PM) {
    PM = browM;
    PMk1 = K1;
  }

  // diagonal: Q over the prev2 columns of PM (+ the boundary column for
  // source2 lanes); the source-pair corner wins only strictly
  const int cvB = src2 ? bdiag : kNeg;
  const int ckB = (n1.z >> 27) & 7;
  int Qmax = cvB;
#pragma unroll
  for (int k = 0; k < KC; k += 2)
    Qmax = k + 1 < KC ? __vimax3_s32(Qmax, cv[k], cv[k + 1])
                      : max(Qmax, cv[k]);
  int k1s = 0;
#pragma unroll
  for (int k = 0; k < KC; ++k)
    k1s = d2[k] > 0 && cv[k] == Qmax ? max(k1s, ck[k]) : k1s;
  k1s = cvB == Qmax ? max(k1s, ckB) : k1s;
  // first k2 in scan order: real slots ascending, the boundary last
  int k2s = (cvB == Qmax && ckB == k1s) ? K2 : 0;
#pragma unroll
  for (int k = KC - 1; k >= 0; --k)
    k2s = d2[k] > 0 && cv[k] == Qmax && ck[k] == k1s ? k : k2s;
  const bool corner_wins = src1 && src2 && 0 > Qmax;
  const int Qeff = corner_wins ? 0 : Qmax;
  k1s = corner_wins ? K1 : k1s;
  k2s = corner_wins ? K2 : k2s;
  int Mnew = Qeff > kNegHalf ? Qeff + score : kNeg;

  // gap pieces: value, then the choice digit (boundary open seeds it;
  // slots descending, extend then open, so the first adjacency slot wins
  // and open is preferred at that slot); a piece past npw changes nothing
  int Iv[kMaxPw], Dv[kMaxPw];
  int ipack = 0, dpack = 0;
#pragma unroll
  for (int pw = 0; pw < kMaxPw; ++pw) {
    const bool live = pw < npw;
    const int ge = jb.ge[pw], gpen = jb.go[pw] + ge;
    int oI[KC], eI[KC], oD[KC], eD[KC];

    const int ib = src1 ? browM - gpen : kNeg;
    int Inew = ib;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const bool v = d1[k] > 0;
      oI[k] = v ? m1[k] - gpen : kNeg;
      eI[k] = v ? ie[pw][k] - ge : kNeg;
      Inew = k < K1 ? __vimax3_s32(Inew, oI[k], eI[k]) : Inew;
    }
    int ich = ib == Inew ? K1 + 5 : 0;
#pragma unroll
    for (int k = KC - 1; k >= 0; --k) {
      ich = k < K1 && eI[k] == Inew ? k : ich;
      ich = k < K1 && oI[k] == Inew ? k + 5 : ich;
    }

    // the boundary-column open is guarded (popoa_ref: only when real)
    const int db = src2 && bcolM > kNegHalf ? bcolM - gpen : kNeg;
    int Dnew = db;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const bool v = d2[k] > 0;
      oD[k] = v ? m2[k] - gpen : kNeg;
      eD[k] = v ? de[pw][k] - ge : kNeg;
      Dnew = k < K2 ? __vimax3_s32(Dnew, oD[k], eD[k]) : Dnew;
    }
    int dch = db == Dnew ? K2 + 5 : 0;
#pragma unroll
    for (int k = KC - 1; k >= 0; --k) {
      dch = k < K2 && eD[k] == Dnew ? k : dch;
      dch = k < K2 && oD[k] == Dnew ? k + 5 : dch;
    }

    Mnew = live ? __vimax3_s32(Mnew, Inew, Dnew) : Mnew;
    Iv[pw] = Inew;
    Dv[pw] = Dnew;
    constexpr int kDigit[kMaxPw] = {1, 10, 100};
    ipack += live ? ich * kDigit[pw] : 0;
    dpack += live ? dch * kDigit[pw] : 0;
  }
  int code = 0;
#pragma unroll
  for (int pw = kMaxPw - 1; pw >= 0; --pw) {
    const bool live = pw < npw;
    code = live && Dv[pw] == Mnew ? 2 * pw + 2 : code;
    code = live && Iv[pw] == Mnew ? 2 * pw + 1 : code;
  }

  st.st(g.oM + g.cM * L + x, Mnew);
  st.st(g.oPM + g.c2 * L + x, PM);
  st.st(g.oPK + g.c2 * L + x, PMk1);
#pragma unroll
  for (int pw = 0; pw < kMaxPw; ++pw) {
    if (pw < npw) {
      st.st(g.oI + pw * g.planeI + g.c1 * L + x, Iv[pw]);
      st.st(g.oD + pw * g.planeD + g.c2 * L + x, Dv[pw]);
    }
  }
  *bp_at = code + 7 * (k1s + 5 * k2s) + (ipack << 8) + (dpack << 18);
  const int s1 = (n1.z & kSinkMask) - 1, s2 = (n2.z & kSinkMask) - 1;
  if (s1 >= 0 && s2 >= 0) sinkm[jb.sinkm + s1 * jb.n2 + s2] = Mnew;
}

// One job. LANE1: the lanes are graph 1's positions (x = r1, y = r2), else
// graph 2's (x = r2, y = r1). The state `st` holds the other side's
// records (int4 y at int 4 y, then graph 1's bdiag when graph 1 is the
// other side), then the rings (layout in
// ops/popoa_dag_cuda.py::_ring_ints); `spans` is two words of shared
// memory. KC: the predecessor slots a cell works through (K1, K2 <= KC).
template <bool LANE1, int R, int KC, class State>
__device__ void fill_job(const DagJob& jb, const int* __restrict__ data,
                         int* __restrict__ bp, int* __restrict__ sinkm,
                         const State& st, int* spans) {
  const int V1 = jb.V1, V2 = jb.V2, npw = jb.npw;
  const int VL = LANE1 ? V1 : V2, VO = LANE1 ? V2 : V1;
  const int KL = LANE1 ? jb.K1 : jb.K2, KO = LANE1 ? jb.K2 : jb.K1;
  const int* gL = data + (LANE1 ? jb.g1 : jb.g2);
  const int* gO = data + (LANE1 ? jb.g2 : jb.g1);
  const int obdiag = 4 * VO;  // graph 1 as the other side only
  const int oring = obdiag + (LANE1 ? 0 : (VO + 3) / 4 * 4);

  // stage the other side's records; the longest span of each side
  if (threadIdx.x == 0) spans[0] = spans[1] = 0;
  __syncthreads();
  int spanL = 0, spanO = 0;
  for (int y = threadIdx.x; y < VO; y += blockDim.x) {
    int bd;
    st.st4(4 * y, node_record<!LANE1>(gO, VO, KO, y, &bd, &spanO));
    if (!LANE1) st.st(obdiag + y, bd);
  }
  for (int x = threadIdx.x; x < VL; x += blockDim.x)
    for (int k = 0; k < KL; ++k)
      spanL = max(spanL, gL[((LANE1 ? (int)kDelta1 : (int)kDelta2) + k) * VL
                            + x]);
  spanL = __reduce_max_sync(0xffffffffu, spanL);
  spanO = __reduce_max_sync(0xffffffffu, spanO);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&spans[0], spanL);
    atomicMax(&spans[1], spanO);
  }
  __syncthreads();
  const int S1 = spans[LANE1 ? 0 : 1], S2 = spans[LANE1 ? 1 : 0];
  // the warps that hold lanes; the others are done
  const int nthr = 32 * ((VL + 32 * R - 1) / (32 * R));
  if ((int)threadIdx.x >= nthr) return;

  Rings g;
  g.L = VL;
  g.dm = max(S1, S2) + 1;
  g.d1 = S1 + 1;
  g.d2 = S2 + 1;
  g.planeD = g.d2 * VL;
  g.planeI = g.d1 * VL;
  g.oM = oring;
  g.oPM = g.oM + g.dm * VL;
  g.oPK = g.oPM + g.planeD;
  g.oD = g.oPK + g.planeD;
  g.oI = g.oD + npw * g.planeD;
  g.cM = g.c1 = g.c2 = 0;
#pragma unroll
  for (int pw = 0; pw < kMaxPw; ++pw) g.pw_off[pw] = pw < npw ? pw : 0;

  // the lanes' nodes, in registers for the whole job
  constexpr bool kAhead = R <= 2;  // read the next record a step ahead
  int4 ln[R], nxt[R];
  int lbd[R], nbd[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int x = r * nthr + threadIdx.x;
    int unused = 0;
    ln[r] = x < VL ? node_record<LANE1>(gL, VL, KL, x, &lbd[r], &unused)
                   : make_int4(0, 0, 0, 0);
    nxt[r] = x == 0 ? st.ld4(0) : make_int4(0, 0, 0, 0);
    nbd[r] = !LANE1 && x == 0 ? st.ld(obdiag) : 0;
  }

  // diagonal d's cells start at bpd[lo(d)] (ops/popoa_dag.py::diag_offset)
  int* bpd = bp + jb.bp_off;
  for (int d = 0; d < V1 + V2 - 1; ++d) {
    const int lo = max(0, d - V2 + 1), hi = min(d, V1 - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int x = r * nthr + threadIdx.x, y = d - x;
      int4 o = make_int4(0, 0, 0, 0);
      int obd = 0;
      if (kAhead) {
        o = nxt[r];
        obd = nbd[r];
        if (x < VL && y + 1 >= 0 && y + 1 < VO) {
          nxt[r] = st.ld4(4 * (y + 1));
          if (!LANE1) nbd[r] = st.ld(obdiag + y + 1);
        }
      }
      if (x >= VL || y < 0 || y >= VO) continue;
      if (!kAhead) {
        o = st.ld4(4 * y);
        if (!LANE1) obd = st.ld(obdiag + y);
      }
      cell<LANE1, KC>(jb, g, st, x, LANE1 ? ln[r] : o, LANE1 ? o : ln[r],
                      LANE1 ? lbd[r] : obd, bpd + ((LANE1 ? x : y) - lo),
                      sinkm);
    }
    bpd += hi - lo + 1;
    if (nthr == 32)
      __syncwarp();
    else
      asm volatile("bar.sync 1, %0;" ::"r"(nthr) : "memory");
    g.cM = g.cM + 1 == g.dm ? 0 : g.cM + 1;
    g.c1 = g.c1 + 1 == g.d1 ? 0 : g.c1 + 1;
    g.c2 = g.c2 + 1 == g.d2 ? 0 : g.c2 + 1;
  }
}

// One block per job; R lanes a thread. The job's state is in the dynamic
// shared memory when its table row says so (scratch offset -1), else at its
// offset in `scratch`. A cell in shared memory works through 1, 2 or 4
// predecessor slots, the fewest that hold the job's in-degrees; one in
// global scratch through 4.
template <int R>
__global__ void __launch_bounds__(max_threads(R), 1)
    popoa_dag_fill_kernel(const int* __restrict__ table,
                          const int* __restrict__ data, int* __restrict__ bp,
                          int* __restrict__ sinkm, int* __restrict__ scratch) {
  extern __shared__ int4 smem[];
  __shared__ int spans[2];
  const DagJob jb = load_job(table, blockIdx.x);
  const bool lane1 = jb.V1 <= jb.V2;
  if (jb.scratch_off >= 0) {
    const GlobalState st = {scratch + jb.scratch_off};
    if (lane1)
      fill_job<true, R, 4>(jb, data, bp, sinkm, st, spans);
    else
      fill_job<false, R, 4>(jb, data, bp, sinkm, st, spans);
    return;
  }
  const SharedState st = {smem_addr(smem)};
  const int K = max(jb.K1, jb.K2);
#define FILL(LANE1, KC) fill_job<LANE1, R, KC>(jb, data, bp, sinkm, st, spans)
  if (lane1) {
    if (K <= 1) FILL(true, 1);
    else if (K <= 2) FILL(true, 2);
    else FILL(true, 4);
  } else {
    if (K <= 1) FILL(false, 1);
    else if (K <= 2) FILL(false, 2);
    else FILL(false, 4);
  }
#undef FILL
}

// The traceback's shared memory. Every move lowers r1 + r2 by at least 1
// and each coordinate by no more than the drop in r1 + r2, so from (d, r1)
// the walk reaches on diagonal d - t only r1' in [r1 - t, r1]. The cells of
// the kTbAhead diagonals below the walk sit in a ring of rows, each holding
// that window of the walk's r1 when it was copied; a ring row places the
// backpointer of global index G (counted from bp) at column G % kTbCols, so
// whole aligned 16-byte chunks land without an offset of their own. Each
// graph's nodes sit in a window of kTbNodes delta words (a node's K <= 4
// deltas as the bytes of one word) at slot p % kTbNodes, the kTbNodeAhead
// nodes below the walk staged: V is not bounded, the window is.
constexpr int kTbAhead = 96;    // diagonals copied below the walk (>= 2 S)
constexpr int kTbRing = 128;    // ring rows, a power of 2 > kTbAhead
constexpr int kTbCols = 128;    // ring columns: every chunk of a window
constexpr int kTbNodes = 2048;  // a graph's word window, a power of 2
constexpr int kTbNodeAhead = 1024;  // nodes staged below the walk
constexpr int kTbUnroll = 8;    // nodes a copier lane stages at once
constexpr int kTbThreads = 64;  // a walking warp and a copier warp

// The traceback's dynamic shared memory, in this order.
struct TbShared {
  int ring[kTbRing * kTbCols];
  int words[2][kTbNodes];
  int diag_tab[256];  // diagonal code -> c | k1 << 8 | k2 << 16
  int gap_tab[1024];  // I/D pack -> per piece pw, byte pw: k | open << 4
  long long pos;      // the walk's (d << 32 | r1); -1 once it has ended
  int landed[3];      // lowest diagonal, graph-1 node, graph-2 node landed
  int best_v[2], best_i[2];
};

// diag_offset modulo 2^31, in 32-bit arithmetic: enough for a ring column
__device__ __forceinline__ uint32_t diag_offset_lo(uint32_t V1, uint32_t V2,
                                                   uint32_t full1,
                                                   uint32_t d) {
  const uint32_t a = d <= V1 ? (d * (d + 1)) >> 1 : full1 + (d - V1) * V1;
  const uint32_t t = d > V2 ? d - V2 : 0;
  return a - ((t * (t + 1)) >> 1);
}

// Stage the delta words of nodes [bot, top] of a graph (delta row 0 at
// `delta`, V nodes, K rows) into its window, kTbUnroll nodes a lane at once.
__device__ __forceinline__ void stage_words(const int* __restrict__ delta,
                                            int V, int K, int* words,
                                            int top, int bot, int l) {
  for (int p0 = top - l; p0 >= bot; p0 -= 32 * kTbUnroll) {
    int w[kTbUnroll];
#pragma unroll
    for (int u = 0; u < kTbUnroll; ++u) {
      const int p = p0 - 32 * u;
      w[u] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (p >= bot && k < K) w[u] |= __ldg(delta + k * V + p) << (8 * k);
    }
#pragma unroll
    for (int u = 0; u < kTbUnroll; ++u)
      if (p0 - 32 * u >= bot) words[(p0 - 32 * u) & (kTbNodes - 1)] = w[u];
  }
}

// One job a block of two warps. First the block finds the first best sink
// pair (s1-major, the lowest index among the maxima) and builds the decode
// tables. Then warp 1 copies: it reads the walk's position, issues by
// cp.async the window of each diagonal that came within kTbAhead of it (a
// lane a diagonal, its aligned 16-byte chunks one after another, so that 32
// diagonals' 64-bit offsets are worked out at once: with a lane a chunk,
// the copier fell behind the walk), stages the delta words of the nodes
// that came within kTbNodeAhead, waits for them and publishes the lowest
// diagonal and nodes that have landed. Warp 0 walks: every lane holds the
// walk's state and takes the same step, reading the backpointer and both
// nodes' delta words from shared memory and decoding by table; it waits
// only when the walk reaches a diagonal or node not yet published. Lane k %
// 32 keeps step k's pair; every 32 steps the warp stores them in one store.
// The position update and the exits are those of
// centrolign_tpu/ops/popoa_dag.py::_traceback_scan.
__global__ void __launch_bounds__(kTbThreads)
    popoa_dag_traceback_kernel(const int* __restrict__ bp,
                               const int* __restrict__ sinkm,
                               const int* __restrict__ table,
                               const int* __restrict__ data,
                               int* __restrict__ out, int cap) {
  extern __shared__ int4 tb_smem[];
  TbShared& sh = *(TbShared*)tb_smem;
  const int job = blockIdx.x, warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const DagJob jb = load_job(table, job);
  const int V1 = jb.V1, V2 = jb.V2, K1 = jb.K1, K2 = jb.K2;
  int* rows = out + (int64_t)job * (cap + 3) * 2;

  // the first best sink pair: each thread its strided share, then the warps
  const int* sm = sinkm + jb.sinkm;
  const int n12 = jb.n1 * jb.n2;
  int bv = INT_MIN, bi = n12;
  for (int i = threadIdx.x; i < n12; i += kTbThreads) {
    const int v = sm[i];
    if (v > bv || bi == n12) {
      bv = v;
      bi = i;
    }
  }
  const int wv = __reduce_max_sync(0xffffffffu, bv);
  const int wi = __reduce_min_sync(0xffffffffu, bv == wv ? bi : n12);
  if (l == 0) {
    sh.best_v[warp] = wv;
    sh.best_i[warp] = wi;
  }
  for (int i = threadIdx.x; i < 256; i += kTbThreads)
    sh.diag_tab[i] = i % 7 | (i / 7 % 5) << 8 | (i / 35) << 16;
  for (int i = threadIdx.x; i < 1024; i += kTbThreads) {
    int e = 0;
    for (int pw = 0, q = i; pw < kMaxPw; ++pw, q /= 10)
      e |= (q % 10 % 5 | q % 10 / 5 << 4) << (8 * pw);
    sh.gap_tab[i] = e;
  }
  __syncthreads();
  const bool second = sh.best_v[1] > sh.best_v[0] ||
                      (sh.best_v[1] == sh.best_v[0] &&
                       sh.best_i[1] < sh.best_i[0]);
  const int best_v = sh.best_v[second], best = sh.best_i[second];
  if (best_v <= kNegHalf) {
    if (threadIdx.x == 0) {
      rows[1] = kExitNoAlignment;  // no interior alignment
      rows[4] = best_v;
      rows[5] = best;
    }
    return;
  }
  const int r1_0 = data[jb.sinkpos + best / jb.n2];
  const int r2_0 = data[jb.sinkpos + jb.n1 + best % jb.n2];
  const int* delta1 = data + jb.g1 + kDelta1 * V1;
  const int* delta2 = data + jb.g2 + kDelta2 * V2;
  if (threadIdx.x == 0) {
    sh.pos = ((long long)(r1_0 + r2_0) << 32) | r1_0;
    sh.landed[0] = r1_0 + r2_0 + 1;
    sh.landed[1] = r1_0 + 1;
    sh.landed[2] = r2_0 + 1;
  }
  __syncthreads();

  if (warp == 1) {
    // the copier: diagonals below `low` and nodes below `low1` / `low2`
    // are not issued yet
    int low = r1_0 + r2_0 + 1, low1 = r1_0 + 1, low2 = r2_0 + 1;
    for (;;) {
      const long long p = *(volatile long long*)&sh.pos;
      if (p < 0) break;  // the walk has ended
      const int d = (int)(p >> 32), r1 = (int)(p & 0xffffffff), r2 = d - r1;
      const int stop = max(0, d - kTbAhead);
      const int stop1 = max(0, r1 - kTbNodeAhead);
      const int stop2 = max(0, r2 - kTbNodeAhead);
      if (low <= stop && low1 <= stop1 && low2 <= stop2) continue;
      // a lane a diagonal, 32 at once: its window's chunks one by one
      for (int top = min(low - 1, d); top >= stop; top -= 32) {
        const int dd = top - l;
        int n = 0;
        int64_t c0 = 0;
        if (dd >= stop) {
          const int lo = max(0, dd - V2 + 1);
          const int a = max(lo, r1 - (d - dd)), b = min(min(dd, V1 - 1), r1);
          const int64_t base = jb.bp_off + diag_offset(V1, V2, dd) - lo;
          c0 = (base + a) >> 2;
          // none where the walk cannot reach this diagonal
          n = a <= b ? (int)(((base + b) >> 2) - c0 + 1) : 0;
        }
        const uint32_t row =
            smem_addr(sh.ring + (dd & (kTbRing - 1)) * kTbCols);
        const int col = (int)((4 * c0) & (kTbCols - 1));
        for (int i = 0; i < n; ++i)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                           row + 4 * ((col + 4 * i) & (kTbCols - 1))),
                       "l"(bp + 4 * (c0 + i))
                       : "memory");
      }
      stage_words(delta1, V1, K1, sh.words[0], min(low1 - 1, r1), stop1, l);
      stage_words(delta2, V2, K2, sh.words[1], min(low2 - 1, r2), stop2, l);
      asm volatile("cp.async.commit_group;\n\tcp.async.wait_all;" :::
                   "memory");
      __syncwarp();
      low = min(low, stop);
      low1 = min(low1, stop1);
      low2 = min(low2, stop2);
      if (l == 0) {
        asm volatile("fence.acq_rel.cta;" ::: "memory");
        st_release(&sh.landed[0], low);
        st_release(&sh.landed[1], low1);
        st_release(&sh.landed[2], low2);
      }
      if (low == 0 && low1 == 0 && low2 == 0) break;
    }
    return;
  }

  // the walker
  const uint32_t full1 = (uint32_t)V1 * (uint32_t)(V1 + 1) >> 1;
  const uint32_t boff = (uint32_t)jb.bp_off;
  int r1 = r1_0, r2 = r2_0, d = r1 + r2, comp = 0, k = 0, pa = 0, pb = 0;
  int kind = kExitLost, rd = d + 1, rn1 = r1 + 1, rn2 = r2 + 1;
  int2* pairs = (int2*)rows;
  while (k < V1 + V2) {
    if (d < rd || r1 < rn1 || r2 < rn2) {  // not published yet: wait
      do {
        rd = ld_acquire(&sh.landed[0]);
        rn1 = ld_acquire(&sh.landed[1]);
        rn2 = ld_acquire(&sh.landed[2]);
      } while (d < rd || r1 < rn1 || r2 < rn2);
    }
    const uint32_t lo = (uint32_t)max(0, d - V2 + 1);
    const int v = sh.ring[(d & (kTbRing - 1)) * kTbCols +
                          ((boff + diag_offset_lo(V1, V2, full1, d) + r1 -
                            lo) & (kTbCols - 1))];
    const int w1 = sh.words[0][r1 & (kTbNodes - 1)];
    const int w2 = sh.words[1][r2 & (kTbNodes - 1)];
    const int dt = sh.diag_tab[v & 255];
    const int it = sh.gap_tab[(v >> 8) & 1023];
    const int dtb = sh.gap_tab[(v >> 18) & 1023];
    const int c = comp != 0 ? comp : dt & 7;
    const bool diag = c == 0, ins = c & 1;
    // a gap piece's digit: k | open << 4; I pieces 1, 3, 5, D 2, 4, 6
    const int g = ((ins ? it : dtb) >> ((8 * ((c - 1) >> 1)) & 31)) & 255;
    const int k1 = diag ? (dt >> 8) & 255 : g & 15;
    const int k2 = diag ? dt >> 16 : g & 15;
    const bool use1 = diag || ins, use2 = diag || !ins;
    const bool b1 = use1 && k1 >= K1, b2 = use2 && k2 >= K2;
    if ((k & 31) == l) {
      pa = use1 ? r1 : -1;
      pb = use2 ? r2 : -1;
    }
    if ((k & 31) == 31) pairs[cap + 2 - k + 31 - l] = make_int2(pa, pb);
    ++k;
    r1 -= use1 && !b1 ? delta_of(w1, k1) : 0;
    r2 -= use2 && !b2 ? delta_of(w2, k2) : 0;
    if (b1 || b2) {
      kind = b1 && b2 ? kExitCorner : b1 ? kExitRow : kExitCol;
      break;
    }
    comp = diag || (g >> 4) ? 0 : c;
    d = r1 + r2;
    if (l == 0) *(volatile long long*)&sh.pos = ((long long)d << 32) | r1;
  }
  if (l < (k & 31)) pairs[cap + 2 - (k & ~31) - l] = make_int2(pa, pb);
  if (l == 0) {
    rows[0] = k;
    rows[1] = kind;
    rows[2] = r1;
    rows[3] = r2;
    rows[4] = best_v;
    rows[5] = best;
    *(volatile long long*)&sh.pos = -1;  // the copier may stop
  }
}

}  // namespace

// The fill over `n_jobs` jobs, one block each: `threads` threads of
// `lanes_per_thread` lanes (1, 2, 4 or 8) and `smem_bytes` of dynamic shared
// memory for the jobs whose state is there.
extern "C" int popoa_dag_fill_launch(const int* table, const int* data,
                                     int* bp, int* sinkm, int* scratch,
                                     int n_jobs, int threads,
                                     int lanes_per_thread, int smem_bytes,
                                     void* stream) {
  void (*kernel)(const int*, const int*, int*, int*, int*);
  if (lanes_per_thread == 1)
    kernel = popoa_dag_fill_kernel<1>;
  else if (lanes_per_thread == 2)
    kernel = popoa_dag_fill_kernel<2>;
  else if (lanes_per_thread == 4)
    kernel = popoa_dag_fill_kernel<4>;
  else if (lanes_per_thread == 8)
    kernel = popoa_dag_fill_kernel<8>;
  else
    return (int)cudaErrorInvalidValue;
  if (threads <= 0 || threads % 32 != 0 ||
      threads > max_threads(lanes_per_thread) || smem_bytes < 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_jobs, threads, smem_bytes, (cudaStream_t)stream>>>(
      table, data, bp, sinkm, scratch);
  return (int)cudaGetLastError();
}

// The traceback over `n_jobs` jobs, one block of two warps each, with its
// ring and windows in dynamic shared memory. (`threads` must be 64; bp must
// be 16-byte aligned and hold ops/popoa_dag.py::BP_SPARE entries past the
// last job's cells.)
extern "C" int popoa_dag_traceback_launch(const int* bp, const int* sinkm,
                                          const int* table, const int* data,
                                          int* out, int n_jobs, int cap,
                                          int threads, void* stream) {
  if (threads != kTbThreads || n_jobs < 0 || cap < 0 ||
      ((uintptr_t)bp & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (n_jobs == 0) return (int)cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      popoa_dag_traceback_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(TbShared));
  if (err != cudaSuccess) return (int)err;
  popoa_dag_traceback_kernel<<<n_jobs, threads, sizeof(TbShared),
                               (cudaStream_t)stream>>>(bp, sinkm, table, data,
                                                       out, cap);
  return (int)cudaGetLastError();
}
