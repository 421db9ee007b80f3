// Piecewise-affine Gotoh fill and traceback for chain x chain gaps (sm_90a).
//
// gotoh_fill replaces the Pallas fills of centrolign_tpu/ops/gotoh_pallas.py:
// gotoh_fill_pallas_packmulti and gotoh_fill_pallas_pack8
// (_make_pack8_kernel), gotoh_fill_pallas_batch (_make_batch_kernel over
// _make_kernel) and gotoh_fill_pallas (the single-problem entry). It
// computes the int32 recurrence of centrolign_tpu/ops/gotoh.py::_diag_math
// cell for cell, with the same packed backpointer per cell (bits 0-2 M
// source, bit 3+pw I opened, bit 6+pw D opened) and the score M(V1, V2).
//
// gotoh_traceback replaces the lax traceback that follows those fills
// (_traceback_pack8_on_device, _traceback_batch_on_device /
// _traceback_bp_on_device) and writes the same (cap+1, 2) rows: row 0 is
// (count, score), the alignment pairs end at row cap, GAP = -1. A job's
// walk reads its backpointers from a ring of rows in shared memory (see
// gotoh_traceback_kernel).
//
// What bounds the fill on an H100. Every cell depends on its left, upper
// and diagonal neighbours, about 3 + 18 npw int32 operations each. A job
// held by one block is bounded by one SM's int32 rate (64 lanes a clock):
// the 4356 x 3330 gap of benchdata/pair.fasta is 827 M operations, about
// 6.5 ms on one SM. Split over a cluster of C blocks it is bounded by C
// SMs' rate and by its critical path: its V1 + V2 + 1 anti-diagonals, each
// one dependent step of shuffle, shared-memory read and a cell's chain of
// maxima. Measured on an H100 80GB HBM3 at 700 W, the steps are the
// limit: about 0.3 us each, 1.4 us when one block holds 3331 lanes
// (PERF.md).
//
// The design: a striped anti-diagonal wavefront held in registers. Lanes
// are the job's short side (W = short side + 1). Each thread holds a strip
// of R consecutive lanes; at each step a warp computes one anti-diagonal d
// over its 32 R lanes, lane k at column d - k, so the R cells of a thread
// are independent (each reads only the diagonals before) and the warp's
// backpointers land side by side on diagonal d. The last two diagonals' M
// and the last one's gaps (R x (2 + 2 npw) int32) stay in registers; the
// cell above a strip's first lane comes from the thread before by
// __shfl_up_sync. Between warps, and between the blocks of a cluster, that
// boundary goes through a ring in the receiving warp's shared memory: each
// warp trails the one before it by kChunk - 1 steps, the block synchronises
// once per kChunk diagonals, so an entry is written a chunk before it is
// read. Across blocks the entries go by st.async into distributed shared
// memory, each chunk's bytes counted on an mbarrier of the receiver
// ("full"), and the receiver tells the sender, by a word counted on the
// sender's mbarrier ("empty"), when it may reuse the ring entries: the
// blocks of a cluster wait only for their neighbours, and no memory fence
// is needed. The other side's labels are staged in shared memory (up to
// `stage` of them); each step reads the next step's label and ring entry
// ahead.
//
// The arithmetic: for a job whose values stay within +-2^20 (with the
// default parameters, every job up to about 9,500 x 9,500), every value is
// held times 2^9 and its low bits carry the backpointer: an opening gap
// value carries its "opened" bit, every candidate of M its rank in the
// M-source search, so the maxima themselves (__vimax3_s32, Hopper's DPX
// three-way maximum) give M, the source and the bits, with no compare. Any
// other job runs the same recurrence in plain int32 with the tests written
// out (__vibmax_s32 gives max(open, extend) and the "opened" bit). Both
// give the int32 values and bits of _diag_math exactly.
//
// Every block reads its row of the launch plan (job, rank in its group,
// group size, warps that hold lanes), built by ops/gotoh_cuda.py::fill_plan.
// A job wider than the plan's threshold takes a whole cluster of C = 8
// blocks, each a contiguous slice of its lanes; every other job takes one
// block of a cluster, so a cluster launch packs C small jobs in a cluster
// and no block waits for a job that is not its own. The plan lists the
// jobs with the most diagonals first, and splits them only while the
// launch's clusters fit the card at once.
//
// The traceback is a chain of up to V1 + V2 dependent steps, each a read
// of the backpointer at the walk's position, so read from device memory it
// is bounded by that memory's latency (about 0.2 us a step). Every step
// lowers the anti-diagonal by 1 or 2 and the lane by 0 or 1, so the walk's
// next steps lie in a band below it that is known ahead. One block of two
// warps takes a job: one warp copies the rows of the 96 diagonals below the
// walk, each as the 97 lanes the walk can still reach there, into a ring in
// shared memory with cp.async, while the other walks from that ring and
// waits only for a row not yet landed; each 32 steps'
// pairs go out in one coalesced store. It runs on the fill's stream, so
// only the O(L) pairs cross to the host.
//
// Per-job parameter row (int32, 16 columns), written by
// centrolign_tpu_torch/ops/gotoh_cuda.py::params_table:
//   0 V1, 1 V2, 2 match, 3 mismatch, 4.. go[npw], 4+npw.. ge[npw],
//   10 lane_is_i, 11 swap_pref, 12 npw, 13 offset of seq1 in `seqs`
//   (seq2 follows it), 14/15 low/high 32 bits of the job's offset in `bp`.
// A job's backpointers are laid out [d][lane], d in [0, V1+V2], lane in
// [0, W), W = short side + 1.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kNeg = -(1 << 30);  // MININF, centrolign_tpu/ops/align_params.py
constexpr int kCols = 16;
constexpr int kMaxPw = 3;
// threads of a block: fewer at R = 8, so that one block holds the 3331
// lanes of benchdata/pair.fasta's widest gap
__host__ __device__ constexpr int max_threads(int R) { return R == 8 ? 448 : 512; }
// diagonals between two barriers; ring entries per warp (four chunks);
// ints per entry (M and the along-lane gap of each piece)
constexpr int kChunk = 8;
constexpr int kRing = 4 * kChunk;
constexpr int kSlot = 1 + kMaxPw;
// steps by which a warp trails the warp before it: its ring entry for a
// diagonal is written kChunk steps before it is read
constexpr int kWarpLag = kChunk - 1;
// per block of a cluster, one mbarrier per chunk of the ring's four that
// counts the bytes of the entries the block before it sent ("full"), and
// one that counts the block after it's word saying it has read them
// ("empty")
constexpr int kMbars = kRing / kChunk;
// bytes before the rings in shared memory: the mbarriers and the word the
// "empty" messages write
constexpr int kMbarBytes = 16 * kMbars + 16;
constexpr unsigned kFull = 0xffffffffu;

struct Job {
  int V1, V2, match, mismatch, npw;
  bool lane_is_i, swap_pref;
  int go[kMaxPw], ge[kMaxPw];
  int64_t bp_off;
  int seq_off;
};

__device__ Job load_job(const int* __restrict__ par, int job) {
  const int* p = par + (int64_t)job * kCols;
  Job j;
  j.V1 = p[0];
  j.V2 = p[1];
  j.match = p[2];
  j.mismatch = p[3];
  j.npw = p[12];
  j.lane_is_i = p[10] != 0;
  j.swap_pref = p[11] != 0;
#pragma unroll
  for (int pw = 0; pw < kMaxPw; ++pw) {
    j.go[pw] = pw < j.npw ? p[4 + pw] : 0;
    j.ge[pw] = pw < j.npw ? p[4 + j.npw + pw] : 0;
  }
  j.seq_off = p[13];
  j.bp_off = (int64_t)(uint32_t)p[14] | ((int64_t)p[15] << 32);
  return j;
}

// distributed shared memory: the ring entry goes to the next block of the
// cluster with st.async, which counts its bytes on that block's mbarrier,
// so no memory fence is needed
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_async_v4(uint32_t addr, int x0, int x1,
                                            int x2, int x3, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(addr), "r"(x0), "r"(x1), "r"(x2), "r"(x3), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void st_async_b32(uint32_t addr, int x,
                                             uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" :: "r"(addr), "r"(x), "r"(mbar) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* mb) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(mb)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* mb, int bytes) {
  asm volatile(
      "{ .reg .b64 st; mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], "
      "%1; }" :: "r"(smem_addr(mb)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* mb, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(mb)), "r"(parity) : "memory");
  } while (!done);
}

// the bytes of ring entries a block is sent in chunk q: one entry a step
// for n steps from step lo on
__device__ __forceinline__ int chunk_bytes(int q, int lo, int n) {
  return 16 * (min(q * kChunk + kChunk, lo + n) - max(q * kChunk, lo));
}

// The other side's labels: the first n_stage in shared memory, the rest in
// device memory.
struct Other {
  const int* olab;
  const int* seq;
  int n_stage;
};

// the other side's label of column c (c in [1, O]), else -2
__device__ __forceinline__ int other_label(int c, int O, const Other& ot) {
  if (c < 1 || c > O) return -2;
  return c - 1 < ot.n_stage ? ot.olab[c - 1] : ot.seq[c - 1];
}

// What a thread holds: per lane its label, M on the last two diagonals,
// A and X on the last one.
template <int R, int NPW>
struct Lanes {
  int lab[R], M1[R], M2[R], A1[NPW][R], X1[NPW][R];
};

// A job's constants. Exact: the int32 values of the recurrence, cA / cX
// the M-source codes of A and X. Scaled (see step_scaled): values times
// 2^9, oA / oX the opening cost less the gap's "opened" bit, tA / tX the
// gap's rank in the M-source search, code_lo / code_hi the code of each
// rank, one byte each.
template <int NPW>
struct Params {
  int gog[NPW], ge[NPW], cA[NPW], cX[NPW];
  int oA[NPW], oX[NPW], tA[NPW], tX[NPW];
  int a_shift, x_shift, match, mismatch;
  uint32_t code_lo, code_hi;
};

// the scaled values' low 9 bits: bits 0-2 a rank, bits 3-8 the gaps'
// "opened" bits where the backpointer has them
constexpr int kScaleBits = 9;
constexpr int kLowMask = (1 << kScaleBits) - 1;
constexpr int kOpenedMask = 0x1f8;

// One step of a job in exact arithmetic: lane r of the thread computes its
// cell on diagonal d, column c0 - r, with every border case and the MININF
// test of the "opened" bits written out.
template <int R, int NPW, bool A_FIRST>
__device__ __forceinline__ void step_exact(Lanes<R, NPW>& s,
                                           const Params<NPW>& P,
                                           const Other& ot, uint16_t* p,
                                           int c0, int k0, int L, int O,
                                           int bM, const int (&bA)[NPW],
                                           int bM_prev) {
  // lanes in descending order, so lane r reads lane r-1's values of the
  // diagonals before before they are replaced
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    const int c = c0 - r;
    const bool cz = c == 0;
    const bool edge_k = r == 0 && k0 == 0;  // lane 0: nothing above
    const int up = r > 0 ? s.M1[r - 1] : bM;
    const int diag = r > 0 ? s.M2[r - 1] : bM_prev;
    const int left = s.M1[r];
    int m = diag + (s.lab[r] == other_label(c, O, ot) ? P.match : P.mismatch);
    if (cz || edge_k) m = kNeg;
    int a[NPW], x[NPW], bits_a = 0, bits_x = 0;
#pragma unroll
    for (int pw = 0; pw < NPW; ++pw) {
      const int up_a = r > 0 ? s.A1[pw][r - 1] : bA[pw];
      bool pa, px;
      a[pw] = __vibmax_s32(up - P.gog[pw], up_a - P.ge[pw], &pa);
      x[pw] = __vibmax_s32(left - P.gog[pw], s.X1[pw][r] - P.ge[pw], &px);
      if (edge_k) a[pw] = kNeg;
      if (cz) x[pw] = kNeg;
      bits_a |= (int)(pa && a[pw] > kNeg) << pw;
      bits_x |= (int)(px && x[pw] > kNeg) << pw;
      m = __vimax3_s32(m, a[pw], x[pw]);
    }
    int code = 0;
    if (cz && edge_k) {
      m = 0;  // the corner
    } else {
#pragma unroll
      for (int pw = NPW - 1; pw >= 0; --pw) {
        const bool eq_a = a[pw] == m, eq_x = x[pw] == m;
        if (A_FIRST) {
          code = eq_x ? P.cX[pw] : code;
          code = eq_a ? P.cA[pw] : code;
        } else {
          code = eq_a ? P.cA[pw] : code;
          code = eq_x ? P.cX[pw] : code;
        }
      }
    }
    if (c >= 0 && c <= O && k0 + r <= L)
      p[r] = (uint16_t)((bits_a << P.a_shift) | (bits_x << P.x_shift) | code);
    s.M2[r] = left;
    s.M1[r] = m;
#pragma unroll
    for (int pw = 0; pw < NPW; ++pw) {
      s.A1[pw][r] = a[pw];
      s.X1[pw][r] = x[pw];
    }
  }
}

// One step in scaled arithmetic, for a job whose values all lie within
// +-2^20 (see fill_job): every value is held times 2^9, and the low 9 bits
// carry what the exact step finds by comparisons. An opening gap value gets
// its "opened" bit (at its place in the backpointer), so the maximum of
// opening and extending keeps the bit exactly when opening wins or ties;
// every candidate of M gets its rank in the M-source search (the diagonal
// 0, the first gap checked 6), so the maximum of them is M with the rank of
// the first candidate equal to M. M and the backpointer come out of the
// maxima without a comparison. MININF stays below every value of such a
// job. EDGE: some lane lies outside the matrix, on column 0 or on lane 0.
template <int R, int NPW, bool EDGE>
__device__ __forceinline__ void step_scaled(Lanes<R, NPW>& s,
                                            const Params<NPW>& P,
                                            const Other& ot, uint16_t* p,
                                            int c0, int k0, int L, int O,
                                            int bM, const int (&bA)[NPW],
                                            int bM_prev) {
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    const int c = c0 - r;
    const bool cz = EDGE && c == 0;
    const bool before = EDGE && c < 0;  // not started: held at MININF
    const bool edge_k = EDGE && r == 0 && k0 == 0;
    const int up = r > 0 ? s.M1[r - 1] : bM;
    const int diag = r > 0 ? s.M2[r - 1] : bM_prev;
    const int left = s.M1[r];
    // inside, every column's label is staged
    const int ol = EDGE ? other_label(c, O, ot) : ot.olab[c - 1];
    int mt = diag + (s.lab[r] == ol ? P.match : P.mismatch);
    if (cz || edge_k || before) mt = kNeg;
    int opened = 0;
#pragma unroll
    for (int pw = 0; pw < NPW; ++pw) {
      const int up_a = r > 0 ? s.A1[pw][r - 1] : bA[pw];
      int a = max(up - P.oA[pw], up_a - P.ge[pw]);
      int x = max(left - P.oX[pw], s.X1[pw][r] - P.ge[pw]);
      if (edge_k || before) a = kNeg;
      if (cz || before) x = kNeg;
      opened |= a | x;
      a = (a & ~kLowMask) | P.tA[pw];
      x = (x & ~kLowMask) | P.tX[pw];
      mt = __vimax3_s32(mt, a, x);
      s.A1[pw][r] = a;
      s.X1[pw][r] = x;
    }
    int m = mt & ~kLowMask;
    int code = __byte_perm(P.code_lo, P.code_hi, (mt & 7) | 0x7770);
    if (cz && edge_k) m = code = 0;  // the corner
    if (!EDGE || (c >= 0 && c <= O && k0 + r <= L))
      p[r] = (uint16_t)((opened & kOpenedMask) | code);
    s.M2[r] = left;
    s.M1[r] = m;
  }
}

// One job's lanes [rank * 32 * R * nwj, ...) over all its diagonals. "A"
// is the gap that runs along the lanes (I when lanes index i, else D), "X"
// the one that runs across them. Lane k's cell on diagonal d is (k, d - k).
// MODE: kScaled, or exact with A or X first in the M-source search.
enum { kScaled, kExactAFirst, kExactXFirst };

template <int R, int NPW, int MODE>
__device__ void fill_job(const Job& jb, int job, int rank, int G, int nwj,
                         const int* __restrict__ seqs,
                         uint16_t* __restrict__ bp, int* __restrict__ score,
                         uint64_t* mbar, int* ring, int* olab, int stage) {
  const int L = jb.lane_is_i ? jb.V1 : jb.V2;  // lane side
  const int O = jb.lane_is_i ? jb.V2 : jb.V1;  // other side
  const int W = L + 1;
  const int* s1 = seqs + jb.seq_off;
  const int* s2 = s1 + jb.V1;
  const int* lane_seq = jb.lane_is_i ? s1 : s2;
  const int* other_seq = jb.lane_is_i ? s2 : s1;
  uint16_t* bpj = bp + jb.bp_off;

  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  const int gw = rank * nwj + w;  // warp index within the job
  const int k0 = (rank * nwj * 32 + t) * R;
  const bool active = w < nwj && k0 <= L;
  // a warp none of whose lanes is in the matrix only keeps the barriers
  const bool warp_runs = w < nwj && (k0 - l * R) <= L;
  const int lag = gw * kWarpLag;
  const int steps = O + W + (G * nwj - 1) * kWarpLag;
  const int chunks = (steps + kChunk - 1) / kChunk;
  // the first lane of this block and of the next: a block that holds no
  // lane neither receives nor is sent ring entries
  const int lane_lo = rank * nwj * 32 * R, next_lo = lane_lo + nwj * 32 * R;
  const bool recv = rank > 0 && w == 0 && lane_lo <= L;
  const bool send_warp = rank + 1 < G && w == nwj - 1 && next_lo <= L;
  // Into block b of the group, the last thread of block b - 1 sends one
  // entry a step from step in_lo (of block b) on, O + R steps: chunks
  // in_qa..in_qb, the i-th of them counted on "full" mbarrier i % 4 in its
  // phase i / 4.
  // Block b reads the entries of chunk q during its chunk q + 1 and then
  // says so; the i-th such word goes to "empty" mbarrier i % 4 of block
  // b - 1, which waits for word i before it sends chunk i + 4 into the
  // same ring entries.
  const int in_lo = (rank * nwj - 1) * kWarpLag + lane_lo - R;
  const int out_lo = ((rank + 1) * nwj - 1) * kWarpLag + next_lo - R;
  const int in_qa = in_lo / kChunk, in_qb = (in_lo + O + R - 1) / kChunk;
  const int out_qa = out_lo / kChunk, out_qb = (out_lo + O + R - 1) / kChunk;
  uint64_t* full = mbar;
  uint64_t* empty = mbar + kMbars;
  int* word = (int*)(mbar + 2 * kMbars);

  const int n_stage = min(O, stage);
  for (int c = threadIdx.x; c < n_stage; c += blockDim.x)
    olab[c] = other_seq[c];
  const Other ot = {olab, other_seq, n_stage};
  if (G > 1) {
    if (t == 0) {
      for (int j = 0; j < 2 * kMbars; ++j) mbar_init(&mbar[j]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int q = in_qa; recv && q <= min(in_qa + kMbars - 1, in_qb); ++q)
        mbar_expect(&full[q - in_qa], chunk_bytes(q, in_lo, O + R));
      for (int q = out_qa; rank + 1 < G && next_lo <= L &&
                           q <= min(out_qa + kMbars - 1, out_qb - kMbars);
           ++q)
        mbar_expect(&empty[q - out_qa], 4);
    }
    // every block of the cluster is running, and its mbarriers are set,
    // before anyone sends to it
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  constexpr bool scaled = MODE == kScaled;
  const int scale = scaled ? 1 << kScaleBits : 1;
  // the M-source search checks the first of each (I, D) pair first: I,
  // or D under swap_pref
  const bool a_first = jb.lane_is_i != jb.swap_pref;
  Params<NPW> P;
  P.a_shift = jb.lane_is_i ? 3 : 6;
  P.x_shift = 9 - P.a_shift;
  P.match = jb.match * scale;
  P.mismatch = -jb.mismatch * scale;
  uint64_t codes = 0;  // byte t: the code of rank t
#pragma unroll
  for (int pw = 0; pw < NPW; ++pw) {
    P.gog[pw] = (jb.go[pw] + jb.ge[pw]) * scale;
    P.ge[pw] = jb.ge[pw] * scale;
    P.cA[pw] = jb.lane_is_i ? 1 + 2 * pw : 2 + 2 * pw;  // code of I or D
    P.cX[pw] = 3 + 4 * pw - P.cA[pw];
    P.oA[pw] = P.gog[pw] - (1 << (P.a_shift + pw));
    P.oX[pw] = P.gog[pw] - (1 << (P.x_shift + pw));
    P.tA[pw] = a_first ? 6 - 2 * pw : 5 - 2 * pw;
    P.tX[pw] = a_first ? 5 - 2 * pw : 6 - 2 * pw;
    codes |= (uint64_t)P.cA[pw] << (8 * P.tA[pw]);
    codes |= (uint64_t)P.cX[pw] << (8 * P.tX[pw]);
  }
  P.code_lo = (uint32_t)codes;
  P.code_hi = (uint32_t)(codes >> 32);

  Lanes<R, NPW> s;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = k0 + r;
    s.lab[r] = (k >= 1 && k <= L) ? lane_seq[k - 1] : -1;
    s.M1[r] = s.M2[r] = kNeg;
#pragma unroll
    for (int pw = 0; pw < NPW; ++pw) s.A1[pw][r] = s.X1[pw][r] = kNeg;
  }
  int bM_prev = kNeg;  // M(k0 - 1, c - 1), the cell above-left of lane 0
  // the thread's steps with every cell inside: c0 in [R, O], no lane
  // past L, not lane 0, every label staged
  const bool inner_rows = k0 > 0 && k0 + R - 1 <= L;

  const int* in_ring = ring + w * kRing * kSlot;
  int* out_ring = nullptr;
  uint32_t out_remote = 0, out_full = 0, word_back = 0, empty_back = 0;
  if (l == 31 && active) {
    if (w + 1 < nwj) {
      out_ring = ring + (w + 1) * kRing * kSlot;
    } else if (send_warp) {
      out_remote = map_rank(smem_addr(ring), rank + 1);
      out_full = map_rank(smem_addr(full), rank + 1);
    }
  }
  if (recv && t == 0) {
    word_back = map_rank(smem_addr(word), rank - 1);
    empty_back = map_rank(smem_addr(empty), rank - 1);
  }

  for (int q = 0; q < chunks; ++q) {
    if (G > 1 && recv && q - 1 >= in_qa && q - 1 <= in_qb) {
      // the entries sent in chunk q - 1; then the same mbarrier counts
      // those of chunk q + 3
      const int i = q - 1 - in_qa;
      mbar_wait(&full[i % kMbars], (i / kMbars) & 1);
      if (l == 0 && q + kMbars - 1 <= in_qb)
        mbar_expect(&full[i % kMbars],
                    chunk_bytes(q + kMbars - 1, in_lo, O + R));
    }
    if (G > 1 && send_warp && q >= out_qa + kMbars && q <= out_qb) {
      // the block after has read the entries of chunk q - 4
      const int i = q - kMbars - out_qa;
      mbar_wait(&empty[i % kMbars], (i / kMbars) & 1);
      if (l == 31 && q <= out_qb - kMbars) mbar_expect(&empty[i % kMbars], 4);
    }
    // the ring entry lane 0 reads at the chunk's first step; each step
    // reads the next one's ahead. An entry is written kChunk steps before
    // it is read, so the next step's is in the ring already, except across
    // a barrier.
    const int d_first = q * kChunk - lag;
    int4 next_e = *(const int4*)(in_ring + ((d_first - 1) & (kRing - 1)) * kSlot);
#pragma unroll 1
    for (int u = 0; warp_runs && u < kChunk; ++u) {
      const int d = d_first + u;
      const int c0 = d - k0;  // lane 0's column
      // the cell above lane 0, on diagonal d - 1: the last lane of the
      // thread before, one step ago
      int bM = __shfl_up_sync(kFull, s.M1[R - 1], 1);
      int bA[NPW];
#pragma unroll
      for (int pw = 0; pw < NPW; ++pw)
        bA[pw] = __shfl_up_sync(kFull, s.A1[pw][R - 1], 1);
      const bool run = active && c0 >= 0 && c0 - (R - 1) <= O;
      if (l == 0) {
        const bool ring_in = gw > 0 && run;
        const int e[kSlot] = {next_e.x, next_e.y, next_e.z, next_e.w};
        bM = ring_in ? e[0] : kNeg;
#pragma unroll
        for (int pw = 0; pw < NPW; ++pw) bA[pw] = ring_in ? e[1 + pw] : kNeg;
      }
      if (u + 1 < kChunk)
        next_e = *(const int4*)(in_ring + (d & (kRing - 1)) * kSlot);
      if (run) {
        uint16_t* p = bpj + (int64_t)d * W + k0;
        if (!scaled)
          step_exact<R, NPW, MODE == kExactAFirst>(s, P, ot, p, c0, k0, L, O,
                                                   bM, bA, bM_prev);
        else if (inner_rows && c0 >= R && c0 <= min(O, n_stage))
          step_scaled<R, NPW, false>(s, P, ot, p, c0, k0, L, O, bM, bA,
                                     bM_prev);
        else
          step_scaled<R, NPW, true>(s, P, ot, p, c0, k0, L, O, bM, bA,
                                    bM_prev);
        if (d == L + O && k0 <= L && L < k0 + R) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (k0 + r == L) score[job] = s.M1[r] / scale;
        }
        const int slot = (d & (kRing - 1)) * kSlot;
        int e[kSlot] = {s.M1[R - 1], 0, 0, 0};
#pragma unroll
        for (int pw = 0; pw < NPW; ++pw) e[1 + pw] = s.A1[pw][R - 1];
        if (out_ring != nullptr) {
          *(int4*)(out_ring + slot) = make_int4(e[0], e[1], e[2], e[3]);
        } else if (out_remote != 0) {
          st_async_v4(out_remote + 4 * slot, e[0], e[1], e[2], e[3],
                      out_full + 8 * ((q - out_qa) % kMbars));
        }
      }
      bM_prev = bM;
    }
    __syncthreads();
    if (G > 1 && recv && t == 0 && q - 1 >= in_qa &&
        q - 1 <= in_qb - kMbars)
      st_async_b32(word_back, q,
                   empty_back + 8 * ((q - 1 - in_qa) % kMbars));
  }
  // nothing is sent to a block after it has left
  if (G > 1) cg::this_cluster().sync();
}

// plan: int32 rows (job, rank in its group, group size, warps holding
// lanes); job < 0 marks an empty block of a cluster. Shared memory: the
// mbarriers, the rings, then the staged labels.
template <int R>
__global__ void __launch_bounds__(max_threads(R), 1)
    gotoh_fill_kernel(const int* __restrict__ par,
                      const int* __restrict__ seqs, uint16_t* __restrict__ bp,
                      int* __restrict__ score, const int4* __restrict__ plan,
                      int stage) {
  extern __shared__ uint64_t smem[];
  const int4 pl = plan[blockIdx.x];
  if (pl.x < 0) return;
  const Job jb = load_job(par, pl.x);
  uint64_t* mbar = smem;
  int* ring = (int*)(smem + kMbarBytes / 8);
  int* olab = ring + (blockDim.x / 32) * kRing * kSlot;
  // scaled arithmetic when every value of the job lies within +-2^20:
  // |M| <= max(match, mismatch) * min(V1, V2) + go[0] + ge[0] * max(V1,
  // V2) (the diagonal, then one gap of piece 0), and a gap value lies
  // within max(go + ge) of an M
  bool nonneg = jb.match >= 0 && jb.mismatch >= 0;
  int gog_max = 0;
#pragma unroll
  for (int pw = 0; pw < kMaxPw; ++pw) {  // pieces past npw are 0
    nonneg = nonneg && jb.go[pw] >= 0 && jb.ge[pw] >= 0;
    gog_max = max(gog_max, jb.go[pw] + jb.ge[pw]);
  }
  const int64_t bound = (int64_t)max(jb.match, jb.mismatch) *
                            min(jb.V1, jb.V2) +
                        jb.go[0] + (int64_t)jb.ge[0] * max(jb.V1, jb.V2) +
                        gog_max;
  const int mode = nonneg && bound < (1 << 20)
                       ? kScaled
                       : (jb.lane_is_i != jb.swap_pref ? kExactAFirst
                                                       : kExactXFirst);
#define FILL(NPW, MODE)                                                       \
  fill_job<R, NPW, MODE>(jb, pl.x, pl.y, pl.z, pl.w, seqs, bp, score, mbar, \
                         ring, olab, stage)
#define FILL_MODES(NPW)                                     \
  (mode == kScaled         ? FILL(NPW, kScaled)             \
   : mode == kExactAFirst ? FILL(NPW, kExactAFirst)         \
                          : FILL(NPW, kExactXFirst))
  switch (jb.npw) {
    case 1:
      FILL_MODES(1);
      break;
    case 2:
      FILL_MODES(2);
      break;
    default:
      FILL_MODES(3);
  }
#undef FILL_MODES
#undef FILL
}

// The traceback's row ring. Every move lowers the anti-diagonal by 1 or 2
// and the lane by 0 or 1, so when the walk is at (d, lane) and reaches
// diagonal d' <= d, its lane there lies in [lane - (d - d'), lane]. The
// rows of the kTbAhead diagonals below the walk sit in a ring in shared
// memory, each as the lanes [lane - kTbAhead, lane] of the walk's lane when
// it was copied; in a ring row, backpointer e of the buffer (counted from
// bp's last 16-byte boundary) sits at column e % kTbCols.
constexpr int kTbAhead = 96;
constexpr int kTbRing = 128;   // rows of the ring (a power of 2 > kTbAhead)
constexpr int kTbCols = 128;   // backpointers a ring row holds (a power of 2)
// shared memory of one job: the ring, then the walk's position (int64) and
// the lowest row in the ring that has landed
constexpr int kTbBytes = kTbRing * kTbCols * 2 + 16;

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

// One job a block of two warps. Warp 1 copies rows into the ring: it reads
// the walk's position, issues by cp.async (one lane an aligned 16-byte
// chunk) the rows that came within kTbAhead diagonals of it, waits for them
// and publishes the lowest row that has landed. Warp 0 walks: every lane
// holds the walk's state and takes the same step, reading the
// backpointer from the ring; it waits only when the walk reaches a row not
// yet published. Lane k % 32 of warp 0 keeps step k's pair; every 32 steps
// the warp stores them in one coalesced store.
__global__ void __launch_bounds__(64)
    gotoh_traceback_kernel(const uint16_t* __restrict__ bp,
                           const int* __restrict__ score,
                           const int* __restrict__ par, int* __restrict__ out,
                           int cap) {
  extern __shared__ uint16_t tb_smem[];
  uint16_t* ring = tb_smem;
  long long* pos = (long long*)(tb_smem + kTbRing * kTbCols);
  int* landed = (int*)(pos + 1);
  const int job = blockIdx.x, warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const Job jb = load_job(par, job);
  const bool lii = jb.lane_is_i;
  const int W = (lii ? jb.V1 : jb.V2) + 1;
  const uint16_t* bpj = bp + jb.bp_off;
  // backpointers are counted from the 16-byte boundary at or before bpj
  const char* base16 = (const char*)((uintptr_t)bpj & ~(uintptr_t)15);
  const int e0 = (int)(((uintptr_t)bpj & 15) >> 1);
  if (threadIdx.x == 0) {
    *pos = ((long long)(jb.V1 + jb.V2) << 32) | (lii ? jb.V1 : jb.V2);
    *landed = jb.V1 + jb.V2 + 1;
  }
  __syncthreads();

  if (warp == 1) {
    // the copier: rows below `low` are not issued yet
    int low = jb.V1 + jb.V2 + 1;
    for (;;) {
      const long long p = *(volatile long long*)pos;
      if (p < 0) break;  // the walk has ended
      const int d = (int)(p >> 32), lane = (int)(p & 0xffffffff);
      const int stop = max(0, d - kTbAhead);
      if (low <= stop) continue;
      for (int row = low - 1; row >= stop; --row) {
        const int e = e0 + row * W;
        const int c0 = (e + max(0, lane - kTbAhead)) >> 3;
        const int c = c0 + l;
        if (c <= (e + lane) >> 3)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                           smem_addr(ring + (row & (kTbRing - 1)) * kTbCols +
                                     ((8 * c) & (kTbCols - 1)))),
                       "l"(base16 + 16 * (int64_t)c)
                       : "memory");
      }
      asm volatile("cp.async.commit_group;\n\tcp.async.wait_all;" :::
                   "memory");
      __syncwarp();
      low = stop;
      if (l == 0) {
        asm volatile("fence.acq_rel.cta;" ::: "memory");
        st_release(landed, low);
      }
      if (low == 0) break;
    }
    return;
  }

  int i = jb.V1, j = jb.V2, comp = 0, k = 0, pa = 0, pb = 0;
  int d = i + j, e = e0 + d * W + (lii ? i : j), ready = d + 1;
  int2* rows = (int2*)(out + (int64_t)job * (cap + 1) * 2);
  while (d != 0) {
    if (d < ready) {  // a row not published yet: wait for the copier
      do ready = ld_acquire(landed);
      while (d < ready);
    }
    const int b = ring[((d & (kTbRing - 1)) * kTbCols) | (e & (kTbCols - 1))];
    const int code = b & 7;
    const int c = comp != 0 ? comp
                  : (code & 1) ? (code + 1) >> 1 : -(code >> 1);
    const bool diag = c == 0, ins = c > 0;
    const bool opened = (b >> (ins ? 2 + c : 5 - c)) & 1;
    const int a1 = diag || ins ? i - 1 : -1;
    const int a2 = diag || !ins ? j - 1 : -1;
    i -= diag || ins;
    j -= diag || !ins;
    d -= diag ? 2 : 1;
    e -= diag ? 2 * W + 1 : W + (ins == lii);
    comp = diag || opened ? 0 : c;
    if (l == 0)
      *(volatile long long*)pos = ((long long)d << 32) | (lii ? i : j);
    if ((k & 31) == l) {
      pa = a1;
      pb = a2;
    }
    if ((k & 31) == 31) rows[cap - k + 31 - l] = make_int2(pa, pb);
    ++k;
  }
  if (l < (k & 31)) rows[cap - (k & ~31) - l] = make_int2(pa, pb);
  if (l == 0) {
    rows[0] = make_int2(k, score[job]);
    *(volatile long long*)pos = -1;  // the copier may stop
  }
}

}  // namespace

// The launch of one plan: `n_blocks` blocks of `threads` threads in
// clusters of `cluster`, R = `lanes_per_thread` (4 or 8), `smem` bytes of
// dynamic shared memory holding the rings and `stage` labels.
extern "C" int gotoh_fill_launch(const int* par, const int* seqs, uint16_t* bp,
                                 int* score, const int* plan, int n_blocks,
                                 int cluster, int lanes_per_thread,
                                 int threads, int stage, int smem,
                                 void* stream) {
  const int need =
      kMbarBytes + (threads / 32) * kRing * kSlot * 4 + stage * 4;
  if (threads <= 0 || threads % 32 != 0 ||
      threads > max_threads(lanes_per_thread) ||
      cluster < 1 || cluster > 8 || n_blocks % cluster != 0 || stage < 0 ||
      smem < need)
    return (int)cudaErrorInvalidValue;
  void (*kernel)(const int*, const int*, uint16_t*, int*, const int4*, int);
  if (lanes_per_thread == 1)
    kernel = gotoh_fill_kernel<1>;
  else if (lanes_per_thread == 2)
    kernel = gotoh_fill_kernel<2>;
  else if (lanes_per_thread == 4)
    kernel = gotoh_fill_kernel<4>;
  else if (lanes_per_thread == 8)
    kernel = gotoh_fill_kernel<8>;
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, par, seqs, bp, score,
                           (const int4*)plan, stage);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The traceback over `n_jobs` jobs, one block of two warps each, with its
// row ring in dynamic shared memory. (`threads` must be 64.)
extern "C" int gotoh_traceback_launch(const uint16_t* bp, const int* score,
                                      const int* par, int* out, int n_jobs,
                                      int cap, int threads, void* stream) {
  if (threads != 64) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gotoh_traceback_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTbBytes);
  if (err != cudaSuccess) return (int)err;
  gotoh_traceback_kernel<<<n_jobs, threads, kTbBytes,
                           (cudaStream_t)stream>>>(bp, score, par, out, cap);
  return (int)cudaGetLastError();
}
