// The lane-sharded Gotoh fill (L5): one shard's chunk of diagonals (sm_90a).
//
// Replaces the JAX package's lane-sharded fill over a device mesh,
// centrolign_tpu/parallel/sharded_gotoh.py::_sharded_fill (scores) and
// ::_sharded_fill_bp (scores and uint16 backpointers), whose per-diagonal
// step (_make_step) is the int32 piecewise-affine Gotoh of ops/gotoh.py
// with the lanes (positions on the short side) cut into one block per
// shard and a one-lane halo passed to the right neighbour by ppermute.
//
// Here one process drives every shard (parallel/sharded_gotoh.py), each on
// a stream of its own. A launch fills one shard's chunk of up to H
// diagonals. The shard's lanes are cut into `nb` blocks of at most a few
// hundred lanes (ops/sharded_gotoh.py::block_starts), one thread block
// each, and every block works on H + its own lanes ("extended" lanes): the
// H lanes left of it are loaded from their values after the previous chunk
// (the block before it, or for block 0 the halo its left neighbour shard
// published, or MININF) and recomputed with it, the leftmost from MININF,
// so after h + 1 diagonals lanes 0..h of the extension are wrong and after
// at most H every own lane is exact (integer DP). The state is a pair of
// buffers (the chunk reads one and writes the other), so no block of a
// launch waits for another, and nothing waits inside a launch on another
// launch. The shard's last block then publishes its last H lanes in a halo
// slot of its own for the chunk.
//
// What bounds it on an H100. Each cell is about 3 + 18 npw int32
// operations (the bound's count); pair.fasta's 4356 x 3330 gap is 0.8 G of
// them, 0.05 ms at the card's int32 rate. A fill is a chain of V1 + V2 + 1
// dependent diagonal steps, each one shuffle, a shared-memory read and a
// cell's chain of maxima, so a step costs a block's issue of its lanes'
// cells or that chain, whichever is longer: the cut keeps a block's lanes
// few (its issue short) and spreads a shard over several SMs. Measured on
// an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md §6): pair.fasta's
// gap over 2 shards of one card in 5.0 ms, 122 launches, 0.66 us a
// diagonal (the first version: 53.2 ms, 242 launches); a 4,500 x 4,500
// pair in 5.1-6.3 ms over 1-4 shards of one card. Each step is still
// several times its chain and its issue (PERF.md §7).
//
// The design within a block is the Gotoh fill's (gotoh.cu): a striped
// anti-diagonal wavefront held in registers. Each thread holds R
// consecutive extended lanes: M of the last two diagonals and both gaps
// of each piece on the last one, loaded from the state once at the
// chunk's start and stored once at its end. The lane before a thread's
// first comes from the thread before by __shfl_up_sync; between warps it
// goes through a ring in shared memory, each warp trailing the one before
// it by kWarpLag steps and the block synchronising once per kChunk steps,
// so an entry is written a barrier before it is read. The other side's
// labels of the chunk are staged in shared memory. Plain int32 arithmetic
// with DPX maxima (__vibmax_s32 gives max(open, extend) and the "opened"
// bit, __vimax3_s32 the cell's M). The only per-diagonal traffic to device
// memory is the backpointers: R consecutive uint16 a thread, a warp's 32 R
// lanes side by side on the diagonal.
//
// Layouts (ops/sharded_gotoh.py): state (2, Bl, Q, Wl) by the chunk's
// parity, halo (Bl, Q, H), Q = 2 + 2 * MAX_PW planes (M of the last
// diagonal, M of the one before, I of each piece, D of each piece); bp
// (num_diags, Bl, Wl) uint16; score (Bl,) int32.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>

namespace {

constexpr int kNeg = -(1 << 30);  // MININF = -(2**31) // 2
constexpr int kMaxPw = 3;
constexpr int kQ = 2 + 2 * kMaxPw;
// diagonals between two barriers; ring entries per warp (four chunks);
// ints per entry (M and the along-lane gap of each piece)
constexpr int kChunk = 8;
constexpr int kRing = 4 * kChunk;
constexpr int kSlot = 1 + kMaxPw;
// steps by which a warp trails the warp before it: its ring entry for a
// diagonal is written kChunk steps before it is read
constexpr int kWarpLag = kChunk - 1;
constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
    const int* a;      // (Bl, W_total) lane-side labels
    const int* b;      // (Bl, Lb) other side, reversed and padded
    const int* V1;
    const int* V2;
    int Bl, W_total, Lb, match, mismatch, lane_is_i;
    int go[kMaxPw], ge[kMaxPw];
    int L0, Wl, H, nb, d0, nd;
    const int* prev;   // state after the previous chunk (Bl, Q, Wl)
    int* cur;          // state after this chunk
    const int* halo_in;
    int* halo_out;
    unsigned short* bp;
    int* score;
};

// A job's constants: the gap costs (open + extend, extend), the M-source
// codes of the along-lane gap A (I when lanes index i, else D) and of the
// across-lane gap X, and the shifts of their "opened" bits.
template <int NPW>
struct Params {
    int gog[NPW], ge[NPW], cA[NPW], cX[NPW];
    int a_shift, x_shift, match, mismatch;
};

template <int R, int NPW>
struct Lanes {
    int lab[R], M1[R], M2[R], A1[NPW][R], X1[NPW][R];
};

// One diagonal d on a thread's R lanes: lane r is global lane lane0 + r,
// column c = d - lane on the other side. Every lane outside the matrix is
// MININF, with the code of the first gap component; the masks and the
// code order are those of the JAX step. olab[dc - lane] is the label of
// column c. The lanes' backpointers go to `code`, stored by the caller
// after the step, so that nothing in memory orders one lane's cell after
// another's.
template <int R, int NPW, bool A_FIRST>
__device__ __forceinline__ void step(Lanes<R, NPW>& s, const Params<NPW>& P,
                                     const int* __restrict__ olab, int dc,
                                     int d, int lane0, int Ls, int Os,
                                     int bM, const int (&bA)[NPW],
                                     int bM_prev, unsigned short (&code)[R]) {
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
        const int lane = lane0 + r;
        const int c = d - lane;
        const bool in_m = lane >= 0 && lane <= Ls && c >= 0 && c <= Os;
        const bool a_ok = in_m && lane >= 1;
        const bool x_ok = in_m && c >= 1;
        const int up = r > 0 ? s.M1[r - 1] : bM;
        const int diag = r > 0 ? s.M2[r - 1] : bM_prev;
        const int left = s.M1[r];
        const int sc = s.lab[r] == olab[dc - lane] ? P.match : P.mismatch;
        int m = a_ok && c >= 1 ? diag + sc : kNeg;
        int a[NPW], x[NPW], bits_a = 0, bits_x = 0;
#pragma unroll
        for (int k = 0; k < NPW; ++k) {
            const int up_a = r > 0 ? s.A1[k][r - 1] : bA[k];
            bool pa, px;
            a[k] = __vibmax_s32(up - P.gog[k], up_a - P.ge[k], &pa);
            x[k] = __vibmax_s32(left - P.gog[k], s.X1[k][r] - P.ge[k], &px);
            if (!a_ok) a[k] = kNeg;
            if (!x_ok) x[k] = kNeg;
            bits_a |= (int)(pa && a[k] > kNeg) << k;
            bits_x |= (int)(px && x[k] > kNeg) << k;
            m = __vimax3_s32(m, a[k], x[k]);
        }
        const bool corner = lane == 0 && c == 0;
        if (corner) m = 0;
        if (!in_m) m = kNeg;
        int cd = 0;
#pragma unroll
        for (int k = NPW - 1; k >= 0; --k) {
            const bool eq_a = a[k] == m, eq_x = x[k] == m;
            if (A_FIRST) {
                cd = eq_x ? P.cX[k] : cd;
                cd = eq_a ? P.cA[k] : cd;
            } else {
                cd = eq_a ? P.cA[k] : cd;
                cd = eq_x ? P.cX[k] : cd;
            }
        }
        if (corner) cd = 0;
        code[r] = (unsigned short)((bits_a << P.a_shift) |
                                   (bits_x << P.x_shift) | cd);
        s.M2[r] = left;
        s.M1[r] = m;
#pragma unroll
        for (int k = 0; k < NPW; ++k) {
            s.A1[k][r] = a[k];
            s.X1[k][r] = x[k];
        }
    }
}

// grid (nb, Bl): block b of problem p. Shared memory: one ring per warp,
// then the other side's labels of the chunk.
template <int R, int NPW, bool A_FIRST>
__global__ void __launch_bounds__(kMaxThreads)
    sharded_gotoh_chunk_kernel(const Args g) {
    extern __shared__ int4 smem4[];  // 16-byte aligned ring entries
    int* smem = (int*)smem4;
    const int blk = blockIdx.x, p = blockIdx.y;
    // this block's own lanes [s0, s1) of the shard, as block_starts
    const int s0 = (int)((long long)blk * g.Wl / g.nb);
    const int s1 = (int)((long long)(blk + 1) * g.Wl / g.nb);
    const int H = g.H, E = H + s1 - s0;
    const int x0 = s0 - H;        // shard lane of extended lane 0
    const int g0 = g.L0 + x0;     // global lane of extended lane 0
    const int t = threadIdx.x, w = t >> 5, l = t & 31;
    const int nw = (E + 32 * R - 1) / (32 * R);  // warps that hold lanes
    const int e0 = t * R;
    const int v1 = g.V1[p], v2 = g.V2[p];
    const int Ls = g.lane_is_i ? v1 : v2, Os = g.lane_is_i ? v2 : v1;

    // the other side's labels of every (diagonal, lane) of the chunk:
    // columns c_lo .. c_lo + n_lab - 1 (the threads' lanes past E too)
    int* ring = smem;
    int* olab = smem + (blockDim.x / 32) * kRing * kSlot;
    const int span = (int)blockDim.x * R;
    const int c_lo = g.d0 - (g0 + span - 1);
    const int n_lab = g.nd + span - 1;
    const int* bq = g.b + (size_t)p * g.Lb;
    for (int k = t; k < n_lab; k += blockDim.x) {
        const long long ix = (long long)g.W_total + Os - (c_lo + k);
        olab[k] = (ix >= 0 && ix < g.Lb) ? bq[ix] : -2;
    }

    // each lane's row at the chunk's start: the left neighbour's halo left
    // of the shard, the previous chunk's state, MININF right of the shard
    // (stride 0: no row)
    const int* prev = g.prev + (size_t)p * kQ * g.Wl;
    const int* hin = g.halo_in ? g.halo_in + (size_t)p * kQ * H : nullptr;
    auto row = [&](int e, int& stride) -> const int* {
        const int x = x0 + e;
        stride = x < 0 ? (hin ? H : 0) : x < g.Wl ? g.Wl : 0;
        return x < 0 ? (hin ? hin + x + H : prev) : prev + x;
    };
    auto at = [](const int* src, int stride, int q) -> int {
        return stride ? src[q * stride] : kNeg;
    };
    const int qA = g.lane_is_i ? 2 : 2 + kMaxPw;
    const int qX = g.lane_is_i ? 2 + kMaxPw : 2;

    Lanes<R, NPW> s;
    const int* ap = g.a + (size_t)p * g.W_total;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int e = e0 + r, lane = g0 + e;
        int st;
        const int* src = row(e, st);
        s.lab[r] = (lane >= 0 && lane < g.W_total) ? ap[lane] : -1;
        s.M1[r] = at(src, st, 0);
        s.M2[r] = at(src, st, 1);
#pragma unroll
        for (int k = 0; k < NPW; ++k) {
            s.A1[k][r] = at(src, st, qA + k);
            s.X1[k][r] = at(src, st, qX + k);
        }
    }
    // the lane before the thread's first at the chunk's start: from the
    // thread before, for a warp's lane 0 from the state (MININF left of
    // extended lane 0)
    int bM_prev = __shfl_up_sync(kFull, s.M2[R - 1], 1);
    int bM0 = kNeg, bA0[NPW];
#pragma unroll
    for (int k = 0; k < NPW; ++k) bA0[k] = kNeg;
    if (l == 0) {
        bM_prev = kNeg;
        if (w > 0) {
            int st;
            const int* src = row(e0 - 1, st);
            bM_prev = at(src, st, 1);
            bM0 = at(src, st, 0);
#pragma unroll
            for (int k = 0; k < NPW; ++k) bA0[k] = at(src, st, qA + k);
        }
    }

    Params<NPW> P;
    const int a_shift = g.lane_is_i ? 3 : 6;
    P.a_shift = a_shift;
    P.x_shift = 9 - a_shift;
    P.match = g.match;
    P.mismatch = -g.mismatch;
#pragma unroll
    for (int k = 0; k < NPW; ++k) {
        P.gog[k] = g.go[k] + g.ge[k];
        P.ge[k] = g.ge[k];
        P.cA[k] = g.lane_is_i ? 1 + 2 * k : 2 + 2 * k;  // code of I or D
        P.cX[k] = 3 + 4 * k - P.cA[k];
    }
    __syncthreads();  // the labels are staged

    const int lag = w * kWarpLag;
    const int steps = g.nd + (nw - 1) * kWarpLag;
    const int n_q = (steps + kChunk - 1) / kChunk;
    const bool warp_runs = w < nw;
    const int* in_ring = ring + w * kRing * kSlot;
    int* out_ring =
        (l == 31 && w + 1 < nw) ? ring + (w + 1) * kRing * kSlot : nullptr;
    const int lane0 = g0 + e0;
    // own lanes, as global lanes
    const int own_lo = g.L0 + s0, own_hi = g.L0 + s1;
    const int opt_lane = Ls, opt_d = v1 + v2;
    // backpointer of lane0 on diagonal d: bp[d][p][lane0 - L0]
    const long long bp_lane = (long long)p * g.Wl + lane0 - g.L0;
    const long long bp_diag = (long long)g.Bl * g.Wl;

    for (int q = 0; q < n_q; ++q) {
#pragma unroll 1
        for (int u = 0; warp_runs && u < kChunk; ++u) {
            const int tt = q * kChunk + u - lag;  // the chunk's diagonal
            if (tt < 0 || tt >= g.nd) continue;
            const int d = g.d0 + tt;
            // the lane before the thread's first on diagonal d - 1: the
            // thread before's last; for a warp's lane 0 the warp before's
            // ring entry (every lane reads it: one broadcast, no branch),
            // at the chunk's first diagonal the state, MININF for warp 0
            const int4 en = *(const int4*)(in_ring +
                                           ((tt - 1) & (kRing - 1)) * kSlot);
            const int ev[kSlot] = {en.x, en.y, en.z, en.w};
            int bM = __shfl_up_sync(kFull, s.M1[R - 1], 1);
            int bA[NPW];
#pragma unroll
            for (int k = 0; k < NPW; ++k)
                bA[k] = __shfl_up_sync(kFull, s.A1[k][R - 1], 1);
            if (l == 0) {
                bM = w == 0 ? kNeg : tt == 0 ? bM0 : ev[0];
#pragma unroll
                for (int k = 0; k < NPW; ++k)
                    bA[k] = w == 0 ? kNeg : tt == 0 ? bA0[k] : ev[1 + k];
            }
            unsigned short code[R];
            step<R, NPW, A_FIRST>(s, P, olab, d - c_lo, d, lane0, Ls, Os, bM,
                                  bA, bM_prev, code);
            if (g.bp != nullptr) {
                unsigned short* bp_row = g.bp + (d * bp_diag + bp_lane);
#pragma unroll
                for (int r = 0; r < R; ++r)
                    if (lane0 + r >= own_lo && lane0 + r < own_hi)
                        bp_row[r] = code[r];
            }
            if (d == opt_d && opt_lane >= max(lane0, own_lo) &&
                opt_lane < min(lane0 + R, own_hi)) {
#pragma unroll
                for (int r = 0; r < R; ++r)
                    if (lane0 + r == opt_lane) g.score[p] = s.M1[r];
            }
            if (out_ring != nullptr) {
                int* en = out_ring + (tt & (kRing - 1)) * kSlot;
                en[0] = s.M1[R - 1];
#pragma unroll
                for (int k = 0; k < NPW; ++k) en[1 + k] = s.A1[k][R - 1];
            }
            bM_prev = bM;
        }
        __syncthreads();
    }

    // the own lanes' state after the chunk, and the shard's last H lanes
    // as its halo
    int* cur = g.cur + (size_t)p * kQ * g.Wl;
    int* hout = g.halo_out ? g.halo_out + (size_t)p * kQ * H : nullptr;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int e = e0 + r, x = x0 + e;
        if (e < H || e >= E) continue;
        int v[kQ];
        v[0] = s.M1[r];
        v[1] = s.M2[r];
#pragma unroll
        for (int k = 0; k < NPW; ++k) {
            v[qA + k] = s.A1[k][r];
            v[qX + k] = s.X1[k][r];
        }
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
            const int k = q < 2 ? 0 : (q - 2) % kMaxPw;
            if (q >= 2 && k >= NPW) continue;
            cur[q * g.Wl + x] = v[q];
            if (hout && x >= g.Wl - H) hout[q * H + x - (g.Wl - H)] = v[q];
        }
    }
}

using Kernel = void (*)(const Args);

template <int R, int NPW>
Kernel pick_order(bool a_first) {
    return a_first ? sharded_gotoh_chunk_kernel<R, NPW, true>
                   : sharded_gotoh_chunk_kernel<R, NPW, false>;
}

template <int R>
Kernel pick_npw(int npw, bool a_first) {
    return npw == 1 ? pick_order<R, 1>(a_first)
           : npw == 2 ? pick_order<R, 2>(a_first)
                      : pick_order<R, 3>(a_first);
}

// A fill's constants, the same for every shard and chunk.
struct Common {
    int Bl, W_total, Lb, match, mismatch, npw, lane_is_i, swap_pref;
    int go[kMaxPw], ge[kMaxPw];
    int Wl, H, nb, num_diags, R, threads;
};

// Checks a launch shape: every block holds its H + own lanes (threads * R
// of them) and owns at least H lanes. Returns the dynamic shared memory of
// a chunk of nd diagonals, or -1.
int launch_smem(const Common& cm, int nd) {
    const int R = cm.R;
    const int widest = (cm.Wl + cm.nb - 1) / max(cm.nb, 1);
    if (cm.npw < 1 || cm.npw > kMaxPw || cm.H < 1 || cm.nb < 1 ||
        cm.Wl / cm.nb < cm.H || (R != 1 && R != 2 && R != 4 && R != 8) ||
        cm.threads < 32 || cm.threads % 32 != 0 ||
        cm.threads > kMaxThreads || cm.threads * R < cm.H + widest ||
        cm.Bl > 65535 || nd < 1)
        return -1;
    const int smem = ((cm.threads / 32) * kRing * kSlot + nd +
                      cm.threads * R) * (int)sizeof(int);
    return smem > 48 * 1024 ? -1 : smem;
}

cudaError_t launch_chunk(const Common& cm, Args g, cudaStream_t stream) {
    if (cm.Bl <= 0 || g.nd <= 0) return cudaSuccess;
    const int smem = launch_smem(cm, g.nd);
    if (smem < 0) return cudaErrorInvalidValue;
    g.Bl = cm.Bl;
    g.W_total = cm.W_total;
    g.Lb = cm.Lb;
    g.match = cm.match;
    g.mismatch = cm.mismatch;
    g.lane_is_i = cm.lane_is_i;
    for (int k = 0; k < kMaxPw; ++k) {
        g.go[k] = cm.go[k];
        g.ge[k] = cm.ge[k];
    }
    g.Wl = cm.Wl;
    g.H = cm.H;
    g.nb = cm.nb;
    // the M-source search checks the first of each (I, D) pair first: I,
    // or D under swap_pref
    const bool a_first = (cm.lane_is_i != 0) != (cm.swap_pref != 0);
    const int R = cm.R;
    const Kernel k = R == 1   ? pick_npw<1>(cm.npw, a_first)
                     : R == 2 ? pick_npw<2>(cm.npw, a_first)
                     : R == 4 ? pick_npw<4>(cm.npw, a_first)
                              : pick_npw<8>(cm.npw, a_first);
    k<<<dim3(cm.nb, cm.Bl), cm.threads, smem, stream>>>(g);
    return cudaGetLastError();
}

}  // namespace

// The columns of a shard's row in sharded_gotoh_run's `shards` table.
enum {
    kA, kB, kV1, kV2, kState, kOut, kIn, kBp, kScore, kStream, kDevice,
    kL0, kCaller, kShardCols
};
// The kinds of ops (parallel/sharded_gotoh.py::chunk_schedule).
enum { kStart, kWait, kCopy, kFill, kRecord, kJoin };

// A whole fill's schedule, queued from here: `ops` (n_ops rows of kind,
// shard, other shard, chunk) over the shards' rows (int64, kShardCols
// each: pointers a, b, V1, V2, state (2, Bl, Q, Wl), halo out slots
// (chunks, Bl, Q, H) or 0, halo in slots (peer copies) or 0, bp or 0,
// score; its stream, device and first lane L0; the caller's current stream
// on its device). `joins` lists the caller streams that wait for every
// shard at a join. The events are made here and released once their work
// has run.
extern "C" int sharded_gotoh_run(
        const long long* shards, int n_shards, const int* ops, int n_ops,
        int Bl, int W_total, int Lb, int match, int mismatch, int go0,
        int go1, int go2, int ge0, int ge1, int ge2, int npw, int lane_is_i,
        int swap_pref, int Wl, int H, int nb, int num_diags,
        int lanes_per_thread, int threads, const long long* joins,
        int n_joins) {
    const Common cm = {Bl, W_total, Lb, match, mismatch, npw, lane_is_i,
                       swap_pref, {go0, go1, go2}, {ge0, ge1, ge2}, Wl, H,
                       nb, num_diags, lanes_per_thread, threads};
    if (H < 1 || n_shards < 1 || launch_smem(cm, min(H, num_diags)) < 0)
        return (int)cudaErrorInvalidValue;
    const int chunks = (num_diags + H - 1) / H;
    const long long slot = (long long)Bl * kQ * H;  // ints
    cudaEvent_t* events =
        (cudaEvent_t*)calloc((size_t)n_shards * chunks, sizeof(cudaEvent_t));
    int* last = (int*)calloc((size_t)n_shards, sizeof(int));
    if (!events || !last) {
        free(events);
        free(last);
        return (int)cudaErrorMemoryAllocation;
    }
    int prev_device = -1;
    cudaGetDevice(&prev_device);
    cudaError_t err = cudaSuccess;
    auto col = [&](int k, int c) { return shards[(size_t)k * kShardCols + c]; };
    auto stream_of = [&](int k) { return (cudaStream_t)col(k, kStream); };
    for (int i = 0; i < n_ops && err == cudaSuccess; ++i) {
        const int kind = ops[4 * i], k = ops[4 * i + 1];
        const int j = ops[4 * i + 2], c = ops[4 * i + 3];
        if (k < 0 || k >= n_shards || c < 0 || c >= chunks) {
            err = cudaErrorInvalidValue;
            break;
        }
        err = cudaSetDevice((int)col(k, kDevice));
        if (err != cudaSuccess) break;
        if (kind == kStart) {
            cudaEvent_t e;
            err = cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
            if (err == cudaSuccess)
                err = cudaEventRecord(e, (cudaStream_t)col(k, kCaller));
            if (err == cudaSuccess)
                err = cudaStreamWaitEvent(stream_of(k), e, 0);
            cudaEventDestroy(e);
        } else if (kind == kWait) {
            cudaEvent_t e = j >= 0 && j < n_shards
                                ? events[(size_t)j * chunks + c] : nullptr;
            err = e ? cudaStreamWaitEvent(stream_of(k), e, 0)
                    : cudaErrorInvalidValue;
        } else if (kind == kCopy) {
            if (k == 0 || !col(k, kIn) || !col(k - 1, kOut)) {
                err = cudaErrorInvalidValue;
                break;
            }
            err = cudaMemcpyPeerAsync(
                (int*)col(k, kIn) + c * slot, (int)col(k, kDevice),
                (const int*)col(k - 1, kOut) + c * slot,
                (int)col(k - 1, kDevice), slot * sizeof(int), stream_of(k));
        } else if (kind == kFill) {
            Args g = {};
            g.a = (const int*)col(k, kA);
            g.b = (const int*)col(k, kB);
            g.V1 = (const int*)col(k, kV1);
            g.V2 = (const int*)col(k, kV2);
            g.L0 = (int)col(k, kL0);
            g.d0 = c * H;
            g.nd = min(H, num_diags - c * H);
            int* state = (int*)col(k, kState);
            const long long buf = (long long)Bl * kQ * Wl;
            g.prev = state + ((c + 1) % 2) * buf;
            g.cur = state + (c % 2) * buf;
            // the left neighbour's slot c - 1: copied into this shard's
            // slots, or read where it was written
            if (g.L0 > 0 && c > 0)
                g.halo_in = col(k, kIn)
                                ? (const int*)col(k, kIn) + (c - 1) * slot
                                : (const int*)col(k - 1, kOut) + (c - 1) * slot;
            g.halo_out = col(k, kOut) ? (int*)col(k, kOut) + c * slot
                                      : nullptr;
            g.bp = (unsigned short*)col(k, kBp);
            g.score = (int*)col(k, kScore);
            err = launch_chunk(cm, g, stream_of(k));
        } else if (kind == kRecord) {
            cudaEvent_t& e = events[(size_t)k * chunks + c];
            if (e == nullptr)
                err = cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
            if (err == cudaSuccess) err = cudaEventRecord(e, stream_of(k));
            last[k] = c;
        } else if (kind == kJoin) {
            cudaEvent_t e = events[(size_t)k * chunks + last[k]];
            for (int q = 0; q < n_joins && err == cudaSuccess; ++q)
                err = e ? cudaStreamWaitEvent((cudaStream_t)joins[q], e, 0)
                        : cudaErrorInvalidValue;
        } else {
            err = cudaErrorInvalidValue;
        }
    }
    for (size_t q = 0; q < (size_t)n_shards * chunks; ++q)
        if (events[q]) cudaEventDestroy(events[q]);
    free(events);
    free(last);
    if (prev_device >= 0) cudaSetDevice(prev_device);
    return (int)err;
}
