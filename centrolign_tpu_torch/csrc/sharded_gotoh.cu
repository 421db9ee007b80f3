// The lane-sharded Gotoh fill (L5): one shard's chunk of diagonals.
//
// Replaces the JAX package's lane-sharded fill over a device mesh,
// centrolign_tpu/parallel/sharded_gotoh.py::_sharded_fill (scores) and
// ::_sharded_fill_bp (scores and uint16 backpointers), whose per-diagonal
// step (_make_step) is the int32 piecewise-affine Gotoh of ops/gotoh.py
// with the lanes (positions on the short side) cut into one block per
// shard and a one-lane halo passed to the right neighbour by ppermute.
//
// Here one process drives every shard (parallel/sharded_gotoh.py). A
// launch fills one shard's lane block over a chunk of up to H diagonals on
// H + Wl "extended" lanes: the H lanes left of the block are loaded from
// the left neighbour's published halo (its last H lanes after its previous
// chunk) and recomputed with it, the leftmost from MININF, so after h + 1
// diagonals lanes 0..h of the extension are wrong and after at most H
// every own lane is exact (integer DP). The launch then publishes its own
// last H lanes. One launch and one halo of H lanes per chunk, where the
// JAX scan moves one lane per diagonal. The halo moves between devices
// outside the kernel (peer copies ordered on the streams); nothing waits
// inside a launch on another launch.
//
// One block a problem of the shard, a strided loop over the extended lanes
// of each diagonal, a barrier between diagonals. The state (M of the last
// three diagonals, I and D per piece of the last two) lives in a device
// scratch per shard, which carries the own lanes from chunk to chunk; a
// block touches only its problem's rows, which stay in L1/L2.
//
// Bound on this card: the dependent diagonal steps. A step is a handful of
// integer operations per lane and a block barrier; for a 4,500 x 4,500 gap
// 9,001 steps of ~4,600 lanes, about 40 operations a cell, are 0.8 GOP,
// microseconds of the card's integer rate, while the steps cost a barrier
// and a pass over the lanes each (several microseconds). The design keeps
// launches and halo copies to one per chunk of H diagonals, not one per
// diagonal; a shard's lanes in registers and shards run concurrently on
// one card are later work.
//
// Layouts (ops/sharded_gotoh.py): state (Bl, PLANES, E), E = H + Wl; halo
// (Bl, HALO_Q, H); bp (num_diags, Bl, Wl) uint16; score (Bl,) int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 30);  // MININF = -(2**31) // 2
constexpr int MAX_PW = 3;
constexpr int PLANES = 3 + 4 * MAX_PW;
constexpr int HALO_Q = 2 + 2 * MAX_PW;

__device__ __forceinline__ int i_plane(int buf, int k) {
    return 3 + buf * MAX_PW + k;
}
__device__ __forceinline__ int d_plane(int buf, int k) {
    return 3 + 2 * MAX_PW + buf * MAX_PW + k;
}

struct Gaps {
    int go[MAX_PW];
    int ge[MAX_PW];
};

__global__ void __launch_bounds__(1024) sharded_gotoh_chunk_kernel(
        const int* __restrict__ a, const int* __restrict__ b,
        const int* __restrict__ V1, const int* __restrict__ V2, int Bl,
        int W_total, int Lb, int match, int mismatch, Gaps gaps, int npw,
        int lane_is_i, int swap_pref, int L0, int Wl, int H, int d0, int nd,
        int* __restrict__ state, const int* __restrict__ halo_in,
        int* __restrict__ halo_out, unsigned short* __restrict__ bp,
        int* __restrict__ score) {
    const int p = blockIdx.x;
    const int E = H + Wl;
    int* st = state + (size_t)p * PLANES * E;
    const int* ap = a + (size_t)p * W_total;
    const int* bq = b + (size_t)p * Lb;
    const int v1 = V1[p], v2 = V2[p];
    const int other = lane_is_i ? v2 : v1;
    const int opt_d = v1 + v2;
    const int opt_lane = lane_is_i ? v1 : v2;

    // the left neighbour's last H lanes at d0 - 1 and d0 - 2
    {
        const int m1 = (d0 + 2) % 3, m2 = (d0 + 1) % 3, x1 = (d0 + 1) & 1;
        const int* h = halo_in ? halo_in + (size_t)p * HALO_Q * H : nullptr;
        for (int e = threadIdx.x; e < H; e += blockDim.x) {
            st[m1 * E + e] = h ? h[e] : NEG;
            st[m2 * E + e] = h ? h[H + e] : NEG;
            for (int k = 0; k < MAX_PW; ++k) {
                st[i_plane(x1, k) * E + e] = h ? h[(2 + k) * H + e] : NEG;
                st[d_plane(x1, k) * E + e] =
                    h ? h[(2 + MAX_PW + k) * H + e] : NEG;
            }
        }
    }
    __syncthreads();

    for (int d = d0; d < d0 + nd; ++d) {
        const int c3 = d % 3, p3 = (d + 2) % 3, q3 = (d + 1) % 3;
        const int c2 = d & 1, p2 = c2 ^ 1;
        const int* M1 = st + p3 * E;
        const int* M2 = st + q3 * E;
        for (int e = threadIdx.x; e < E; e += blockDim.x) {
            const int lane = L0 - H + e;
            const int i = lane_is_i ? lane : d - lane;
            const int j = lane_is_i ? d - lane : lane;
            const bool in_m = i >= 0 && i <= v1 && j >= 0 && j <= v2;
            const bool i_pos = i >= 1, j_pos = j >= 1;
            const bool corner = i == 0 && j == 0;
            const int mc = M1[e];
            const int ml = e > 0 ? M1[e - 1] : NEG;
            const int M_up = lane_is_i ? ml : mc;
            const int M_left = lane_is_i ? mc : ml;
            int mnew = NEG;
            if (in_m && i_pos && j_pos) {
                const int m2l = e > 0 ? M2[e - 1] : NEG;
                const int sc = ap[lane] == bq[W_total + other - d + lane]
                                   ? match : -mismatch;
                mnew = m2l + sc;
            }
            int iv[MAX_PW], dv[MAX_PW], io[MAX_PW], dop[MAX_PW];
#pragma unroll
            for (int k = 0; k < MAX_PW; ++k) {
                if (k >= npw) break;
                const int* I1 = st + i_plane(p2, k) * E;
                const int* D1 = st + d_plane(p2, k) * E;
                const int I_up = lane_is_i ? (e > 0 ? I1[e - 1] : NEG) : I1[e];
                const int D_left = lane_is_i ? D1[e] : (e > 0 ? D1[e - 1] : NEG);
                const int gog = gaps.go[k] + gaps.ge[k];
                io[k] = M_up - gog;
                dop[k] = M_left - gog;
                iv[k] = (in_m && i_pos) ? max(io[k], I_up - gaps.ge[k]) : NEG;
                dv[k] = (in_m && j_pos) ? max(dop[k], D_left - gaps.ge[k])
                                        : NEG;
                mnew = max(mnew, max(iv[k], dv[k]));
            }
            if (corner) mnew = 0;
            if (!in_m) mnew = NEG;
            st[c3 * E + e] = mnew;
#pragma unroll
            for (int k = 0; k < MAX_PW; ++k) {
                if (k >= npw) break;
                st[i_plane(c2, k) * E + e] = iv[k];
                st[d_plane(c2, k) * E + e] = dv[k];
            }
            if (e < H) continue;
            if (bp) {
                // the first of the pieces' components (I before D, D
                // before I when swap_pref) equal to M, else the diagonal
                int code = 0;
#pragma unroll
                for (int k = MAX_PW - 1; k >= 0; --k) {
                    if (k >= npw) continue;
                    const int first = swap_pref ? dv[k] : iv[k];
                    const int second = swap_pref ? iv[k] : dv[k];
                    const int c_first = swap_pref ? 2 + 2 * k : 1 + 2 * k;
                    const int c_second = swap_pref ? 1 + 2 * k : 2 + 2 * k;
                    if (second == mnew) code = c_second;
                    if (first == mnew) code = c_first;
                }
                if (corner) code = 0;
#pragma unroll
                for (int k = 0; k < MAX_PW; ++k) {
                    if (k >= npw) break;
                    code |= (iv[k] == io[k] && iv[k] > NEG) << (3 + k);
                    code |= (dv[k] == dop[k] && dv[k] > NEG) << (6 + k);
                }
                bp[((size_t)d * Bl + p) * Wl + (e - H)] = (unsigned short)code;
            }
            if (d == opt_d && lane == opt_lane) score[p] = mnew;
        }
        __syncthreads();
    }

    if (halo_out) {
        const int last = d0 + nd - 1;
        const int l3 = last % 3, l3p = (last + 2) % 3, l2 = last & 1;
        int* h = halo_out + (size_t)p * HALO_Q * H;
        for (int e = threadIdx.x; e < H; e += blockDim.x) {
            const int x = E - H + e;
            h[e] = st[l3 * E + x];
            h[H + e] = st[l3p * E + x];
            for (int k = 0; k < MAX_PW; ++k) {
                h[(2 + k) * H + e] = st[i_plane(l2, k) * E + x];
                h[(2 + MAX_PW + k) * H + e] = st[d_plane(l2, k) * E + x];
            }
        }
    }
}

}  // namespace

extern "C" int sharded_gotoh_chunk_launch(
        const void* a, const void* b, const void* V1, const void* V2, int Bl,
        int W_total, int Lb, int match, int mismatch, int go0, int go1,
        int go2, int ge0, int ge1, int ge2, int npw, int lane_is_i,
        int swap_pref, int L0, int Wl, int H, int d0, int nd, void* state,
        const void* halo_in, void* halo_out, void* bp, void* score,
        int threads, void* stream) {
    if (Bl <= 0 || nd <= 0) return 0;
    if (npw < 1 || npw > MAX_PW || H < 1 || H > Wl || threads < 32 ||
        threads > 1024)
        return (int)cudaErrorInvalidValue;
    Gaps gaps{{go0, go1, go2}, {ge0, ge1, ge2}};
    sharded_gotoh_chunk_kernel<<<Bl, threads, 0, (cudaStream_t)stream>>>(
        (const int*)a, (const int*)b, (const int*)V1, (const int*)V2, Bl,
        W_total, Lb, match, mismatch, gaps, npw, lane_is_i, swap_pref, L0,
        Wl, H, d0, nd, (int*)state, (const int*)halo_in, (int*)halo_out,
        (unsigned short*)bp, (int*)score);
    return (int)cudaGetLastError();
}
