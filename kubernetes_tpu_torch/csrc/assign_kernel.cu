// The joint-assignment solve K7 of the optimizing profile, written by
// hand for Hopper (sm_90a).
//
// Replaces kubernetes_tpu/scheduler/optimizer/ops/assign.py
// _auction_assign_fn (:61) and _beam_assign_fn (:144), programs that XLA
// fuses (no Pallas source). Both read fit u8[P, N], score i64[P, N],
// req/commit i64[P, 4], check u8[P, 4] and cap i64[N, 4] and write
// owner i32[P] (a node per slot, -1 unassigned). Every sum, difference
// and product of the reference's int64 arithmetic runs in u64 here, so it
// wraps as the reference's does; compares are on int64.
//
// K7a, the auction (assign_auction_kernel<SLAB>), ONE cooperative launch
// (cudaLaunchCooperativeKernel, one block of 512 threads an SM at most),
// `rounds` rounds of
//   bid:   util[p, n] = fit && used[n] + req[p] <= cap[n] on every checked
//          row ? score*N + (p + n) % N - price[n] : NEG for each slot p of
//          the round's list; v1, n1 = the maximum and its first column, v2
//          = the maximum of the other columns; valid = v1 > NEG; bid = (v2
//          > NEG ? v1 - v2 : 0) + max(1, eps0 >> min(t, 62)); key =
//          clip(prio, 0, 2^14-1) << 48 | clip(bid, 0, 2^31-1) << 16 |
//          clip(P - order, 0, 2^16-1); atomicMax(win_key[n1], key) where
//          valid; a slot with a fit column goes on the next round's list;
//   seat:  with keys unique, node n's winner is the one slot whose key
//          equals win_key[n], found from its low bits (the rank) in a
//          table the prologue fills; with repeated keys, a claim phase
//          takes win_p[n] = atomicMin over the slots holding the winning
//          key (the reference's first argmax). The winner's commit goes
//          into used[n], max(bid, 1) onto price[n], and owner[w] = n.
//   Node state. Block b owns the node tile g = b % T (T = ceil(N /
//   2,048) tiles of a multiple of 64 columns) and keeps its price, used,
//   cap and room = cap - used in shared memory, as structs of arrays, for
//   the whole launch. Where those tiles outnumber the co-resident blocks
//   (N > 270,336 on an H100's 132 SMs), there is one tile a co-resident
//   block instead, and each block keeps its tile's state in a slab of
//   device memory of its own (read through L1), so any N runs. A round
//   starts by seating the last round's winners on the tile (every block
//   of the tile's group alike; one writes owner), so its warps walk slot
//   rows across node state held by the block, not once per row from L2,
//   and a round is bid -> grid sync when the keys
//   are unique (a prologue sets a bit per clip(P - order) with atomicOr;
//   a bit set twice takes the general path, bid -> sync -> claim ->
//   sync). A slot on the list that won last round is skipped: its key
//   equals win_key at its n1 (or win_p names it). win_key and win_p
//   rotate through three buffers, each reset two rounds after it was
//   written. Where every used, cap and checked req is within 2^61 (sums
//   cannot wrap), used + req <= cap is read as req <= room, half the
//   shared-memory bytes; else as the wrapping sum.
//   Rows. The round's list of L slots is cut into (row, segment) items:
//   s = clamp(warps of the tile group / L, 1, ...) segments a tile, so a
//   late round's few rows are spread over every warp (64 columns a warp
//   at least). A warp walks its segment two columns a lane (lane l: c0 +
//   2l + 64j and the next column, 16-byte score and 2-byte fit loads, four
//   pairs in flight beside the four it works on (two in the slab
//   instance, within 128 registers), the node state a pair at a time),
//   keeps (v1, n1, v2) in increasing column order and merges the
//   lanes by shuffles, the lower column winning equal values.
//   A row of more than one segment is merged by lane (the same merge: the
//   loser's v1 goes into v2) before its bid is formed: in one tile its
//   segments (a power of two) are warps of one block, which meet in
//   shared memory; over several tiles each segment's partial goes to
//   device memory and the warp whose atomic ticket comes last merges
//   (lane l folds the partials l, l + 32, ... before the shuffles).
//   64-bit atomicMax and atomicMin commute, so the result does not depend
//   on the order the atomics land in, nor on the list's order. A round in
//   which no slot bids changes nothing, so no later round can bid either:
//   the kernel stops there (its count of bids is read by every thread
//   after the bid's grid sync, so they stop together).
// K7b, the beam (assign_beam_kernel, K = 4, C = 4, P <= 64), ONE launch of
//   P blocks of 512 threads in two phases.
//   A: block p lists slot p's row: u0[n] = fit && req <= cap on every
//      checked row ? score : NEG, the utility of every node a beam has
//      not placed on (its used is 0), sorted by (u0 desc, node asc), the
//      first Lp = min(N, C + p) entries. Its threads hold up to 16
//      consecutive columns each in registers and list one value level at
//      a time: a pass counts the entries equal to the level, ranks them
//      in node order by a block prefix sum and writes the first of them,
//      and finds the next level, the maximum below it (one barrier a
//      pass; a row's top Lp spans few levels when scores repeat). The
//      block that takes the last atomic ticket (after a __threadfence;
//      the ticket lies in the launch's scratch, zeroed on its stream)
//      runs B.
//   B: one warp a beam walks the P slots. A beam has placed on at most p
//      nodes before step p, so its top C is the top C of the first C
//      entries of slot p's list that it has not placed on and of its
//      placed ("touched") nodes, whose utility is recomputed from their
//      used (any sign of commit). The touched nodes, their used, cap and
//      this row's fit and score sit in a table in shared memory; each
//      lane sorts its three candidates and C rounds of a warp's first
//      (REDUX max of the high, then of the low words, then min of the
//      index) give the beam's top C; K rounds over the K * (C + 1)
//      successors (C picks and a skip) give the top K by (value desc,
//      index asc), each warp takes its child's parent and node, copies the parent's table and
//      choices into its own and adds the pick. The next slot's list and
//      the table's next-row fit and score load while a step runs, so a
//      step waits on shared memory and barriers only. Nothing of size N
//      is read after A; owner is the choice row of the first maximum of
//      acc.
//
// Bounds. Bytes: the inputs read once, fit and score, P x N x 9 B, and the
// small tables (req, commit, check, cap, prio, order), over 3.35 TB/s:
// 5.6 us at (P, N) = (2,048, 1,024), 0.090 ms at (4,096, 8,192). The
// auction re-reads the row of every slot that bids in a round
// (chip_smoke.py assign_rounds_bound_ms counts those rows) and waits for
// one or two grid syncs a round (assign_sync_bound_ms: the syncs run
// times the grid-sync floor of csrc/chain_floor.cu at the auction's
// grid). The beam's phase B is a chain of P dependent steps of four warps
// (assign_beam_chain_bound_ms: P times the chain floor of a 128-thread
// block).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

typedef long long i64;
typedef unsigned long long u64;

constexpr i64 NEG = -(1LL << 60);          // the reference's _NEG
constexpr i64 SKIP_PENALTY = 1LL << 40;    // the beam's skip penalty
constexpr i64 NO_FIT = -(1LL << 58);       // an infeasible candidate
constexpr i64 EMPTY = INT64_MIN;           // below every util
constexpr int NO_INDEX = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr int RES = 4;

constexpr int AUCTION_THREADS = 512;
constexpr int AUCTION_WARPS = AUCTION_THREADS / 32;
constexpr int AUCTION_BLOCKS_PER_SM = 1;
constexpr int TILE_MAX = 2048;      // nodes a block stages
constexpr int SEG_MAX = 32;         // segments a row at most, but one a tile
constexpr int STEP = 64;            // columns a warp loads at once
constexpr int UNROLL = 4;           // pairs a lane keeps in flight
constexpr int UNROLL_SLAB = 2;      // the same, node state in device memory
constexpr int RANK_WORDS = (1 << 16) / 32;
constexpr int NODE_SMEM = 8 + 3 * RES * 8;  // price, used, cap, room

constexpr int BEAM_THREADS = 512;
constexpr int BEAM_WARPS = BEAM_THREADS / 32;
constexpr int BEAM_K = 4;
constexpr int BEAM_C = 4;
constexpr int BEAM_MAX_P = 64;
constexpr int BEAM_LIST = BEAM_C + BEAM_MAX_P - 1;
constexpr int BEAM_E = 16;          // columns a lane holds in phase A

__device__ __forceinline__ i64 wadd(i64 a, i64 b) {
    return (i64)((u64)a + (u64)b);
}
__device__ __forceinline__ i64 wsub(i64 a, i64 b) {
    return (i64)((u64)a - (u64)b);
}
__device__ __forceinline__ i64 wmul(i64 a, i64 b) {
    return (i64)((u64)a * (u64)b);
}

// (value desc, index asc): does (v, i) come before (w, j)?
__device__ __forceinline__ bool before(i64 v, int i, i64 w, int j) {
    return v > w || (v == w && i < j);
}

// -- K7a: the auction --------------------------------------------------------

// a segment's top two: v1 at column i1 (the first of equals), v2 the
// highest of its other columns; any: a fit column in the segment
struct Partial {
    i64 v1, v2;
    int i1, any;
};

struct Tiles {
    int T, tile;
};

__host__ __device__ inline Tiles tiles_of(int N) {
    Tiles t;
    t.T = (N + TILE_MAX - 1) / TILE_MAX;
    const int per = (N + t.T - 1) / t.T;
    t.tile = (per + STEP - 1) / STEP * STEP;
    return t;
}

struct AuctionArgs {
    const uint8_t* fit;
    const i64* score;
    const i64* req;
    const i64* commit;
    const uint8_t* check;
    const i64* cap;
    const int* prio;
    const int* order;
    i64 eps0;
    int P, N, rounds, T, tile, pstride;
    int* owner;
    // scratch (auction_layout)
    i64* win_key;     // [3][N]: by round, mod 3
    i64* bid;         // [P]
    i64* key;         // [P]
    Partial* part;    // [P][pstride]: a row's segment partials
    i64* slab;        // [blocks][tile * 13]: the tiles' state, or null
    int* win_p;       // [3][N]
    int* n1;          // [P]: the bid's column, -1 none
    int* list;        // [2][P]: the slots a round walks
    int* tick;        // [P]
    int* count;       // [rounds + 1]: list lengths
    unsigned* seen;   // [RANK_WORDS]
    int* inv;         // [2^16]: the slot of a rank (unique path)
    int* bids;        // [rounds], then the general-path flag
};

// merge B's (v1, i1, v2) into A's: the higher v1 leads, the lower column
// among equals; v2 is the highest of everything else
__device__ __forceinline__ void top2_merge(i64& v1, int& i1, i64& v2,
                                           i64 bv1, int bi1, i64 bv2) {
    const bool b_leads = before(bv1, bi1, v1, i1);
    const i64 loser = b_leads ? v1 : bv1;
    v2 = max(max(v2, bv2), loser);
    v1 = b_leads ? bv1 : v1;
    i1 = b_leads ? bi1 : i1;
}

__device__ __forceinline__ void warp_top2(i64& v1, int& i1, i64& v2) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const i64 bv1 = __shfl_xor_sync(FULL, v1, off);
        const int bi1 = __shfl_xor_sync(FULL, i1, off);
        const i64 bv2 = __shfl_xor_sync(FULL, v2, off);
        top2_merge(v1, i1, v2, bv1, bi1, bv2);
    }
}

__device__ __forceinline__ i64 rank_key(int P, int order) {
    return min(max((i64)P - (i64)order, (i64)0), (i64)((1 << 16) - 1));
}

// a lane's U column pairs of one row: fit bytes and scores
template <int U>
struct Pairs {
    unsigned f[U];
    i64 s0[U], s1[U];
};

// load the pairs c + 64j, c + 64j + 1 (j < U) below c1; vec: the row
// is aligned for 2-byte fit and 16-byte score loads
template <int U>
__device__ __forceinline__ void load_pairs(Pairs<U>& g, const uint8_t* fr,
                                           const i64* sr, int c, int c1,
                                           bool vec) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
        const int cj = c + STEP * j;
        if (vec && cj + 1 < c1) {
            g.f[j] = *(const unsigned short*)(fr + cj);
            const longlong2 ss = *(const longlong2*)(sr + cj);
            g.s0[j] = ss.x;
            g.s1[j] = ss.y;
        } else {
            g.f[j] = (cj < c1 ? (unsigned)fr[cj] : 0u)
                | (cj + 1 < c1 ? (unsigned)fr[cj + 1] << 8 : 0u);
            g.s0[j] = cj < c1 ? sr[cj] : 0;
            g.s1[j] = cj + 1 < c1 ? sr[cj + 1] : 0;
        }
    }
}

// |x| <= 2^61: sums and differences of such values do not wrap
__device__ __forceinline__ bool small(i64 x) {
    return x >= -(1LL << 61) && x <= (1LL << 61);
}

// this lane's part of the warp's walk over columns [c0, c1) of slot p's
// row, the node state of the tile starting at t0 in shared memory or the
// block's slab (read a column pair at a time); the next U pairs load
// while this lane works on the current U. ROOM (every used, cap and req small): used + req <=
// cap is req <= room = cap - used, exactly; else used and cap are compared
// with the wrapping sum.
template <bool ROOM, int U>
__device__ __forceinline__ void auction_walk(
    const AuctionArgs& a, int p, int c0, int c1, int t0, const i64* s_price,
    const i64* s_used, const i64* s_cap, const i64* s_room,
    const i64 (&rq)[RES], const bool (&ck)[RES], int lane, i64& v1, int& i1,
    i64& v2, bool& any) {
    const int N = a.N, tile = a.tile;
    const uint8_t* fr = a.fit + (size_t)p * N;
    const i64* sr = a.score + (size_t)p * N;
    const int pn = p % N;
    const bool vec = ((((uintptr_t)(fr + c0)) & 1)
                      | (((uintptr_t)(sr + c0)) & 15)) == 0;
    int c = c0 + 2 * lane;
    Pairs<U> g;
    load_pairs(g, fr, sr, c, c1, vec);
    for (; c < c1; c += STEP * U) {
        Pairs<U> h;
        load_pairs(h, fr, sr, c + STEP * U, c1, vec);
#pragma unroll
        for (int j = 0; j < U; ++j) {
            const int cp = c + STEP * j;  // the pair's first column
            if (cp >= c1) continue;
            // the pair's node state (i even: 16-byte aligned)
            const int i = cp - t0;
            bool ok[2] = {(g.f[j] & 0xffu) != 0, (g.f[j] >> 8) != 0};
            any |= ok[0] || (cp + 1 < c1 && ok[1]);
            longlong2 pr = {0, 0};
            if (ok[0] || ok[1]) {
                pr = *(const longlong2*)&s_price[i];
#pragma unroll
                for (int r = 0; r < RES; ++r) {
                    if (!ck[r]) continue;
                    if (ROOM) {
                        const longlong2 x =
                            *(const longlong2*)&s_room[r * tile + i];
                        ok[0] &= rq[r] <= x.x;
                        ok[1] &= rq[r] <= x.y;
                    } else {
                        const longlong2 x =
                            *(const longlong2*)&s_used[r * tile + i];
                        const longlong2 y =
                            *(const longlong2*)&s_cap[r * tile + i];
                        ok[0] &= wadd(x.x, rq[r]) <= y.x;
                        ok[1] &= wadd(x.y, rq[r]) <= y.y;
                    }
                }
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int cc = cp + e;
                if (cc >= c1) continue;
                i64 u = NEG;
                if (ok[e]) {
                    int rot = pn + cc;
                    rot -= rot >= N ? N : 0;
                    u = wsub(wadd(wmul(e ? g.s1[j] : g.s0[j], N), rot),
                             e ? pr.y : pr.x);
                }
                // columns rise along the lane: an equal value keeps the
                // earlier column
                if (u > v1) {
                    v2 = max(v2, v1);
                    v1 = u;
                    i1 = cc;
                } else {
                    v2 = max(v2, u);
                }
            }
        }
        g = h;
    }
}

// slot p's bid in round t from its row's top two (one thread); a slot
// with a fit column goes on the next round's list (which drops it if it
// wins now), one without never bids
__device__ __forceinline__ void auction_form(const AuctionArgs& a, int p,
                                             int t, i64 eps, i64 v1, int i1,
                                             i64 v2, bool any, i64* wk,
                                             int* blk_bids) {
    const bool valid = v1 > NEG;
    const i64 b = wadd(v2 > NEG ? wsub(v1, v2) : 0, eps);
    const i64 pk = min(max((i64)a.prio[p], (i64)0), (i64)((1 << 14) - 1));
    const i64 bk = min(max(b, (i64)0), (i64)((1LL << 31) - 1));
    const i64 k = (pk << 48) + (bk << 16) + rank_key(a.P, a.order[p]);
    __stcg(&a.n1[p], valid ? i1 : -1);
    __stcg(&a.bid[p], b);
    __stcg(&a.key[p], k);
    if (valid) {
        atomicMax(&wk[i1], k);
        atomicAdd(blk_bids, 1);
    }
    if (any)
        a.list[(size_t)((t + 1) & 1) * a.P + atomicAdd(&a.count[t + 1], 1)] =
            p;
}

// SLAB: the tile's node state lies in a.slab (device memory), not in
// shared memory; an instance of its own, so that the other reads its
// tile with shared-memory loads
template <bool SLAB>
__global__ void __launch_bounds__(AUCTION_THREADS, 1)
assign_auction_kernel(AuctionArgs a) {
    extern __shared__ __align__(16) unsigned char node_tile[];
    __shared__ int blk_bids;
    __shared__ Partial s_part[2][AUCTION_WARPS];  // a block's segments
    cg::grid_group grid = cg::this_grid();
    const int P = a.P, N = a.N, T = a.T, tile = a.tile;
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const int nthreads = gridDim.x * blockDim.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // this block's tile and its place in the tile's group of blocks
    const int g = blockIdx.x % T, q = blockIdx.x / T;
    const int t0 = g * tile, t1 = min(t0 + tile, N), tn = max(t1 - t0, 0);
    const int WG = gridDim.x / T * AUCTION_WARPS;
    const int s_max = min(SEG_MAX / T, tile / STEP);
    // the tile's node state, kept here (or in the block's slab) for the
    // whole launch
    i64* s_price = SLAB
        ? a.slab + (size_t)blockIdx.x * tile * (NODE_SMEM / 8)
        : (i64*)node_tile;
    i64* s_used = s_price + tile;
    i64* s_cap = s_used + RES * tile;
    i64* s_room = s_cap + RES * tile;  // cap - used, where all are small
    int* general_flag = a.bids + a.rounds;

    for (int n = tid; n < N; n += nthreads)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            a.win_key[(size_t)b * N + n] = NEG;
            a.win_p[(size_t)b * N + n] = NO_INDEX;
        }
    for (int p = tid; p < P; p += nthreads) {
        a.owner[p] = -1;
        a.tick[p] = 0;
    }
    for (int t = tid; t <= a.rounds; t += nthreads) {
        a.count[t] = 0;
        a.bids[t] = 0;  // bids[rounds] is the general-path flag
    }
    for (int w = tid; w < RANK_WORDS; w += nthreads) a.seen[w] = 0;
    bool small_tile = true;
    for (int i = threadIdx.x; i < tn; i += blockDim.x) {
        s_price[i] = 0;
#pragma unroll
        for (int r = 0; r < RES; ++r) {
            const i64 c = a.cap[(size_t)(t0 + i) * RES + r];
            s_used[r * tile + i] = 0;
            s_cap[r * tile + i] = c;
            s_room[r * tile + i] = c;
            small_tile &= small(c);
        }
    }
    small_tile = __syncthreads_and(small_tile);
    grid.sync();
    // are the keys' low bits, clip(P - order), distinct across slots?
    // (and the slot of each, for the unique path)
    for (int p = tid; p < P; p += nthreads) {
        const int rk = (int)rank_key(P, a.order[p]);
        const unsigned bit = 1u << (rk & 31);
        if (atomicOr(&a.seen[rk >> 5], bit) & bit) *general_flag = 1;
        a.inv[rk] = p;
    }

    int general = -1;
    bool stopped = false;
    for (int t = 0; t < a.rounds; ++t) {
        const i64 eps = max((i64)1, a.eps0 >> min(t, 62));
        i64* wk = a.win_key + (size_t)(t % 3) * N;
        int* wp = a.win_p + (size_t)(t % 3) * N;
        const i64* wk_last = a.win_key + (size_t)((t + 2) % 3) * N;
        const int* wp_last = a.win_p + (size_t)((t + 2) % 3) * N;
        if (t > 0) {
            if (general < 0) general = __ldcg(general_flag);
            // seat the last round's winners on this tile: used, price,
            // room (and owner, one block a tile)
            bool still = true;
            for (int i = threadIdx.x; i < tn; i += blockDim.x) {
                const int n = t0 + i;
                const i64 k = __ldcg(&wk_last[n]);
                if (k <= NEG) continue;
                const int w = general ? __ldcg(&wp_last[n])
                                      : __ldcg(&a.inv[k & 0xffff]);
                if (q == 0) a.owner[w] = n;
#pragma unroll
                for (int r = 0; r < RES; ++r) {
                    const i64 u = wadd(s_used[r * tile + i],
                                       a.commit[w * RES + r]);
                    s_used[r * tile + i] = u;
                    s_room[r * tile + i] = wsub(s_cap[r * tile + i], u);
                    still &= small(u);
                }
                s_price[i] = wadd(s_price[i], max(__ldcg(&a.bid[w]), (i64)1));
            }
            small_tile = __syncthreads_and(small_tile && still);
        }
        // the buffers of the next round, last read by the round before
        for (int n = tid; n < N; n += nthreads) {
            a.win_key[(size_t)((t + 1) % 3) * N + n] = NEG;
            a.win_p[(size_t)((t + 1) % 3) * N + n] = NO_INDEX;
        }
        if (threadIdx.x == 0) blk_bids = 0;
        __syncthreads();
        // bid: (row, segment) items over the tile group's warps; in one
        // tile a power of two of segments a row, so that a row's segments
        // are warps of one block. The list is the slots that bid last
        // round with a fit column; one that won then is skipped now.
        const int L = t == 0 ? P : __ldcg(&a.count[t]);
        const int* lst = a.list + (size_t)(t & 1) * P;
        int s = max(1, min(WG / max(L, 1), s_max));
        if (T == 1) s = 1 << (31 - __clz(min(s, AUCTION_WARPS)));
        const int sub = ((tile + s - 1) / s + STEP - 1) / STEP * STEP;
        if (T > 1) s = (tile + sub - 1) / sub;
        const int S = T * s;
        int parity = 0;
        for (int base = q * AUCTION_WARPS; base < L * s; base += WG) {
            const int item = base + warp;
            bool live = item < L * s;
            const int li = item / s, j = item - li * s;
            int p = 0;
            if (live && t > 0) {
                p = __ldcg(&lst[li]);
                const int n = __ldcg(&a.n1[p]);
                live = n < 0 || (general ? __ldcg(&wp_last[n]) != p
                                         : __ldcg(&a.key[p])
                                               != __ldcg(&wk_last[n]));
            } else {
                p = li;
            }
            i64 v1 = EMPTY, v2 = NEG;
            int i1 = NO_INDEX;
            bool any = false;
            if (live) {
                i64 rq[RES];
                bool ck[RES];
                bool room = small_tile;
#pragma unroll
                for (int r = 0; r < RES; ++r) {
                    rq[r] = a.req[p * RES + r];
                    ck[r] = a.check[p * RES + r] != 0;
                    room &= !ck[r] || small(rq[r]);
                }
                const int c0 = t0 + j * sub, c1 = min(c0 + sub, t1);
                constexpr int U = SLAB ? UNROLL_SLAB : UNROLL;
                if (room)
                    auction_walk<true, U>(a, p, c0, c1, t0, s_price, s_used,
                                          s_cap, s_room, rq, ck, lane, v1,
                                          i1, v2, any);
                else
                    auction_walk<false, U>(a, p, c0, c1, t0, s_price, s_used,
                                           s_cap, s_room, rq, ck, lane, v1,
                                           i1, v2, any);
            }
            warp_top2(v1, i1, v2);
            any = __any_sync(FULL, any);
            if (S == 1) {
                if (live && lane == 0)
                    auction_form(a, p, t, eps, v1, i1, v2, any, wk,
                                 &blk_bids);
                continue;
            }
            if (T == 1) {
                // the row's segments are warps warp .. warp + s - 1 of this
                // block where j = 0: they meet in shared memory
                if (lane == 0) s_part[parity][warp] = {v1, v2, i1, (int)any};
                __syncthreads();
                if (live && j == 0) {
                    v1 = EMPTY;
                    v2 = NEG;
                    i1 = NO_INDEX;
                    any = false;
                    if (lane < s) {
                        const Partial& pt = s_part[parity][warp + lane];
                        v1 = pt.v1;
                        v2 = pt.v2;
                        i1 = pt.i1;
                        any = pt.any != 0;
                    }
                    warp_top2(v1, i1, v2);
                    any = __any_sync(FULL, any);
                    if (lane == 0)
                        auction_form(a, p, t, eps, v1, i1, v2, any, wk,
                                     &blk_bids);
                }
                parity ^= 1;
                continue;
            }
            // several tiles: each segment's partial goes to device memory,
            // and the warp whose ticket comes last merges them
            if (!live) continue;
            int last = 0;
            if (lane == 0) {
                Partial* pt = a.part + (size_t)p * a.pstride + g * s + j;
                __stcg(&pt->v1, v1);
                __stcg(&pt->v2, v2);
                __stcg(&pt->i1, i1);
                __stcg(&pt->any, (int)any);
                __threadfence();
                last = atomicAdd(&a.tick[p], 1) == S - 1;
            }
            if (!__shfl_sync(FULL, last, 0)) continue;
            __threadfence();
            v1 = EMPTY;
            v2 = NEG;
            i1 = NO_INDEX;
            any = false;
            for (int k = lane; k < S; k += 32) {
                const Partial* pt = a.part + (size_t)p * a.pstride + k;
                top2_merge(v1, i1, v2, __ldcg(&pt->v1), __ldcg(&pt->i1),
                           __ldcg(&pt->v2));
                any |= __ldcg(&pt->any) != 0;
            }
            warp_top2(v1, i1, v2);
            any = __any_sync(FULL, any);
            if (lane == 0) {
                a.tick[p] = 0;
                auction_form(a, p, t, eps, v1, i1, v2, any, wk, &blk_bids);
            }
        }
        __syncthreads();
        if (threadIdx.x == 0 && blk_bids) atomicAdd(&a.bids[t], blk_bids);
        grid.sync();
        if (__ldcg(&a.bids[t]) == 0) {  // nothing can change
            stopped = true;
            break;
        }
        if (general < 0) general = __ldcg(general_flag);
        if (general) {
            // claim: the lowest slot holding its node's winning key (the
            // slots that bid are on the next list)
            const int* nl = a.list + (size_t)((t + 1) & 1) * P;
            const int M = __ldcg(&a.count[t + 1]);
            for (int i = tid; i < M; i += nthreads) {
                const int p = __ldcg(&nl[i]);
                const int n = __ldcg(&a.n1[p]);
                if (n >= 0 && __ldcg(&a.key[p]) == __ldcg(&wk[n]))
                    atomicMin(&wp[n], p);
            }
            grid.sync();
        }
    }
    // the last round's winners, where the rounds ran out: their owners
    if (!stopped && a.rounds > 0 && q == 0) {
        const int t = a.rounds - 1;
        const i64* wk = a.win_key + (size_t)(t % 3) * N;
        const int* wp = a.win_p + (size_t)(t % 3) * N;
        for (int i = threadIdx.x; i < tn; i += blockDim.x) {
            const int n = t0 + i;
            const i64 k = __ldcg(&wk[n]);
            if (k > NEG)
                a.owner[general ? __ldcg(&wp[n]) : __ldcg(&a.inv[k & 0xffff])] =
                    n;
        }
    }
}

// -- K7b: the beam -----------------------------------------------------------

struct BeamArgs {
    const uint8_t* fit;
    const i64* score;
    const i64* req;
    const i64* commit;
    const uint8_t* check;
    const i64* cap;
    int P, N;
    i64* list_v;  // [P][BEAM_LIST]: each slot's sorted list
    int* list_n;
    unsigned* ticket;  // blocks done with phase A (zeroed before launch)
    int* owner;
};

struct BeamListsA {  // phase A: the warps' partial sums, double-buffered
    int count[2][BEAM_WARPS];
    i64 top[2][BEAM_WARPS];
    int has[2][BEAM_WARPS];
};

struct BeamChainB {  // phase B: one table a beam, double-buffered by step
    // the touched nodes' used and cap, and their score and fit in this
    // step's row and in the next
    __align__(16) i64 used[2][BEAM_K][BEAM_MAX_P][RES];
    __align__(16) i64 cap[2][BEAM_K][BEAM_MAX_P][RES];
    i64 score[2][BEAM_K][BEAM_MAX_P];
    i64 score_next[2][BEAM_K][BEAM_MAX_P];
    __align__(16) int node[2][BEAM_K][BEAM_MAX_P];
    unsigned char fit[2][BEAM_K][BEAM_MAX_P];
    unsigned char fit_next[2][BEAM_K][BEAM_MAX_P];
    int count[2][BEAM_K];
    int choice[2][BEAM_K][BEAM_MAX_P];
    i64 acc[2][BEAM_K];
    i64 cand_v[BEAM_K][BEAM_C];
    int cand_n[BEAM_K][BEAM_C];
    i64 head_v[BEAM_K][BEAM_C];  // the first C untouched list entries
    int head_n[BEAM_K][BEAM_C];
};

// phase A's shape at N: WA warps (4-16), E columns a thread (at most 16),
// chunks of WA * 32 * E columns; and the launch's dynamic shared memory:
// phase A's sums and a chunk's u0, or phase B's tables
struct BeamLayout {
    int WA, E, chunk, smem;
};

__host__ __device__ inline int clampi(int x, int lo, int hi) {
    return x < lo ? lo : x > hi ? hi : x;
}

__host__ __device__ inline BeamLayout beam_layout(int N) {
    BeamLayout l;
    l.WA = clampi((N + 32 * BEAM_E - 1) / (32 * BEAM_E), BEAM_K, BEAM_WARPS);
    l.E = clampi((N + l.WA * 32 - 1) / (l.WA * 32), 1, BEAM_E);
    l.chunk = l.WA * 32 * l.E;
    const int a = ((int)sizeof(BeamListsA) + 15) / 16 * 16
        + 8 * (l.chunk + l.chunk / 16);
    const int b = (int)sizeof(BeamChainB);
    l.smem = a > b ? a : b;
    return l;
}

// u0 of slot p's columns c0 .. c0 + WA * 32 * E - 1: fit && req <= cap on
// every checked row ? score : NEG, computed from coalesced loads (thread
// t: c0 + t + 32 WA e) into shared memory (column j at j + j / 16, so that
// the read back is not a bank conflict) and read back as this thread's E
// consecutive columns c0 + tE + e -> the live columns' mask
__device__ __forceinline__ unsigned beam_u0(const BeamArgs& a, i64* s_u0,
                                            int p, int c0, int WA, int E,
                                            int tid, const i64 (&rq)[RES],
                                            const bool (&ck)[RES],
                                            i64 (&val)[BEAM_E]) {
    const int threads = WA * 32;
#pragma unroll
    for (int e = 0; e < BEAM_E; ++e) {
        const int n = c0 + tid + threads * e;
        if (e < E && n < a.N) {
            bool ok = a.fit[(size_t)p * a.N + n] != 0;
#pragma unroll
            for (int r = 0; r < RES; ++r)
                ok &= !ck[r] || wadd(0, rq[r]) <= a.cap[(size_t)n * RES + r];
            const i64 sc = a.score[(size_t)p * a.N + n];
            const int j = tid + threads * e;
            s_u0[j + (j >> 4)] = ok ? sc : NEG;
        }
    }
    asm volatile("bar.sync 2, %0;" ::"r"(threads) : "memory");
    unsigned live = 0;
#pragma unroll
    for (int e = 0; e < BEAM_E; ++e) {
        val[e] = 0;
        if (e < E && c0 + tid * E + e < a.N) {
            live |= 1u << e;
            const int j = tid * E + e;
            val[e] = s_u0[j + (j >> 4)];
        }
    }
    asm volatile("bar.sync 2, %0;" ::"r"(threads) : "memory");
    return live;
}

// phase A's block step over its WA warps (named barrier 2): the exclusive
// prefix of cnt over the threads, the total, and the maximum of the
// values v the threads have (has)
__device__ __forceinline__ void beam_scan(BeamListsA& s, int parity, int WA,
                                          int lane, int warp, int cnt,
                                          bool has, i64 v, int& excl,
                                          int& total, bool& any, i64& top) {
    int inc = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(FULL, inc, off);
        inc += lane >= off ? t : 0;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const i64 ov = __shfl_xor_sync(FULL, v, off);
        const bool oh = __shfl_xor_sync(FULL, (int)has, off) != 0;
        const bool take = oh && (!has || ov > v);
        v = take ? ov : v;
        has |= oh;
    }
    if (lane == 31) s.count[parity][warp] = inc;
    if (lane == 0) {
        s.top[parity][warp] = v;
        s.has[parity][warp] = has;
    }
    asm volatile("bar.sync 2, %0;" ::"r"(WA * 32) : "memory");
    int before_me = 0, sum = 0;
    any = false;
    top = 0;
#pragma unroll
    for (int w = 0; w < BEAM_WARPS; ++w) {
        if (w >= WA) break;
        const int c = s.count[parity][w];
        sum += c;
        before_me += w < warp ? c : 0;
        const i64 t = s.top[parity][w];
        if (s.has[parity][w] && (!any || t > top)) {
            top = t;
            any = true;
        }
    }
    excl = before_me + inc - cnt;
    total = sum;
}

// phase A for slot p by warps 0 .. WA - 1, E columns a thread (t E .. t E
// + E - 1 of each chunk of WA * 32 * E): the first Lp entries of u0 by
// (value desc, node asc), one value level at a time: each pass counts the
// entries equal to the last level's value m, ranks them in node order by
// a block prefix sum and writes the first of them, and finds the next
// level, the maximum below m
__device__ __forceinline__ void beam_list(const BeamArgs& a, BeamListsA& s,
                                          i64* s_u0, int p, int Lp, int WA,
                                          int E, int lane, int warp) {
    const int tid = warp * 32 + lane;
    const int chunk = WA * 32 * E;
    const int chunks = (a.N + chunk - 1) / chunk;
    i64 rq[RES];
    bool ck[RES];
#pragma unroll
    for (int r = 0; r < RES; ++r) {
        rq[r] = a.req[p * RES + r];
        ck[r] = a.check[p * RES + r] != 0;
    }
    i64 val[BEAM_E];
    unsigned live = 0;
    if (chunks == 1) live = beam_u0(a, s_u0, p, 0, WA, E, tid, rq, ck, val);
    bool m_has = false;  // m: the level being listed (none yet: +inf)
    i64 m = 0;
    int taken = 0, parity = 0;
    while (true) {
        int listed = 0;  // entries equal to m in the chunks before
        bool nx_has = false;
        i64 nx = 0;
        for (int c = 0; c < chunks; ++c) {
            if (chunks > 1)
                live = beam_u0(a, s_u0, p, c * chunk, WA, E, tid, rq, ck,
                               val);
            int cnt = 0;
#pragma unroll
            for (int e = 0; e < BEAM_E; ++e) {
                if (!(live >> e & 1u)) continue;
                cnt += m_has && val[e] == m;
                if ((!m_has || val[e] < m) && (!nx_has || val[e] > nx)) {
                    nx = val[e];
                    nx_has = true;
                }
            }
            int excl, total;
            bool any;
            i64 top;
            beam_scan(s, parity, WA, lane, warp, cnt, nx_has, nx, excl,
                      total, any, top);
            parity ^= 1;
            if (c == chunks - 1) {
                nx_has = any;
                nx = top;
            }
            int r = taken + listed + excl;
#pragma unroll
            for (int e = 0; e < BEAM_E; ++e) {
                if (!(live >> e & 1u) || !m_has || val[e] != m) continue;
                if (r < Lp) {
                    a.list_v[(size_t)p * BEAM_LIST + r] = m;
                    a.list_n[(size_t)p * BEAM_LIST + r] =
                        c * chunk + tid * E + e;
                }
                ++r;
            }
            listed += total;
        }
        taken = min(Lp, taken + listed);
        if (taken >= Lp || !nx_has) break;
        m = nx;
        m_has = true;
    }
}

// slot p's list (three entries a lane) and its req, commit and check rows
__device__ __forceinline__ void beam_row(const BeamArgs& a, int p, int lane,
                                         i64 (&lv)[3], int (&ln)[3],
                                         i64 (&rq)[RES], i64 (&cmt)[RES],
                                         bool (&ck)[RES]) {
    const int Lp = min(a.N, BEAM_C + p);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        const int j = lane + 32 * m;
        lv[m] = j < Lp ? __ldcg(&a.list_v[(size_t)p * BEAM_LIST + j]) : EMPTY;
        ln[m] = j < Lp ? __ldcg(&a.list_n[(size_t)p * BEAM_LIST + j])
                       : NO_INDEX;
    }
#pragma unroll
    for (int r = 0; r < RES; ++r) {
        rq[r] = a.req[p * RES + r];
        cmt[r] = a.commit[p * RES + r];
        ck[r] = a.check[p * RES + r] != 0;
    }
}

// put the first of (av, ai), (bv, bi) by `before` in a
__device__ __forceinline__ void order2(i64& av, int& ai, i64& bv, int& bi) {
    const bool swap = before(bv, bi, av, ai);
    const i64 tv = av;
    const int ti = ai;
    av = swap ? bv : av;
    ai = swap ? bi : ai;
    bv = swap ? tv : bv;
    bi = swap ? ti : bi;
}

// the warp's first (v, i) by `before`, in every lane, by warp reductions:
// the maximum of v's high words, then of the low words where the high
// word is that maximum, then the least i where v is the maximum
__device__ __forceinline__ void warp_first(i64 v, int i, i64& bv, int& bi) {
    const int hi = (int)(v >> 32);
    const int mh = __reduce_max_sync(FULL, hi);
    const unsigned ml = __reduce_max_sync(FULL, hi == mh ? (unsigned)v : 0u);
    bv = (i64)(((u64)(unsigned)mh << 32) | ml);
    bi = (int)__reduce_min_sync(FULL, v == bv ? (unsigned)i : 0xffffffffu);
}

__device__ __forceinline__ void beam_bar() {
    asm volatile("bar.sync 1, %0;" ::"r"(BEAM_K * 32) : "memory");
}

__global__ void __launch_bounds__(BEAM_THREADS)
assign_beam_kernel(BeamArgs a) {
    extern __shared__ __align__(16) unsigned char beam_smem[];
    __shared__ int is_last;
    const int P = a.P, N = a.N;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    // -- phase A: slot p's list ----------------------------------------------
    {
        const BeamLayout l = beam_layout(N);
        if (warp < l.WA)
            beam_list(a, *(BeamListsA*)beam_smem,
                      (i64*)(beam_smem + (sizeof(BeamListsA) + 15) / 16 * 16),
                      blockIdx.x, min(N, BEAM_C + (int)blockIdx.x), l.WA,
                      l.E, lane, warp);
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0)
            is_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
        __syncthreads();
        if (!is_last || warp >= BEAM_K) return;
        __threadfence();
    }

    // -- phase B: the chain, one warp a beam ----------------------------------
    BeamChainB& b = *(BeamChainB*)beam_smem;
    const int k = warp;
    const int C_eff = min(BEAM_C, N);
    const int S = BEAM_K * (C_eff + 1);
    // the successor this lane forms: beam my_k's pick my_c, or its skip
    const int my_k = lane / (C_eff + 1), my_c = lane % (C_eff + 1);
    for (int q = lane; q < P; q += 32) b.choice[0][k][q] = -1;
    if (lane == 0) {
        b.count[0][k] = 0;
        b.acc[0][k] = k == 0 ? 0 : -(1LL << 59);
    }
    i64 lv[3], rq[RES], cmt[RES];
    int ln[3];
    bool ck[RES];
    beam_row(a, 0, lane, lv, ln, rq, cmt, ck);
    // the entry this warp appended last step, whose row data is in flight
    bool pend = false;
    int pend_e = 0;
    unsigned pend_f = 0;
    i64 pend_s = 0, pend_cap[RES] = {0, 0, 0, 0};
    beam_bar();
    for (int p = 0; p < P; ++p) {
        const int cur = p & 1, nxt = cur ^ 1;
        const int Lp = min(N, BEAM_C + p);
        const bool more = p + 1 < P;
        const int tc = b.count[cur][k];
        // in flight for the next step: slot p + 1's row, and the table's
        // fit and score in it
        i64 lv1[3], rq1[RES], cmt1[RES];
        int ln1[3];
        bool ck1[RES];
        if (more) beam_row(a, p + 1, lane, lv1, ln1, rq1, cmt1, ck1);
        unsigned nf1[2] = {0, 0};
        i64 ns1[2] = {0, 0};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int e = lane + 32 * h;
            if (more && e < tc) {
                const int n = b.node[cur][k][e];
                nf1[h] = a.fit[(size_t)(p + 1) * N + n];
                ns1[h] = a.score[(size_t)(p + 1) * N + n];
            }
        }
        // the first C list entries the beam has not touched, in order
        // (the table read four nodes at a time)
        bool touched[3] = {false, false, false};
        for (int e = 0; e < tc; e += 4) {
            const int4 q = *(const int4*)&b.node[cur][k][e];
            const int n4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
            for (int h = 0; h < 4; ++h)
#pragma unroll
                for (int m = 0; m < 3; ++m)
                    touched[m] |= e + h < tc && ln[m] == n4[h];
        }
        int seen = 0;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
            const bool untouched = lane + 32 * m < Lp && !touched[m];
            const unsigned mask = __ballot_sync(FULL, untouched);
            const int rank = seen + __popc(mask & ((1u << lane) - 1));
            if (untouched && rank < BEAM_C) {
                b.head_v[k][rank] = lv[m];
                b.head_n[k][rank] = ln[m];
            }
            seen += __popc(mask);
        }
        const int heads = min(seen, BEAM_C);
        if (pend && lane == 0) {
            b.fit[cur][k][pend_e] = (unsigned char)pend_f;
            b.score[cur][k][pend_e] = pend_s;
#pragma unroll
            for (int r = 0; r < RES; ++r) b.cap[cur][k][pend_e][r] = pend_cap[r];
        }
        __syncwarp();
        // this lane's candidates: its touched nodes, recomputed, and the
        // lane-th untouched list entry; the beam's top C from them
        i64 cv[3];
        int cn[3];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int e = lane + 32 * h;
            cv[h] = EMPTY;
            cn[h] = NO_INDEX;
            if (e < tc) {
                bool ok = b.fit[cur][k][e] != 0;
#pragma unroll
                for (int r = 0; r < RES; r += 2) {
                    const longlong2 u =
                        *(const longlong2*)&b.used[cur][k][e][r];
                    const longlong2 c =
                        *(const longlong2*)&b.cap[cur][k][e][r];
                    ok &= !ck[r] || wadd(u.x, rq[r]) <= c.x;
                    ok &= !ck[r + 1] || wadd(u.y, rq[r + 1]) <= c.y;
                }
                cv[h] = ok ? b.score[cur][k][e] : NEG;
                cn[h] = b.node[cur][k][e];
            }
        }
        cv[2] = lane < heads ? b.head_v[k][lane] : EMPTY;
        cn[2] = lane < heads ? b.head_n[k][lane] : NO_INDEX;
        order2(cv[0], cn[0], cv[1], cn[1]);
        order2(cv[0], cn[0], cv[2], cn[2]);
        order2(cv[1], cn[1], cv[2], cn[2]);
        // C_eff rounds of the warp's first; the lane holding it moves up
        // its next (nodes are distinct)
        for (int c = 0; c < C_eff; ++c) {
            i64 wv;
            int wi;
            warp_first(cv[0], cn[0], wv, wi);
            if (lane == 0) {
                b.cand_v[k][c] = wv;
                b.cand_n[k][c] = wi;
            }
            const bool pop = cn[0] == wi && cv[0] == wv;
            cv[0] = pop ? cv[1] : cv[0];
            cn[0] = pop ? cn[1] : cn[0];
            cv[1] = pop ? cv[2] : cv[1];
            cn[1] = pop ? cn[2] : cn[1];
            cv[2] = pop ? EMPTY : cv[2];
            cn[2] = pop ? NO_INDEX : cn[2];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int e = lane + 32 * h;
            if (more && e < tc) {
                b.fit_next[cur][k][e] = (unsigned char)nf1[h];
                b.score_next[cur][k][e] = ns1[h];
            }
        }
        beam_bar();
        // the successors (C_eff picks and a skip a beam), ranked by
        // (value desc, index asc); rank k is this warp's child
        i64 sv = EMPTY;
        if (lane < S) {
            const i64 acc = b.acc[cur][my_k];
            const i64 cv0 = b.cand_v[my_k][min(my_c, C_eff - 1)];
            sv = my_c < C_eff ? wadd(acc, cv0 > NEG ? cv0 : NO_FIT)
                              : wsub(acc, SKIP_PENALTY);
        }
        // K rounds of the warp's first; round k's is this warp's child
        int si = lane < S ? lane : NO_INDEX, j = 0;
        i64 top = 0;
#pragma unroll
        for (int r = 0; r < BEAM_K; ++r) {
            i64 wv;
            int wi;
            warp_first(sv, si, wv, wi);
            if (r == k) {
                top = wv;
                j = wi;
            }
            if (si == wi) {
                sv = EMPTY;
                si = NO_INDEX;
            }
        }
        const int par = __shfl_sync(FULL, my_k, j);
        const int slot = __shfl_sync(FULL, my_c, j);
        const int sc = min(slot, C_eff - 1);
        const bool pick = slot < C_eff && b.cand_v[par][sc] > NEG;
        const int node = pick ? b.cand_n[par][sc] : -1;
        // the child: the parent's table and choices, and the pick
        const int pc = b.count[cur][par];
        bool found = false;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int e = lane + 32 * h;
            if (e < pc) {
                const int n = b.node[cur][par][e];
                const bool hit = n == node;
                found |= hit;
                b.node[nxt][k][e] = n;
#pragma unroll
                for (int r = 0; r < RES; r += 2) {
                    longlong2 u = *(const longlong2*)&b.used[cur][par][e][r];
                    u.x = hit ? wadd(u.x, cmt[r]) : u.x;
                    u.y = hit ? wadd(u.y, cmt[r + 1]) : u.y;
                    *(longlong2*)&b.used[nxt][k][e][r] = u;
                    *(longlong2*)&b.cap[nxt][k][e][r] =
                        *(const longlong2*)&b.cap[cur][par][e][r];
                }
                b.fit[nxt][k][e] = b.fit_next[cur][par][e];
                b.score[nxt][k][e] = b.score_next[cur][par][e];
            }
        }
        found = __any_sync(FULL, found);
        pend = node >= 0 && !found;
        if (pend && lane == 0) {
            b.node[nxt][k][pc] = node;
#pragma unroll
            for (int r = 0; r < RES; ++r) {
                b.used[nxt][k][pc][r] = cmt[r];
                pend_cap[r] = a.cap[(size_t)node * RES + r];
            }
            pend_e = pc;
            if (more) {
                pend_f = a.fit[(size_t)(p + 1) * N + node];
                pend_s = a.score[(size_t)(p + 1) * N + node];
            }
        }
        for (int q = lane; q < P; q += 32)
            b.choice[nxt][k][q] = q == p ? node : b.choice[cur][par][q];
        if (lane == 0) {
            b.count[nxt][k] = pc + pend;
            b.acc[nxt][k] = top;
        }
        beam_bar();
        if (more) {
#pragma unroll
            for (int m = 0; m < 3; ++m) {
                lv[m] = lv1[m];
                ln[m] = ln1[m];
            }
#pragma unroll
            for (int r = 0; r < RES; ++r) {
                rq[r] = rq1[r];
                cmt[r] = cmt1[r];
                ck[r] = ck1[r];
            }
        }
    }
    // owner: the choices of the first maximum of acc
    const int fin = P & 1;
    int best = 0;
    for (int kk = 1; kk < BEAM_K; ++kk)
        if (b.acc[fin][kk] > b.acc[fin][best]) best = kk;
    for (int q = threadIdx.x; q < P; q += BEAM_K * 32)
        a.owner[q] = b.choice[fin][best][q];
}

// -- the C interface ---------------------------------------------------------

// the auction's plan at (P, N) on the current card: T tiles of `tile`
// columns over a grid of `blocks` (a multiple of T), `smem` bytes of
// dynamic shared memory a block; slab: the tiles of at most TILE_MAX
// nodes outnumber the co-resident blocks, so there is one tile a
// co-resident block and its state lies in device memory (smem 0). ok:
// the card can launch it
struct AuctionPlan {
    int T, tile, blocks, smem;
    bool slab, ok;
};

// blocks of the auction co-resident on `sms` SMs at `smem` bytes of
// dynamic shared memory a block (0 where the card cannot give it)
template <bool SLAB>
static int co_resident(int sms, int smem) {
    int per_sm = 0;
    if (cudaFuncSetAttribute(assign_auction_kernel<SLAB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, assign_auction_kernel<SLAB>, AUCTION_THREADS, smem)
               != cudaSuccess) {
        cudaGetLastError();  // a refused size is an answer, not an error
        return 0;
    }
    return sms * std::min(per_sm, AUCTION_BLOCKS_PER_SM);
}

static AuctionPlan auction_plan(int P, int N) {
    AuctionPlan pl = {};
    int dev = 0, sms = 0, coop = 0;
    if (N < 1 || cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)
               != cudaSuccess
        || !coop
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
        return pl;
    const Tiles t = tiles_of(N);
    int resident = co_resident<false>(sms, t.tile * NODE_SMEM);
    pl.slab = t.T > resident;
    if (pl.slab) {
        resident = co_resident<true>(sms, 0);
        if (resident < 1) return pl;
        const int per = (N + resident - 1) / resident;
        pl.tile = (per + STEP - 1) / STEP * STEP;
        pl.T = (N + pl.tile - 1) / pl.tile;
        pl.smem = 0;
    } else {
        pl.T = t.T;
        pl.tile = t.tile;
        pl.smem = t.tile * NODE_SMEM;
    }
    const int want = std::max((P + AUCTION_WARPS - 1) / AUCTION_WARPS, 1)
        * pl.T;
    pl.blocks = std::min(want, resident / pl.T * pl.T);
    pl.ok = pl.blocks >= 1;
    return pl;
}

// where the auction's scratch arrays lie, in bytes from its start
struct AuctionLayout {
    size_t win_key, bid, key, win_p, n1, list, tick, count, seen, inv, bids,
        part, slab, total;
};

static AuctionLayout auction_layout(int P, int N, int rounds,
                                    const AuctionPlan& pl) {
    AuctionLayout l;
    size_t at = 0;
    auto take = [&at](size_t bytes) {
        const size_t here = at;
        at += (bytes + 15) / 16 * 16;
        return here;
    };
    const size_t n = (size_t)N, p = (size_t)P;
    l.win_key = take(24 * n);
    l.bid = take(8 * p);
    l.key = take(8 * p);
    l.win_p = take(12 * n);
    l.n1 = take(4 * p);
    l.list = take(8 * p);
    l.tick = take(4 * p);
    l.count = take(4 * ((size_t)rounds + 1));
    l.seen = take(4 * (size_t)RANK_WORDS);
    l.inv = take(4 << 16);
    l.bids = take(4 * ((size_t)rounds + 1));
    l.part = take(sizeof(Partial) * std::max(SEG_MAX, pl.T) * p);
    l.slab = take(pl.slab ? (size_t)pl.blocks * pl.tile * NODE_SMEM : 0);
    l.total = at;
    return l;
}

// scratch bytes the auction needs beside its inputs and owner
extern "C" long long assign_auction_scratch_bytes(int P, int N, int rounds) {
    return (long long)auction_layout(P, N, rounds, auction_plan(P, N)).total;
}

// where bids i32[rounds] lies in the scratch, in bytes; one i32 follows
// it: 1 when the launch took the general (claim) path
extern "C" long long assign_auction_bids_offset(int P, int N, int rounds) {
    return (long long)auction_layout(P, N, rounds, auction_plan(P, N)).bids;
}

// dynamic shared memory of a block of the auction at N: its tile's node
// state, or 0 where that lies in device memory
extern "C" int assign_auction_smem_bytes(int N) {
    return auction_plan(1, N).smem;
}

// the co-resident grid of the auction, a multiple of its tiles: -> blocks,
// or 0 when the card cannot launch it
extern "C" int assign_auction_grid(int P, int N) {
    const AuctionPlan pl = auction_plan(P, N);
    return pl.ok ? pl.blocks : 0;
}

extern "C" int assign_auction_launch(
    const void* fit, const void* score, const void* req, const void* commit,
    const void* check, const void* cap, const void* prio, const void* order,
    long long eps0, int P, int N, int rounds, void* owner, void* scratch,
    void* stream) {
    if (P < 1 || N < 1 || rounds < 0) return (int)cudaErrorInvalidValue;
    const AuctionPlan pl = auction_plan(P, N);
    if (!pl.ok) return (int)cudaErrorCooperativeLaunchTooLarge;
    const AuctionLayout l = auction_layout(P, N, rounds, pl);
    char* s = (char*)scratch;
    AuctionArgs a;
    a.fit = (const uint8_t*)fit;
    a.score = (const i64*)score;
    a.req = (const i64*)req;
    a.commit = (const i64*)commit;
    a.check = (const uint8_t*)check;
    a.cap = (const i64*)cap;
    a.prio = (const int*)prio;
    a.order = (const int*)order;
    a.eps0 = eps0;
    a.P = P;
    a.N = N;
    a.rounds = rounds;
    a.T = pl.T;
    a.tile = pl.tile;
    a.pstride = std::max(SEG_MAX, pl.T);
    a.owner = (int*)owner;
    a.win_key = (i64*)(s + l.win_key);
    a.bid = (i64*)(s + l.bid);
    a.key = (i64*)(s + l.key);
    a.part = (Partial*)(s + l.part);
    a.slab = pl.slab ? (i64*)(s + l.slab) : nullptr;
    a.win_p = (int*)(s + l.win_p);
    a.n1 = (int*)(s + l.n1);
    a.list = (int*)(s + l.list);
    a.tick = (int*)(s + l.tick);
    a.count = (int*)(s + l.count);
    a.seen = (unsigned*)(s + l.seen);
    a.inv = (int*)(s + l.inv);
    a.bids = (int*)(s + l.bids);
    void* args[] = {&a};
    cudaError_t err = cudaLaunchCooperativeKernel(
        pl.slab ? (const void*)assign_auction_kernel<true>
                : (const void*)assign_auction_kernel<false>,
        dim3(pl.blocks),
        dim3(AUCTION_THREADS), args, (size_t)pl.smem, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// the beam's largest P (its touched tables and lists are sized for it)
extern "C" int assign_beam_max_slots() { return BEAM_MAX_P; }

// the beam's scratch: its slots' lists, then the phase-A ticket
static size_t beam_lists_bytes(int P) {
    return ((size_t)P * BEAM_LIST * (8 + 4) + 15) / 16 * 16;
}

// scratch bytes the beam needs, passed as used_buf
extern "C" long long assign_beam_scratch_bytes(int P, int N) {
    (void)N;
    return (long long)(beam_lists_bytes(P) + 16);
}

// used_buf: assign_beam_scratch_bytes of scratch; choice_buf is not used
extern "C" int assign_beam_launch(
    const void* fit, const void* score, const void* req, const void* commit,
    const void* check, const void* cap, int P, int N, void* used_buf,
    void* choice_buf, void* owner, void* stream) {
    (void)choice_buf;
    if (P < 1 || N < 1 || P > BEAM_MAX_P) return (int)cudaErrorInvalidValue;
    BeamArgs a;
    a.fit = (const uint8_t*)fit;
    a.score = (const i64*)score;
    a.req = (const i64*)req;
    a.commit = (const i64*)commit;
    a.check = (const uint8_t*)check;
    a.cap = (const i64*)cap;
    a.P = P;
    a.N = N;
    a.list_v = (i64*)used_buf;
    a.list_n = (int*)(a.list_v + (size_t)P * BEAM_LIST);
    a.ticket = (unsigned*)((char*)used_buf + beam_lists_bytes(P));
    a.owner = (int*)owner;
    const int smem = beam_layout(N).smem;
    cudaError_t err = cudaFuncSetAttribute(
        assign_beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(a.ticket, 0, sizeof(unsigned), (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    assign_beam_kernel<<<P, BEAM_THREADS, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
