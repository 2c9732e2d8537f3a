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
// K7a, the auction (assign_auction_kernel): `rounds` rounds, each
//   bid:    util[p, n] = fit && used[n] + req[p] <= cap[n] on every checked
//           row (p unassigned) ? score*N + (p + n) % N - price[n] : NEG;
//           v1, n1 = the maximum and its first column, v2 = the maximum
//           of the other columns; valid = v1 > NEG; bid = (v2 > NEG ?
//           v1 - v2 : 0) + max(1, eps0 >> min(t, 62)); key = clip(prio,
//           0, 2^14-1) << 48 | clip(bid, 0, 2^31-1) << 16 | clip(P -
//           order, 0, 2^16-1); atomicMax(win_key[n1], key) where valid;
//   claim:  a valid slot whose key equals win_key[n1] does atomicMin(
//           win_p[n1], p): the lowest slot of the highest key, the
//           reference's first argmax (two slots share a key when order
//           repeats or P - order passes 2^16);
//   update: each node with a winner seats it (owner[w] = n), adds its
//           commit to used[n] and max(bid[w], 1) to price[n], and resets
//           win_key and win_p for the next round.
//   64-bit atomicMax and atomicMin commute, so the result does not depend
//   on the order the atomics land in. The phases are separated by grid
//   syncs of ONE cooperative launch (cudaLaunchCooperativeKernel, the grid
//   at most the co-resident limit), grid-stride loops throughout: one
//   warp a slot row in the bid (lanes stride the nodes, coalesced fit and
//   score reads; each lane keeps (v1, n1, v2) and a butterfly of
//   shuffles merges them, the first column winning ties), one thread a
//   slot in the claim and one a node in the update. A round in which no
//   slot bids changes nothing, so no later round can bid either: the
//   kernel stops there (its count of bids is read by every thread after
//   the bid's grid sync, so they stop together).
// K7b, the beam (assign_beam_kernel, K = 4, C = 4): ONE block of 512
//   threads walks the P slots in order. For each beam a thread keeps the
//   top C of its nodes (n = tid, tid + 512, ...) in registers, sorted by
//   (util desc, node asc); C rounds of a block argmax over the threads'
//   heads, all K beams at once, give each beam's top C in lax.top_k's
//   order, and thread 0 forms the K * (C + 1) successors (C assignments
//   and a skip) and keeps the top K by (value desc, index asc). The
//   block then rebuilds used from the parents into the other half of a
//   K x N x 4 i64 double buffer in device memory, and the choices the
//   same way; at the end the row of the first maximum of acc is owner.
//
// Bound: bytes. The inputs read once: fit and score, P x N x 9 B, and the
// small tables (req, commit, check, cap, prio, order), over 3.35 TB/s:
// 5.6 us at (P, N) = (2,048, 1,024), 0.090 ms at (4,096, 8,192). This
// kernel reads every unassigned slot's fit and score rows again each
// round, so a bound per round is that times the rounds run
// (chip_smoke.py assign_bound_ms). The per-node state (used, cap, price)
// is re-read from L1/L2 by every slot's warp; the rows of assigned slots
// are skipped. The beam is a chain of P dependent steps of one block,
// bounded by its barriers, not by bytes.

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
constexpr int AUCTION_THREADS = 256;
constexpr int BEAM_THREADS = 512;
constexpr int BEAM_K = 4;
constexpr int BEAM_C = 4;
constexpr int RES = 4;

__device__ __forceinline__ i64 wadd(i64 a, i64 b) {
    return (i64)((u64)a + (u64)b);
}
__device__ __forceinline__ i64 wsub(i64 a, i64 b) {
    return (i64)((u64)a - (u64)b);
}
__device__ __forceinline__ i64 wmul(i64 a, i64 b) {
    return (i64)((u64)a * (u64)b);
}

// used + req <= cap on every checked row of slot p at node n
__device__ __forceinline__ bool fits_res(const i64* used, const i64* cap,
                                         const i64 rq[RES],
                                         const bool ck[RES]) {
    bool ok = true;
#pragma unroll
    for (int r = 0; r < RES; ++r)
        ok &= !ck[r] || wadd(used[r], rq[r]) <= cap[r];
    return ok;
}

// -- K7a: the auction --------------------------------------------------------

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
    int P, N, rounds;
    int* owner;
    // scratch: price[N], used[N*4], win_key[N], bid[P], key[P] (i64),
    // win_p[N], n1[P], bids[rounds] (i32)
    i64* price;
    i64* used;
    i64* win_key;
    i64* bid;
    i64* key;
    int* win_p;
    int* n1;
    int* bids;
};

// merge lane B's (v1, i1, v2) into A's: the higher v1 leads, the lower
// column among equals; v2 is the highest of everything else
__device__ __forceinline__ void top2_merge(i64& v1, int& i1, i64& v2,
                                           i64 bv1, int bi1, i64 bv2) {
    const bool b_leads = bv1 > v1 || (bv1 == v1 && bi1 < i1);
    const i64 loser = b_leads ? v1 : bv1;
    v2 = max(max(v2, bv2), loser);
    v1 = b_leads ? bv1 : v1;
    i1 = b_leads ? bi1 : i1;
}

__global__ void __launch_bounds__(AUCTION_THREADS)
assign_auction_kernel(AuctionArgs a) {
    cg::grid_group grid = cg::this_grid();
    const int P = a.P, N = a.N;
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const int nthreads = gridDim.x * blockDim.x;
    const int lane = threadIdx.x & 31;
    const int warp = tid >> 5;
    const int nwarps = nthreads >> 5;

    for (int n = tid; n < N; n += nthreads) {
        a.price[n] = 0;
        a.win_key[n] = NEG;
        a.win_p[n] = NO_INDEX;
#pragma unroll
        for (int r = 0; r < RES; ++r) a.used[n * RES + r] = 0;
    }
    for (int p = tid; p < P; p += nthreads) a.owner[p] = -1;
    for (int t = tid; t < a.rounds; t += nthreads) a.bids[t] = 0;
    grid.sync();

    for (int t = 0; t < a.rounds; ++t) {
        const i64 eps = max((i64)1, a.eps0 >> min(t, 62));
        // bid: one warp a slot row
        for (int p = warp; p < P; p += nwarps) {
            if (a.owner[p] >= 0) {
                if (lane == 0) a.n1[p] = -1;
                continue;
            }
            i64 rq[RES];
            bool ck[RES];
#pragma unroll
            for (int r = 0; r < RES; ++r) {
                rq[r] = a.req[p * RES + r];
                ck[r] = a.check[p * RES + r] != 0;
            }
            const uint8_t* fit = a.fit + (size_t)p * N;
            const i64* score = a.score + (size_t)p * N;
            const int pn = p % N;
            i64 v1 = EMPTY, v2 = NEG;
            int i1 = NO_INDEX;
            for (int n = lane; n < N; n += 32) {
                i64 u = NEG;
                if (fit[n] && fits_res(a.used + n * RES, a.cap + n * RES,
                                       rq, ck)) {
                    int rot = pn + n;
                    rot -= rot >= N ? N : 0;
                    u = wsub(wadd(wmul(score[n], N), rot), a.price[n]);
                }
                // columns rise along the lane: an equal value keeps the
                // earlier column
                if (u > v1) {
                    v2 = max(v2, v1);
                    v1 = u;
                    i1 = n;
                } else {
                    v2 = max(v2, u);
                }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                const i64 bv1 = __shfl_xor_sync(FULL, v1, off);
                const int bi1 = __shfl_xor_sync(FULL, i1, off);
                const i64 bv2 = __shfl_xor_sync(FULL, v2, off);
                top2_merge(v1, i1, v2, bv1, bi1, bv2);
            }
            if (lane == 0) {
                const bool valid = v1 > NEG;
                const i64 b = wadd(v2 > NEG ? wsub(v1, v2) : 0, eps);
                const i64 pk = min(max((i64)a.prio[p], (i64)0),
                                   (i64)((1 << 14) - 1));
                const i64 bk = min(max(b, (i64)0), (i64)((1LL << 31) - 1));
                const i64 rk = min(max((i64)P - (i64)a.order[p], (i64)0),
                                   (i64)((1 << 16) - 1));
                const i64 k = (pk << 48) + (bk << 16) + rk;
                a.n1[p] = valid ? i1 : -1;
                a.bid[p] = b;
                a.key[p] = k;
                if (valid) {
                    atomicMax(&a.win_key[i1], k);
                    atomicAdd(&a.bids[t], 1);
                }
            }
        }
        grid.sync();
        if (*(volatile int*)&a.bids[t] == 0) break;  // nothing can change
        // claim: the lowest slot holding its node's winning key
        for (int p = tid; p < P; p += nthreads) {
            const int n = a.n1[p];
            if (n >= 0 && a.key[p] == a.win_key[n])
                atomicMin(&a.win_p[n], p);
        }
        grid.sync();
        // update: seat each node's winner
        for (int n = tid; n < N; n += nthreads) {
            if (a.win_key[n] > NEG) {
                const int w = a.win_p[n];
                a.owner[w] = n;
#pragma unroll
                for (int r = 0; r < RES; ++r)
                    a.used[n * RES + r] = wadd(a.used[n * RES + r],
                                               a.commit[w * RES + r]);
                a.price[n] = wadd(a.price[n], max(a.bid[w], (i64)1));
            }
            a.win_key[n] = NEG;
            a.win_p[n] = NO_INDEX;
        }
        grid.sync();
    }
}

// -- K7b: the beam -----------------------------------------------------------

// (value desc, index asc): does (v, i) come before (w, j)?
__device__ __forceinline__ bool before(i64 v, int i, i64 w, int j) {
    return v > w || (v == w && i < j);
}

__global__ void __launch_bounds__(BEAM_THREADS)
assign_beam_kernel(const uint8_t* fit, const i64* score, const i64* req,
                   const i64* commit, const uint8_t* check, const i64* cap,
                   int P, int N, i64* used_buf, int* choice_buf,
                   int* owner) {
    constexpr int K = BEAM_K, C = BEAM_C, W = BEAM_THREADS / 32;
    __shared__ i64 acc[K];
    __shared__ i64 cand_v[K][C];
    __shared__ int cand_n[K][C];
    __shared__ int parent[K];
    __shared__ int node[K];
    __shared__ i64 red_v[W][K];
    __shared__ int red_i[W][K];
    __shared__ i64 win_v[K];
    __shared__ int win_i[K];
    __shared__ i64 cmt[RES];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int c_eff = min(C, N);
    i64* used_a = used_buf;
    i64* used_b = used_buf + (size_t)K * N * RES;
    int* choice_a = choice_buf;
    int* choice_b = choice_buf + (size_t)K * P;
    for (int i = tid; i < K * N * RES; i += BEAM_THREADS) used_a[i] = 0;
    for (int i = tid; i < K * P; i += BEAM_THREADS) choice_a[i] = -1;
    if (tid < K) acc[tid] = tid == 0 ? 0 : -(1LL << 59);
    __syncthreads();

    for (int p = 0; p < P; ++p) {
        i64 rq[RES];
        bool ck[RES];
#pragma unroll
        for (int r = 0; r < RES; ++r) {
            rq[r] = req[p * RES + r];
            ck[r] = check[p * RES + r] != 0;
        }
        if (tid < RES) cmt[tid] = commit[p * RES + tid];
        // this thread's top C of each beam, (util desc, node asc)
        i64 lv[K][C];
        int li[K][C];
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
            for (int c = 0; c < C; ++c) {
                lv[k][c] = EMPTY;
                li[k][c] = NO_INDEX;
            }
        for (int n = tid; n < N; n += BEAM_THREADS) {
            const bool f = fit[(size_t)p * N + n] != 0;
            const i64 s = score[(size_t)p * N + n];
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const i64 u =
                    f && fits_res(used_a + ((size_t)k * N + n) * RES,
                                  cap + n * RES, rq, ck) ? s : NEG;
                // nodes rise along the thread: an equal value stays behind
                if (u > lv[k][C - 1]) {
                    lv[k][C - 1] = u;
                    li[k][C - 1] = n;
#pragma unroll
                    for (int c = C - 1; c > 0; --c) {
                        const bool sw = lv[k][c] > lv[k][c - 1];
                        const i64 tv = lv[k][c];
                        const int ti = li[k][c];
                        lv[k][c] = sw ? lv[k][c - 1] : tv;
                        li[k][c] = sw ? li[k][c - 1] : ti;
                        lv[k][c - 1] = sw ? tv : lv[k][c - 1];
                        li[k][c - 1] = sw ? ti : li[k][c - 1];
                    }
                }
            }
        }
        // C rounds of a block argmax over the heads, every beam at once
        for (int c = 0; c < c_eff; ++c) {
            i64 v[K];
            int ix[K];
#pragma unroll
            for (int k = 0; k < K; ++k) {
                v[k] = lv[k][0];
                ix[k] = li[k][0];
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    const i64 ov = __shfl_xor_sync(FULL, v[k], off);
                    const int oi = __shfl_xor_sync(FULL, ix[k], off);
                    const bool take = before(ov, oi, v[k], ix[k]);
                    v[k] = take ? ov : v[k];
                    ix[k] = take ? oi : ix[k];
                }
            if (lane == 0)
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    red_v[warp][k] = v[k];
                    red_i[warp][k] = ix[k];
                }
            __syncthreads();
            if (warp == 0) {
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    v[k] = lane < W ? red_v[lane][k] : EMPTY;
                    ix[k] = lane < W ? red_i[lane][k] : NO_INDEX;
                }
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
#pragma unroll
                    for (int k = 0; k < K; ++k) {
                        const i64 ov = __shfl_xor_sync(FULL, v[k], off);
                        const int oi = __shfl_xor_sync(FULL, ix[k], off);
                        const bool take = before(ov, oi, v[k], ix[k]);
                        v[k] = take ? ov : v[k];
                        ix[k] = take ? oi : ix[k];
                    }
                if (lane == 0)
#pragma unroll
                    for (int k = 0; k < K; ++k) {
                        win_v[k] = v[k];
                        win_i[k] = ix[k];
                        cand_v[k][c] = v[k];
                        cand_n[k][c] = ix[k];
                    }
            }
            __syncthreads();
            // the thread holding a beam's winner pops it (nodes are unique)
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const bool pop = li[k][0] == win_i[k] && lv[k][0] == win_v[k];
#pragma unroll
                for (int q = 0; q < C - 1; ++q) {
                    lv[k][q] = pop ? lv[k][q + 1] : lv[k][q];
                    li[k][q] = pop ? li[k][q + 1] : li[k][q];
                }
                lv[k][C - 1] = pop ? EMPTY : lv[k][C - 1];
                li[k][C - 1] = pop ? NO_INDEX : li[k][C - 1];
            }
            __syncthreads();
        }
        // the K * (C + 1) successors and their top K
        if (tid == 0) {
            const int S = K * (c_eff + 1);
            i64 succ[K * (C + 1)];
            for (int j = 0; j < S; ++j) {
                const int k = j / (c_eff + 1), c = j % (c_eff + 1);
                succ[j] = c < c_eff
                    ? wadd(acc[k], cand_v[k][c] > NEG ? cand_v[k][c] : NO_FIT)
                    : wsub(acc[k], SKIP_PENALTY);
            }
            unsigned taken = 0;
            i64 top_v[K];
            for (int kk = 0; kk < K; ++kk) {
                int best = -1;
                for (int j = 0; j < S; ++j)
                    if (!(taken >> j & 1u) &&
                        (best < 0 || succ[j] > succ[best]))
                        best = j;
                taken |= 1u << best;
                top_v[kk] = succ[best];
                const int par = best / (c_eff + 1), slot = best % (c_eff + 1);
                const int sc = min(slot, c_eff - 1);
                const bool pick = slot < c_eff && cand_v[par][sc] > NEG;
                parent[kk] = par;
                node[kk] = pick ? cand_n[par][sc] : -1;
            }
            for (int kk = 0; kk < K; ++kk) acc[kk] = top_v[kk];
        }
        __syncthreads();
        // used and the choices, rebuilt from the parents
        for (int i = tid; i < K * N; i += BEAM_THREADS) {
            const int k = i / N, n = i - k * N;
            const i64* src = used_a + ((size_t)parent[k] * N + n) * RES;
            i64* dst = used_b + (size_t)i * RES;
            const bool hit = n == node[k];
#pragma unroll
            for (int r = 0; r < RES; ++r)
                dst[r] = hit ? wadd(src[r], cmt[r]) : src[r];
        }
        for (int i = tid; i < K * P; i += BEAM_THREADS) {
            const int k = i / P, q = i - k * P;
            choice_b[i] = q == p ? node[k] : choice_a[parent[k] * P + q];
        }
        __syncthreads();
        i64* ut = used_a; used_a = used_b; used_b = ut;
        int* ct = choice_a; choice_a = choice_b; choice_b = ct;
    }
    __shared__ int best_k;
    if (tid == 0) {
        int b = 0;
        for (int k = 1; k < K; ++k)
            if (acc[k] > acc[b]) b = k;
        best_k = b;
    }
    __syncthreads();
    for (int q = tid; q < P; q += BEAM_THREADS)
        owner[q] = choice_a[best_k * P + q];
}

// -- the C interface ---------------------------------------------------------

// the co-resident grid of the auction: -> blocks, or 0 on an error
static int auction_grid(int P, int N) {
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)
            != cudaSuccess || !coop)
        return 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
            != cudaSuccess)
        return 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, assign_auction_kernel, AUCTION_THREADS, 0) != cudaSuccess)
        return 0;
    const int warps = AUCTION_THREADS / 32;
    const int want = std::max(std::max((P + warps - 1) / warps,
                                       (N + AUCTION_THREADS - 1)
                                           / AUCTION_THREADS), 1);
    return std::min(want, per_sm * sms);
}

// scratch bytes the auction needs beside its inputs and owner
extern "C" long long assign_auction_scratch_bytes(int P, int N, int rounds) {
    return (long long)8 * (N + (long long)N * RES + N + P + P)
        + (long long)4 * (N + P + rounds);
}

extern "C" int assign_auction_grid(int P, int N) { return auction_grid(P, N); }

extern "C" int assign_auction_launch(
    const void* fit, const void* score, const void* req, const void* commit,
    const void* check, const void* cap, const void* prio, const void* order,
    long long eps0, int P, int N, int rounds, void* owner, void* scratch,
    void* stream) {
    if (P < 1 || N < 1 || rounds < 0) return (int)cudaErrorInvalidValue;
    const int blocks = auction_grid(P, N);
    if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
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
    a.owner = (int*)owner;
    i64* s64 = (i64*)scratch;
    a.price = s64;
    a.used = a.price + N;
    a.win_key = a.used + (size_t)N * RES;
    a.bid = a.win_key + N;
    a.key = a.bid + P;
    int* s32 = (int*)(a.key + P);
    a.win_p = s32;
    a.n1 = a.win_p + N;
    a.bids = a.n1 + P;
    void* args[] = {&a};
    cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)assign_auction_kernel, dim3(blocks),
        dim3(AUCTION_THREADS), args, 0, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" int assign_beam_launch(
    const void* fit, const void* score, const void* req, const void* commit,
    const void* check, const void* cap, int P, int N, void* used_buf,
    void* choice_buf, void* owner, void* stream) {
    if (P < 1 || N < 1) return (int)cudaErrorInvalidValue;
    assign_beam_kernel<<<1, BEAM_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)fit, (const i64*)score, (const i64*)req,
        (const i64*)commit, (const uint8_t*)check, (const i64*)cap, P, N,
        (i64*)used_buf, (int*)choice_buf, (int*)owner);
    return (int)cudaGetLastError();
}
