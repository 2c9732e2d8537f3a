// The preemption victim scorer K6, written by hand for Hopper (sm_90a).
//
// Replaces kubernetes_tpu/ops/preempt.py:_victim_score_fn (:42), a
// program that XLA fuses (it has no Pallas source). Per node row n of C
// candidate slots (C a power of two, 1..1,024):
//
//   valid[c]   = prio[n,c] < gang_prio
//   key[c]     = valid ? prio*2^32 + (2^32 - 1 - ord) : 1 << 62   (int64)
//   order[n,:] = the stable argsort of key (the eviction order)
//   cum[i]     = freed resources (4 rows) of sorted slots 0..i, invalid
//                slots counted as 0; cprio[i] their summed priorities
//   fits[i]    = sorted slots 0..i all valid and free + cum[i] >= req
//                on every row
//   needed[n]  = 0 if free >= req, else first fitting i + 1, else -1
//   cost[n]    = cprio[first] if needed > 0, 0 if needed == 0, else 1 << 62
//
// Bound: bytes, counted from what the outputs depend on (chip_smoke.py
// victim_bound_ms): every slot's prio read and order written (8 B); a
// candidate's ord and four res rows (36 B more), since an invalid slot's
// key is the sentinel and what it frees is masked to 0; every node's
// free read and needed and cost written (44 B). At the gang phase's
// table, (N, C) = (8,192, 32) with 24 candidates on each of 5,000 rows,
// that is 6.78 MB, 0.00202 ms at 3.35 TB/s. The sort and the scans are
// O(C log^2 C) integer operations a row, below the bytes at these C.
//
// Design. The kernel reads only the bytes that count: prio for every
// slot, ord and res (two 16-byte loads) only where prio < gang_prio.
// The compare-exchange of the sort is branch-free (predicates and
// selects), so lanes of one warp never diverge inside the network.
// The launcher picks one of two paths from C.
// - C <= 32, the segment path (victim_score_kernel_seg<W>, W = C): one
//   W-lane warp segment a node row, 32 / W rows a warp, 256 / W rows a
//   block of 256 threads. Lane s of a segment holds slot s. The bitonic
//   sort on (key, column) runs in registers by __shfl_xor_sync with
//   partners lane ^ j, j < W, which never leave the segment; the
//   direction bit comes from the lane's index in its segment. The pairs
//   are distinct, so the order is unique and equals jnp.argsort's
//   stable order. Lane i then takes the resources and priority of its
//   sorted column from that column's lane (__shfl_sync), and one
//   segmented inclusive scan by __shfl_up_sync(width W) sums the four
//   resource rows and the priorities. A prefix is all valid while the
//   segment's ballot of sorted valid slots has no hole below it; the
//   first fitting prefix is the segment's ballot of fits, __ffs; its
//   cost is shuffled from that lane, and lane 0 writes needed and cost.
//   No shared memory, no barrier; free and req load with prio, so their
//   latency is off the end of the chain. A warp whose rows hold no
//   candidate at all (the pad rows) skips the sort and the scan: its
//   order is the columns in order (the stable order of equal sentinel
//   keys) and needed is 0 or -1 by free >= req alone.
// - 64 <= C <= 1,024, the block path (victim_score_kernel_blk<C>): one
//   block of C threads a row, thread t holding slot t. Sort stages with
//   j < 32 run by __shfl_xor_sync inside the warp; only those with
//   j >= 32 go through shared memory (double-buffered, one barrier each).
//   The sorted slot's priority comes from a shared copy of the row; its
//   resources are read from device memory after the sort (their only
//   read), where it is valid. The scan is a warp scan by shuffles plus
//   the totals of the warps before, from shared memory; the first
//   invalid sorted position and the first fitting prefix come from the
//   warps' ballots. A row with no candidate skips the sort as above.
// - Every sum and the key run in u64, so they wrap exactly as the
//   reference's int64 arithmetic does; compares are on int64.
// - Every lane of a warp runs every shuffle and ballot: lanes past the
//   last row stay in the network with predicated loads and stores.

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;
typedef unsigned long long u64;

constexpr int MAX_C = 1024;
constexpr int SEG_MAX_C = 32;     // the widest row of the segment path
constexpr int SEG_THREADS = 256;  // threads a block of the segment path
constexpr unsigned FULL = 0xffffffffu;
constexpr i64 SENTINEL = 1LL << 62;

// the scanned sums of a sorted prefix
struct Sums {
    u64 r[4];  // freed mcpu, memory, devices, pod slots
    u64 p;     // summed victim priorities
};

__device__ __forceinline__ Sums add(Sums a, const Sums& b) {
#pragma unroll
    for (int k = 0; k < 4; ++k) a.r[k] += b.r[k];
    a.p += b.p;
    return a;
}

__device__ __forceinline__ Sums zero_sums() {
    Sums z;
#pragma unroll
    for (int k = 0; k < 4; ++k) z.r[k] = 0;
    z.p = 0;
    return z;
}

// the eviction key of a candidate, built in u64 as the reference's int64
__device__ __forceinline__ i64 evict_key(int p, int o) {
    const u64 k = (u64)(i64)p * (1ULL << 32) + ((1ULL << 32) - 1 - (u64)(i64)o);
    return (i64)k;
}

// one compare-exchange of the bitonic network: take the partner's
// (key, column) when it is the smaller pair and this lane keeps the
// minimum, or the larger and it keeps the maximum (the pairs differ).
// Written without && and || so that it compiles to predicates and
// selects, not a branch that diverges within the warp at every stage
__device__ __forceinline__ void exchange(i64& key, int& col, i64 ok, int oc,
                                         bool keep_min) {
    const bool other_less = (ok < key) | ((ok == key) & (oc < col));
    const bool take = other_less == keep_min;
    key = take ? ok : key;
    col = take ? oc : col;
}

// the four freed resources of one slot: two 16-byte loads where res is
// 16-byte aligned (it is for any tensor that starts at an allocation)
__device__ __forceinline__ void load_res(const i64* __restrict__ res,
                                         i64 slot, bool vec, u64 r[4]) {
    const i64* q = res + slot * 4;
    if (vec) {
        const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(q));
        const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(q) + 1);
        r[0] = (u64)a.x;
        r[1] = (u64)a.y;
        r[2] = (u64)b.x;
        r[3] = (u64)b.y;
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) r[k] = (u64)__ldg(q + k);
    }
}

// a node's free row and the member's request; the segment path loads
// them with the slot's own inputs, off the end of its dependent chain
struct Fit {
    i64 f[4], q[4];
};

__device__ __forceinline__ Fit load_fit(const i64* __restrict__ free_,
                                        const i64* __restrict__ req, i64 row,
                                        bool live) {
    Fit a;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        a.f[k] = live ? __ldg(free_ + row * 4 + k) : 0;
        a.q[k] = __ldg(req + k);
    }
    return a;
}

// free >= req on every row: the node fits a member without evicting
__device__ __forceinline__ bool fits_now(const Fit& a) {
    bool ok = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) ok &= a.f[k] >= a.q[k];
    return ok;
}

// free + cum >= req on every row (the add wraps as int64)
__device__ __forceinline__ bool fits_after(const Fit& a, const Sums& x) {
    bool ok = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) ok &= (i64)((u64)a.f[k] + x.r[k]) >= a.q[k];
    return ok;
}

__device__ __forceinline__ void write_result(int* __restrict__ needed,
                                             i64* __restrict__ cost, i64 row,
                                             bool now, bool any, int first,
                                             u64 cprio) {
    const int need = now ? 0 : (any ? first + 1 : -1);
    needed[row] = need;
    cost[row] = need > 0 ? (i64)cprio : (need == 0 ? 0 : SENTINEL);
}

// C <= 32: one W-lane segment of a warp a node row
template <int W>
__global__ void __launch_bounds__(SEG_THREADS) victim_score_kernel_seg(
    const int* __restrict__ prio, const int* __restrict__ ord,
    const i64* __restrict__ res, const i64* __restrict__ free_,
    const i64* __restrict__ req, int gang_prio, int N, bool vec,
    int* __restrict__ needed, i64* __restrict__ cost,
    int* __restrict__ order) {
    constexpr unsigned SEG_MASK = W == 32 ? FULL : (1u << W) - 1u;
    const int lane = threadIdx.x & 31;
    const int s = lane & (W - 1);  // the slot this lane holds
    const int base = lane - s;     // the segment's first lane
    const i64 row = ((i64)blockIdx.x * SEG_THREADS + threadIdx.x) / W;
    const bool live = row < N;
    const i64 slot = row * W + s;

    const int p = live ? __ldg(prio + slot) : 0;
    const Fit fit_in = load_fit(free_, req, row, live);
    const bool valid = live && p < gang_prio;
    i64 key = SENTINEL;
    u64 r[4] = {0, 0, 0, 0};
    if (valid) {
        key = evict_key(p, __ldg(ord + slot));
        load_res(res, slot, vec, r);
    }
    const unsigned vbits = __ballot_sync(FULL, valid);
    if (vbits == 0) {
        // no candidate in this warp's rows: the columns stay in order
        if (live) {
            order[slot] = s;
            if (s == 0)
                write_result(needed, cost, row, fits_now(fit_in), false, 0, 0);
        }
        return;
    }

    // bitonic sort of (key, column) ascending, in registers
    int col = s;
#pragma unroll
    for (int k = 2; k <= W; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
            const i64 ok = __shfl_xor_sync(FULL, key, j);
            const int oc = __shfl_xor_sync(FULL, col, j);
            exchange(key, col, ok, oc, ((s & j) == 0) == ((s & k) == 0));
        }
    }
    if (live) order[slot] = col;

    // the sorted slot's resources and priority, from its column's lane
    const int src = base + col;
    const bool sv = (vbits >> src) & 1u;
    Sums x;
#pragma unroll
    for (int k = 0; k < 4; ++k) x.r[k] = __shfl_sync(FULL, r[k], src);
    x.p = (u64)(i64)__shfl_sync(FULL, valid ? p : 0, src);

    // segmented inclusive scan of the five sums
#pragma unroll
    for (int d = 1; d < W; d <<= 1) {
        Sums y;
#pragma unroll
        for (int k = 0; k < 4; ++k) y.r[k] = __shfl_up_sync(FULL, x.r[k], d, W);
        y.p = __shfl_up_sync(FULL, x.p, d, W);
        if (s >= d) x = add(x, y);
    }

    // a prefix counts while its sorted slots are all valid: no hole in
    // the segment's ballot at or below this slot ((2u << 31) - 1 is FULL)
    const unsigned seg_valid = (__ballot_sync(FULL, sv) >> base) & SEG_MASK;
    const bool prefix_ok = (~seg_valid & ((2u << s) - 1u)) == 0;
    const bool fit = live & prefix_ok & fits_after(fit_in, x);
    const unsigned seg_fit = (__ballot_sync(FULL, fit) >> base) & SEG_MASK;
    const int first = seg_fit ? __ffs(seg_fit) - 1 : 0;
    const u64 cprio = __shfl_sync(FULL, x.p, base + first);
    if (live && s == 0)
        write_result(needed, cost, row, fits_now(fit_in), seg_fit != 0, first,
                     cprio);
}

// 64 <= C <= 1,024: one block of C threads a node row
template <int C>
__global__ void __launch_bounds__(C) victim_score_kernel_blk(
    const int* __restrict__ prio, const int* __restrict__ ord,
    const i64* __restrict__ res, const i64* __restrict__ free_,
    const i64* __restrict__ req, int gang_prio, bool vec,
    int* __restrict__ needed, i64* __restrict__ cost,
    int* __restrict__ order) {
    constexpr int NW = C / 32;
    __shared__ i64 skey[2][C];
    __shared__ int scol[2][C];
    __shared__ int sprio[C];
    __shared__ Sums tot[NW];
    __shared__ int wbad[NW];
    __shared__ int wfit[NW];

    const int t = threadIdx.x, lane = t & 31, w = t >> 5;
    const i64 row = blockIdx.x;
    const i64 slot = row * C + t;
    const int p = __ldg(prio + slot);
    const bool valid = p < gang_prio;
    i64 key = valid ? evict_key(p, __ldg(ord + slot)) : SENTINEL;
    sprio[t] = p;
    if (!__syncthreads_or(valid)) {
        const Fit fit_in = load_fit(free_, req, row, true);
        // no candidate in the row: the columns stay in order
        order[slot] = t;
        if (t == 0) write_result(needed, cost, row, fits_now(fit_in), false, 0, 0);
        return;
    }

    // bitonic sort of (key, column) ascending: stages with j < 32 by
    // shuffles, the wider ones through shared memory
    int col = t;
    int buf = 0;
#pragma unroll
    for (int k = 2; k <= C; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
            i64 ok;
            int oc;
            if (j >= 32) {
                skey[buf][t] = key;
                scol[buf][t] = col;
                __syncthreads();
                ok = skey[buf][t ^ j];
                oc = scol[buf][t ^ j];
                buf ^= 1;
            } else {
                ok = __shfl_xor_sync(FULL, key, j);
                oc = __shfl_xor_sync(FULL, col, j);
            }
            exchange(key, col, ok, oc, ((t & j) == 0) == ((t & k) == 0));
        }
    }
    order[slot] = col;

    // the sorted slot's priority (shared copy) and resources (one read)
    const int pc = sprio[col];
    const bool sv = pc < gang_prio;
    Sums x = zero_sums();
    if (sv) {
        load_res(res, row * C + col, vec, x.r);
        x.p = (u64)(i64)pc;
    }

    // inclusive scan: the warp's by shuffles, then the warps' before it
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        Sums y;
#pragma unroll
        for (int k = 0; k < 4; ++k) y.r[k] = __shfl_up_sync(FULL, x.r[k], d);
        y.p = __shfl_up_sync(FULL, x.p, d);
        if (lane >= d) x = add(x, y);
    }
    const unsigned bad = ~__ballot_sync(FULL, sv);
    if (lane == 31) tot[w] = x;
    if (lane == 0) wbad[w] = bad ? w * 32 + __ffs(bad) - 1 : C;
    __syncthreads();
    int first_bad = C;
#pragma unroll
    for (int v = 0; v < NW; ++v) {
        first_bad = min(first_bad, wbad[v]);
        if (v < w) x = add(x, tot[v]);
    }

    // free and req load here, not with prio: held through the sort they
    // raise the registers from 32 to 46 (ptxas), and loading them early
    // (through shared memory, at 32) gained no time on the H100
    const Fit fit_in = load_fit(free_, req, row, true);
    const bool fit = (t < first_bad) & fits_after(fit_in, x);
    const unsigned fb = __ballot_sync(FULL, fit);
    if (lane == 0) wfit[w] = fb ? w * 32 + __ffs(fb) - 1 : C;
    __syncthreads();
    int first = C;
#pragma unroll
    for (int v = 0; v < NW; ++v) first = min(first, wfit[v]);
    if (t == (first < C ? first : 0))
        write_result(needed, cost, row, fits_now(fit_in), first < C, first, x.p);
}

template <int W>
static void launch_seg(const void* prio, const void* ord, const void* res,
                       const void* free_, const void* req, int gang_prio,
                       int N, bool vec, void* needed, void* cost,
                       void* order, cudaStream_t stream) {
    const i64 blocks = ((i64)N * W + SEG_THREADS - 1) / SEG_THREADS;
    victim_score_kernel_seg<W><<<(unsigned)blocks, SEG_THREADS, 0, stream>>>(
        (const int*)prio, (const int*)ord, (const i64*)res, (const i64*)free_,
        (const i64*)req, gang_prio, N, vec, (int*)needed, (i64*)cost,
        (int*)order);
}

template <int C>
static void launch_blk(const void* prio, const void* ord, const void* res,
                       const void* free_, const void* req, int gang_prio,
                       int N, bool vec, void* needed, void* cost,
                       void* order, cudaStream_t stream) {
    victim_score_kernel_blk<C><<<N, C, 0, stream>>>(
        (const int*)prio, (const int*)ord, (const i64*)res, (const i64*)free_,
        (const i64*)req, gang_prio, vec, (int*)needed, (i64*)cost,
        (int*)order);
}

// Launch on `stream`: the segment path for C <= SEG_MAX_C, the block
// path above. C must be a power of two in 1..MAX_C. Returns
// cudaGetLastError() after the launch (0 == cudaSuccess), or
// cudaErrorInvalidValue for a C the kernel does not take.
extern "C" int victim_score_launch(
    const void* prio, const void* ord, const void* res, const void* free_,
    const void* req, int gang_prio, int N, int C, void* needed, void* cost,
    void* order, void* stream) {
    if (C < 1 || C > MAX_C || (C & (C - 1)) != 0 || N < 0)
        return (int)cudaErrorInvalidValue;
    if (N > 0) {
        const bool vec = ((uintptr_t)res & 15) == 0;
        const cudaStream_t s = (cudaStream_t)stream;
        switch (C) {
#define K6_SEG(W) case W: launch_seg<W>(prio, ord, res, free_, req, gang_prio, N, vec, needed, cost, order, s); break;
#define K6_BLK(W) case W: launch_blk<W>(prio, ord, res, free_, req, gang_prio, N, vec, needed, cost, order, s); break;
            K6_SEG(1) K6_SEG(2) K6_SEG(4) K6_SEG(8) K6_SEG(16) K6_SEG(32)
            K6_BLK(64) K6_BLK(128) K6_BLK(256) K6_BLK(512) K6_BLK(1024)
#undef K6_SEG
#undef K6_BLK
        }
    }
    return (int)cudaGetLastError();
}
