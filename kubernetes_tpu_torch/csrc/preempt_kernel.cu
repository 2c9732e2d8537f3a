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
//                slots counted as 0; cnt[i] the valid slots among them;
//                cprio[i] their summed priorities
//   fits[i]    = cnt[i] == i + 1 and free + cum[i] >= req on every row
//   needed[n]  = 0 if free >= req, else first fitting i + 1, else -1
//   cost[n]    = cprio[first] if needed > 0, 0 if needed == 0, else 1 << 62
//
// Bound: bytes. Each slot reads prio, ord and four res rows (40 B) and
// writes order (4 B); each node reads free (32 B) and writes needed and
// cost (12 B): at (N, C) = (8192, 32), the director's shape for 5,000
// nodes of 24 candidates, about 11.9 MB, 3.6 us at 3.35 TB/s. The sort
// and the scans are O(C log^2 C) integer operations a row, far below the
// card's integer rate at these C.
//
// Design (a simple one that is right; speed is later work):
// - One block per node row; thread t holds slot t (threads = max(C, 32)).
// - The sort: a bitonic sort in shared memory on the pair (key, column).
//   The pairs are distinct, so the order is unique, and equal keys keep
//   their column order: it equals jnp.argsort's stable sort.
// - After the sort, thread i gathers the resources and priority of its
//   sorted slot from device memory (the block just read them: L1/L2).
// - The scans: one block-wide inclusive scan of the six sums at once
//   (four resource rows, the valid count, the priorities): a warp scan
//   by shuffles, the warps' totals scanned by warp 0, added back.
// - The shortest fitting prefix: a block-wide min-reduction of the
//   fitting positions; the thread at that position (thread 0 when none
//   fits) writes needed and cost, its own scanned priority sum being the
//   prefix's cost.
// - Every sum and the key run in u64, so they wrap exactly as the
//   reference's int64 arithmetic does; compares are on int64.

#include <cuda_runtime.h>

typedef long long i64;
typedef unsigned long long u64;

constexpr int MAX_C = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr i64 SENTINEL = 1LL << 62;

// the scanned sums of a sorted prefix
struct Sums {
    u64 r[4];  // freed mcpu, memory, devices, pod slots
    u64 p;     // summed victim priorities
    int c;     // valid slots
};

__device__ __forceinline__ Sums add(Sums a, const Sums& b) {
#pragma unroll
    for (int k = 0; k < 4; ++k) a.r[k] += b.r[k];
    a.p += b.p;
    a.c += b.c;
    return a;
}

__device__ __forceinline__ Sums zero_sums() {
    Sums z;
#pragma unroll
    for (int k = 0; k < 4; ++k) z.r[k] = 0;
    z.p = 0;
    z.c = 0;
    return z;
}

// inclusive scan over the 32 lanes of a warp (every lane calls it)
__device__ __forceinline__ Sums warp_scan(Sums x, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        Sums y;
#pragma unroll
        for (int k = 0; k < 4; ++k) y.r[k] = __shfl_up_sync(FULL, x.r[k], d);
        y.p = __shfl_up_sync(FULL, x.p, d);
        y.c = __shfl_up_sync(FULL, x.c, d);
        if (lane >= d) x = add(x, y);
    }
    return x;
}

// inclusive scan over the block (every thread calls it)
__device__ __forceinline__ Sums block_scan(Sums x, Sums* tot, int t,
                                           int nwarps) {
    const int lane = t & 31, w = t >> 5;
    x = warp_scan(x, lane);
    if (lane == 31) tot[w] = x;
    __syncthreads();
    if (w == 0) {
        Sums y = lane < nwarps ? tot[lane] : zero_sums();
        y = warp_scan(y, lane);
        if (lane < nwarps) tot[lane] = y;
    }
    __syncthreads();
    if (w > 0) x = add(x, tot[w - 1]);
    return x;
}

__global__ void __launch_bounds__(MAX_C) victim_score_kernel(
    const int* __restrict__ prio, const int* __restrict__ ord,
    const i64* __restrict__ res, const i64* __restrict__ free_,
    const i64* __restrict__ req, int gang_prio, int C,
    int* __restrict__ needed, i64* __restrict__ cost,
    int* __restrict__ order) {
    extern __shared__ i64 smem[];
    i64* keys = smem;                 // [C]
    int* cols = (int*)(smem + C);     // [C]
    __shared__ Sums tot[MAX_C / 32];
    __shared__ int wmin[MAX_C / 32];

    const int t = threadIdx.x;
    const int nwarps = blockDim.x >> 5;
    const bool active = t < C;
    const i64 row = (i64)blockIdx.x * C;

    if (active) {
        const int p = prio[row + t];
        const u64 o = (u64)(i64)ord[row + t];
        const u64 k = (u64)(i64)p * (1ULL << 32) + ((1ULL << 32) - 1 - o);
        keys[t] = p < gang_prio ? (i64)k : SENTINEL;
        cols[t] = t;
    }
    __syncthreads();

    // bitonic sort of (key, column) ascending
    for (int k = 2; k <= C; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            const int u = t ^ j;
            if (active && u > t) {
                const i64 ka = keys[t], kb = keys[u];
                const int ca = cols[t], cb = cols[u];
                const bool greater = ka > kb || (ka == kb && ca > cb);
                if (greater == ((t & k) == 0)) {
                    keys[t] = kb;
                    keys[u] = ka;
                    cols[t] = cb;
                    cols[u] = ca;
                }
            }
            __syncthreads();
        }
    }

    Sums x = zero_sums();
    if (active) {
        const int c = cols[t];
        order[row + t] = c;
        const int p = prio[row + c];
        if (p < gang_prio) {
            const i64* r = res + (row + c) * 4;
#pragma unroll
            for (int k = 0; k < 4; ++k) x.r[k] = (u64)r[k];
            x.p = (u64)(i64)p;
            x.c = 1;
        }
    }
    x = block_scan(x, tot, t, nwarps);

    const i64* f = free_ + (i64)blockIdx.x * 4;
    bool fits_now = true, fits_after = active && x.c == t + 1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const i64 fk = f[k], rk = req[k];
        fits_now = fits_now && fk >= rk;
        fits_after = fits_after && (i64)((u64)fk + x.r[k]) >= rk;
    }

    // the shortest fitting prefix: min over the fitting positions
    unsigned cand = fits_after ? (unsigned)t : (unsigned)C;
    cand = __reduce_min_sync(FULL, cand);
    if ((t & 31) == 0) wmin[t >> 5] = (int)cand;
    __syncthreads();
    int first = C;
    for (int w = 0; w < nwarps; ++w) first = min(first, wmin[w]);

    if (t == (first < C ? first : 0)) {
        const int need = fits_now ? 0 : (first < C ? first + 1 : -1);
        needed[blockIdx.x] = need;
        cost[blockIdx.x] = need > 0 ? (i64)x.p : (need == 0 ? 0 : SENTINEL);
    }
}

// Launch on `stream`: one block per node row. C must be a power of two
// in 1..MAX_C. Returns cudaGetLastError() after the launch (0 ==
// cudaSuccess), or cudaErrorInvalidValue for a C the kernel does not take.
extern "C" int victim_score_launch(
    const void* prio, const void* ord, const void* res, const void* free_,
    const void* req, int gang_prio, int N, int C, void* needed, void* cost,
    void* order, void* stream) {
    if (C < 1 || C > MAX_C || (C & (C - 1)) != 0 || N < 0)
        return (int)cudaErrorInvalidValue;
    if (N > 0) {
        const int threads = C < 32 ? 32 : C;
        const size_t smem = (size_t)C * (sizeof(i64) + sizeof(int));
        victim_score_kernel<<<N, threads, smem, (cudaStream_t)stream>>>(
            (const int*)prio, (const int*)ord, (const i64*)res,
            (const i64*)free_, (const i64*)req, gang_prio, C,
            (int*)needed, (i64*)cost, (int*)order);
    }
    return (int)cudaGetLastError();
}
