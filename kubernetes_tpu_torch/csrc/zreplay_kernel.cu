// K3: the zoned device replay's pick loop, written by hand for Hopper
// (sm_90a).
//
// Replaces the K-step lax.scan of kubernetes_tpu/models/zreplay.py
// _replay_run (`scores` :103-193, `step` :195-233), which XLA fuses; it
// has no Pallas source. For one run of identical pods, in permuted
// (name-descending) node space, each step i < k_real:
//
//   score[n] = static_add + w_lr*LeastRequested(j[n]) + w_ba*Balanced(j[n])
//              + w_spread*SelectorSpread (float32, zone blend)
//              + w_na*NodeAffinity + w_tt*TaintToleration + w_ip*InterPod
//              (float64 normalizers over the live fit set)
//   m = the (L % ties)-th node of max score among fit nodes (selectHost)
//   j[m] += 1, L += 1; fit[m] = fit_static[m] && j[m] < frontier[m];
//   bail (n_done = i + 1) once j[m] >= rows_dyn.
//
// Bound: latency. Pick i+1 depends on pick i, so one block of 256 threads
// owns the run and the design shortens each step's critical path:
//
// - Only live nodes are swept. At the start the ids with fit_static &&
//   frontier > 0 are compacted in index order; thread t owns the
//   contiguous compacted range [t*P, t*P + P), so thread order, then slot
//   order, is index order. Padding and statically unfit nodes cost
//   nothing per pick.
// - One score evaluation per live node per pick, from registers. For
//   N <= 8,192 (the template's SLOTS = 1..32 nodes a thread) each thread
//   keeps its nodes' hot state in registers: the score without
//   SelectorSpread ("slow", i64), the cached spread term h (float32) and
//   a zone index (16 bits). h is the unblended fraction 10*((M - c)/M),
//   already multiplied by 1/3 for a zoned node; the zone's part
//   zt[z] = (2/3)*zone_score(z) sits in shared memory. A pick's score is
//   slow + w_spread * trunc(h + zt[z]): one float add, a truncation and a
//   u64 multiply-add, no division. h is recomputed only for the picked
//   node, and for all nodes when the spread maximum M changes. The sweep
//   is branch-free (an unfit slot is scored and masked), so the slots'
//   loads and arithmetic interleave; each thread keeps its maximum and a
//   bitmask of the slots that tie at it. Above 8,192 nodes the hot state
//   lives in device memory (`scratch`, slot-major, so a warp's loads are
//   coalesced) and the owner of the pick walks its slots to find its tie.
// - Two block barriers per pick. (A) each warp publishes (its maximum,
//   ties at it), reduced with redux.sync (the high words, then the low
//   words). After A every warp works out, redundantly and without atomics,
//   the block maximum, the tie count and the warp that holds the
//   (L % ties)-th tie in index order: by a ballot when no warp holds two
//   ties, else by a shuffle prefix sum. That warp finds the lane the same
//   way and the slot from the lane's tie mask. The owning thread commits;
//   its warp recomputes the zone terms when the zone maximum moves. (B)
//   publishes the commit: M and the holder counts, zone counts and terms,
//   the fit count, the stop flag. L advances in every thread's registers.
// - A short commit, from on-chip state only. Shared memory holds each
//   node's id, j, frontier, spread_base and delta: what the next commit
//   adds to its slow score (LR + BA at depth j+1 less at depth j, u64).
//   The commit adds delta in place and marks the slot pending; the thread
//   computes the slot's next delta (device-memory inputs, float64
//   divisions) later, while another warp commits (settle), or at once if
//   the node is picked again first. calculateScore's quotient is
//   estimated from BalancedAllocation's float64 fraction and corrected by
//   one integer step, as K1 does: no 64-bit integer division. The commit
//   reads device memory only for the normalizer inputs of a node that
//   leaves the fit set. j goes back to device memory once, at the end.
// - A node leaving the fit set costs a block pass only when it was the
//   last holder of M or of a normalizer's extremum (NodeAffinity,
//   TaintToleration, InterPod max, InterPod min): the block keeps each
//   extremum's holder count. The pass recomputes the extrema over the fit
//   set and, when a normalizer moved, every fit node's slow score. The
//   zone maximum is kept over the zone counts by the owner's warp.
//
// Bit-identity with the reference (the host spec replay
// models/replay._scores, the oracle, the JAX scan):
// - SelectorSpread rounds op by op in float32: __fdiv_rn, __fmul_rn,
//   __fadd_rn in the reference's order (f*(1/3) + (2/3)*zone_score), and
//   the build passes --fmad=false; int64 -> float32 is __ll2float_rn,
//   float32 -> int64 truncates (__float2ll_rz); a NaN (max_zone == 0,
//   0/0) maps to INT64_MIN. An unzoned node adds zt[0] = +0.0f, which
//   leaves its fraction as it is.
// - the float64 normalizers keep the reference's expression shapes
//   (10*(c/mx), (1 - c/mx)*10, 10*((c - mn)/rng)) with __ddiv_rn,
//   __dmul_rn and __dsub_rn: an integer rewrite is not equivalent.
// - LeastRequested and BalancedAllocation are recomputed from
//   nz + (j+1)*pod_nz: floor division, BalancedAllocation rounding twice.
// - score sums and weight products run in u64, so they wrap exactly as
//   the reference's int64 arithmetic does once INT64_MIN is in them.

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;
typedef unsigned long long u64;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SLOTS = 32;  // register path: N <= THREADS * MAX_SLOTS
constexpr int MAX_ZONES_REG = 1 << 16;  // and zone ids in 16 bits
constexpr unsigned FULL = 0xffffffffu;
constexpr i64 I64_MIN = (i64)0x8000000000000000ULL;
// selector_spreading.go:226 rounds the exact 1/3 and 2/3 once to float32
constexpr float THIRD = (float)(1.0 / 3.0);
constexpr float TWO_THIRDS = (float)(2.0 / 3.0);
// calc_score's estimate needs 10*cap to fit in int64
constexpr i64 EST_CAP_MAX = 1LL << 59;
// bytes of per-node state: cold (delta 8, spread_base 8, id 4, j 4,
// frontier 4), kept in shared memory where it fits; hot (slow 8, h 4,
// zone 4, fit 1), kept in device memory when it does not fit in registers
constexpr int COLD_BYTES = 28;
constexpr int HOT_BYTES = 17;

// layout of the i64 scalar vector (ops/zreplay_kernel.SCALARS)
enum { S_NZ_MCPU, S_NZ_MEM, S_SELFMATCH, S_L0, S_ACTIVE0 };
// the extrema tracked over the fit set: the spread maximum M and the
// normalizers
enum { E_M, E_NA, E_TT, E_IPX, E_IPN, NEXT };
// what a commit asks of the block after barrier B
enum { NEED_PASS = 1 };
// what a commit asks of its warp: the zone maximum may have fallen, or
// every zone term must be recomputed
enum { ZONE_NONE, ZONE_MAX, ZONE_ALL };

struct Params {
    const unsigned char* fit_static;
    const i64* frontier;
    const i64* static_add;
    const i64* spread_base;
    const i64* na;
    const i64* tt;
    const i64* ip;
    const i64* nz_cpu0;
    const i64* nz_mem0;
    const i64* alloc_cpu;
    const i64* alloc_mem;
    const int* zone_id;
    const i64* scal;
    int* chosen;
    i64* j;
    i64* st;
    unsigned char* scratch;  // per-node state in device memory, or null
    int N, K, k_real, num_zones, has_selectors;
    int cap;        // node slots of the state arrays: a multiple of THREADS
    int cold_smem;  // the cold state lives in shared memory
    i64 rows_dyn, w_lr, w_ba, w_spread, w_na, w_tt, w_ip;
};

struct Block {
    i64 wb[WARPS];  // per warp: its maximum score
    int wc[WARPS];  // and the ties at it
    i64 rv[WARPS][NEXT];
    int rc[WARPS][NEXT];
    int wsum[WARPS];
    i64 ext[NEXT];  // M, na max, tt max, ip max, ip min over the fit set
    int cnt[NEXT];  // fit nodes holding each (counted where it matters)
    i64 mz;         // the zone maximum
    i64 n_done;
    int n_fit, stop, bailed, need, m_changed, zone_op, zone_z;
};

// Pointers to the cold state, indexed by slot q = s * THREADS + t.
struct Cold {
    u64* delta;  // LR + BA at the next commit's depth less at this one's
    i64* sb;     // spread_base
    int* id;
    int* j;
    unsigned* fr;  // frontier, clamped to K + 1
};

// w = a == b ? v : w, opaque to the compiler's array analysis (see
// Hot::zi_rt)
__device__ __forceinline__ unsigned sel_eq(unsigned w, int a, int b,
                                           unsigned v) {
    asm("{ .reg .pred p; setp.eq.s32 p, %1, %2; selp.b32 %0, %3, %0, p; }"
        : "+r"(w) : "r"(a), "r"(b), "r"(v));
    return w;
}

// The hot state of a thread's slots: registers for SLOTS > 0.
template <int S>
struct Hot {
    i64 slow[S];
    float h[S];
    unsigned zp[(S + 1) / 2];  // zone indices, 16 bits each
    unsigned fit;
    __device__ __forceinline__ void bind(unsigned char*, int, int) {
        fit = 0;
#pragma unroll
        for (int q = 0; q < (S + 1) / 2; ++q) zp[q] = 0;
    }
    __device__ __forceinline__ i64 slow_at(int s) const { return slow[s]; }
    __device__ __forceinline__ float h_at(int s) const { return h[s]; }
    __device__ __forceinline__ int zi_at(int s) const {
        return (zp[s >> 1] >> ((s & 1) * 16)) & 0xffffu;
    }
    __device__ __forceinline__ bool fit_at(int s) const {
        return (fit >> s) & 1u;
    }
    // with s known at compile time (unrolled loops)
    __device__ __forceinline__ void init(int s, i64 sl, float hh, int z,
                                         bool f) {
        slow[s] = sl;
        h[s] = hh;
        const int sh = (s & 1) * 16;
        zp[s >> 1] = (zp[s >> 1] & ~(0xffffu << sh)) | ((unsigned)z << sh);
        fit = f ? fit | (1u << s) : fit & ~(1u << s);
    }
    __device__ __forceinline__ void put_slow(int s, i64 v) { slow[s] = v; }
    __device__ __forceinline__ void put_h(int s, float v) { h[s] = v; }
    // with s known only at run time: a select over the unrolled slots
    // keeps the arrays in registers
    // (selp in inline PTX: the compiler would turn a select chain written
    // in C++ back into an indexed array in local memory)
    __device__ __forceinline__ int zi_rt(int s) const {
        unsigned w = zp[0];
#pragma unroll
        for (int q = 1; q < (S + 1) / 2; ++q) w = sel_eq(w, q, s >> 1, zp[q]);
        return (w >> ((s & 1) * 16)) & 0xffffu;
    }
    __device__ __forceinline__ void commit(int s, u64 add, bool set_h,
                                           float hh, bool f) {
#pragma unroll
        for (int q = 0; q < S; ++q) {
            if (q == s) {
                slow[q] = (i64)((u64)slow[q] + add);
                if (set_h) h[q] = hh;
            }
        }
        if (!f) fit &= ~(1u << s);
    }
};

// SLOTS == 0: the hot state in device memory, slot-major.
template <>
struct Hot<0> {
    i64* slow;
    float* h;
    int* zi;
    unsigned char* fitb;
    int t;
    __device__ __forceinline__ void bind(unsigned char* mem, int cap,
                                         int tid) {
        slow = (i64*)mem;
        h = (float*)(slow + cap);
        zi = (int*)(h + cap);
        fitb = (unsigned char*)(zi + cap);
        t = tid;
    }
    __device__ __forceinline__ int at(int s) const { return s * THREADS + t; }
    __device__ __forceinline__ i64 slow_at(int s) const { return slow[at(s)]; }
    __device__ __forceinline__ int zi_rt(int s) const { return zi[at(s)]; }
    __device__ __forceinline__ float h_at(int s) const { return h[at(s)]; }
    __device__ __forceinline__ int zi_at(int s) const { return zi[at(s)]; }
    __device__ __forceinline__ bool fit_at(int s) const {
        return fitb[at(s)] != 0;
    }
    __device__ __forceinline__ void init(int s, i64 sl, float hh, int z,
                                         bool f) {
        slow[at(s)] = sl;
        h[at(s)] = hh;
        zi[at(s)] = z;
        fitb[at(s)] = f;
    }
    __device__ __forceinline__ void put_slow(int s, i64 v) { slow[at(s)] = v; }
    __device__ __forceinline__ void put_h(int s, float v) { h[at(s)] = v; }
    __device__ __forceinline__ void commit(int s, u64 add, bool set_h,
                                           float hh, bool f) {
        slow[at(s)] = (i64)((u64)slow[at(s)] + add);
        if (set_h) h[at(s)] = hh;
        fitb[at(s)] = f;
    }
};

// the reference's `//` on int64 (d != 0)
__device__ __noinline__ i64 floor_div(i64 n, i64 d) {
    const i64 q = n / d;
    return (q * d != n && ((n < 0) != (d < 0))) ? q - 1 : q;
}

// priorities.go:33 calculateScore: floor((cap - req)*10 / cap), 0 when
// cap == 0 or req > cap. frac is req/cap as BalancedAllocation rounds it.
// When 0 <= req <= cap <= 2^59 the quotient lies in [0, 10] and the
// estimate (1 - frac)*10, truncated, is off by at most one; one step on
// the exact remainder corrects it (the argument of csrc/probe_kernel.cu).
__device__ __forceinline__ i64 calc_score(i64 req, i64 cap, double frac) {
    if (cap == 0 || req > cap) return 0;
    if (req < 0 || cap > EST_CAP_MAX)
        return floor_div((i64)(((u64)cap - (u64)req) * 10u), cap);
    const i64 num = (cap - req) * 10;
    const int q = __double2int_rz(__dmul_rn(__dsub_rn(1.0, frac), 10.0));
    const i64 r = num - (i64)q * cap;
    return q + (r >= cap) - (r < 0);
}

// w_lr * LeastRequested + w_ba * BalancedAllocation at commit depth jn
// (nz + (jn + 1) * pod_nz). Out of line, with scalar arguments only: the
// pick loop calls it from several rare paths, and inlined copies would
// spread the loop's code over more than its instruction cache holds.
__device__ __noinline__ u64 lrba(i64 w_lr, i64 w_ba, i64 pnz_c, i64 pnz_m,
                                 i64 nzc, i64 nzm, i64 ac, i64 am, i64 jn) {
    if (!w_lr && !w_ba) return 0;
    const i64 tc = (i64)((u64)nzc + (u64)(jn + 1) * (u64)pnz_c);
    const i64 tm = (i64)((u64)nzm + (u64)(jn + 1) * (u64)pnz_m);
    const double cf = ac == 0 ? 1.0
        : __ddiv_rn(__ll2double_rn(tc), __ll2double_rn(ac));
    const double mf = am == 0 ? 1.0
        : __ddiv_rn(__ll2double_rn(tm), __ll2double_rn(am));
    u64 s = 0;
    if (w_lr) {
        const i64 lr = (i64)((u64)calc_score(tc, ac, cf)
                             + (u64)calc_score(tm, am, mf)) >> 1;
        s += (u64)w_lr * (u64)lr;
    }
    if (w_ba) {
        i64 ba = 0;
        if (!(cf >= 1.0 || mf >= 1.0))
            ba = __double2ll_rz(__dsub_rn(
                10.0, __dmul_rn(fabs(__dsub_rn(cf, mf)), 10.0)));
        s += (u64)w_ba * (u64)ba;
    }
    return s;
}

// LR + BA of node n at depth j (its inputs loaded together)
__device__ __forceinline__ u64 lrba_at(const Params& p, i64 pnz_c, i64 pnz_m,
                                       int n, i64 j) {
    return lrba(p.w_lr, p.w_ba, pnz_c, pnz_m, p.nz_cpu0[n], p.nz_mem0[n],
                p.alloc_cpu[n], p.alloc_mem[n], j);
}

// What a commit adds to node n's slow score when it holds j commits: LR
// + BA at depth j + 1 less at depth j (u64: the sum wraps back exactly)
__device__ __forceinline__ u64 lrba_step(const Params& p, i64 pnz_c,
                                         i64 pnz_m, int n, i64 j) {
    const i64 nzc = p.nz_cpu0[n], nzm = p.nz_mem0[n];
    const i64 ac = p.alloc_cpu[n], am = p.alloc_mem[n];
    return lrba(p.w_lr, p.w_ba, pnz_c, pnz_m, nzc, nzm, ac, am, j + 1)
           - lrba(p.w_lr, p.w_ba, pnz_c, pnz_m, nzc, nzm, ac, am, j);
}

// static_add + the normalized NodeAffinity, TaintToleration and InterPod
// terms of a node under the extrema ext. InterPod's part is masked by fit
// in the reference; only fit nodes' scores are ever read.
// (out of line, scalar arguments: see lrba)
__device__ __noinline__ u64 base_score(i64 w_na, i64 w_tt, i64 w_ip,
                                       i64 na_mx, i64 tt_mx, i64 ip_mx,
                                       i64 ip_mn, i64 sa, i64 na, i64 tt,
                                       i64 ip) {
    u64 s = (u64)sa;
    if (w_na) {
        const double f = na_mx > 0
            ? __dmul_rn(10.0, __ddiv_rn(__ll2double_rn(na),
                                        __ll2double_rn(na_mx)))
            : 0.0;
        s += (u64)w_na * (u64)__double2ll_rz(f);
    }
    if (w_tt) {
        const double f = tt_mx > 0
            ? __dmul_rn(__dsub_rn(1.0, __ddiv_rn(__ll2double_rn(tt),
                                                 __ll2double_rn(tt_mx))),
                        10.0)
            : 10.0;
        s += (u64)w_tt * (u64)__double2ll_rz(f);
    }
    if (w_ip) {
        const i64 rng = (i64)((u64)ip_mx - (u64)ip_mn);
        const double f = rng > 0
            ? __dmul_rn(10.0, __ddiv_rn(
                  __ll2double_rn((i64)((u64)ip - (u64)ip_mn)),
                  __ll2double_rn(rng)))
            : 0.0;
        s += (u64)w_ip * (u64)__double2ll_rz(f);
    }
    return s;
}

// the cached spread term: 10 * ((M - c) / M) (10 when M == 0), times 1/3
// for a node whose score the zone term blends
__device__ __forceinline__ float spread_h(i64 M, i64 c, bool zoned) {
    float f = 10.0f;
    if (M > 0) f = __fmul_rn(10.0f, __fdiv_rn(__ll2float_rn(M - c),
                                              __ll2float_rn(M)));
    return zoned ? __fmul_rn(f, THIRD) : f;
}

// a zone's part of the blend: (2/3) * 10 * ((max_zone - zc) / max_zone)
__device__ __forceinline__ float zone_term(i64 mz, i64 zcz) {
    return __fmul_rn(TWO_THIRDS,
                     __fmul_rn(10.0f, __fdiv_rn(__ll2float_rn(mz - zcz),
                                                __ll2float_rn(mz))));
}

// The combined score from a node's hot state.
__device__ __forceinline__ i64 score_of(i64 slow, float h, float zt,
                                        u64 wsp) {
    const float f = __fadd_rn(h, zt);
    const i64 sp = isnan(f) ? I64_MIN : __float2ll_rz(f);
    return (i64)((u64)slow + wsp * (u64)sp);
}

// The sweep: each live node's score once; the thread's maximum tb and its
// ties (the slot mask tm in registers, the count tc in memory). It is
// branch-free, so that the slots' loads and arithmetic interleave: every
// slot is scored, and an unfit one is masked out.
template <int S>
__device__ __forceinline__ void sweep(const Hot<S>& hot, const float* zt,
                                      int NS, u64 wsp, i64& tb, unsigned& tm,
                                      int& tc) {
    tb = I64_MIN;
    tm = 0;
    tc = 0;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        const i64 sc = score_of(hot.slow_at(s), hot.h_at(s),
                                zt[hot.zi_at(s)], wsp);
        const bool f = hot.fit_at(s);
        const bool gt = f & (sc > tb);
        const bool eq = f & (sc == tb);
        tb = gt ? sc : tb;
        if (S > 0)
            tm = gt ? 1u << s : (eq ? tm | 1u << s : tm);
        else
            tc = gt ? 1 : tc + eq;
    }
    if (S > 0) tc = __popc(tm);
}

__device__ __forceinline__ i64 warp_max(i64 v) {
    for (int o = 16; o > 0; o >>= 1) {
        const i64 w = __shfl_xor_sync(FULL, v, o);
        v = w > v ? w : v;
    }
    return v;
}

// The warp's maximum of v (every lane) by two 32-bit redux.sync: the high
// words as signed, then the low words of the lanes at that high word.
__device__ __forceinline__ i64 warp_max_redux(i64 v) {
    const int hi = (int)(v >> 32);
    const int mh = __reduce_max_sync(FULL, hi);
    const unsigned ml = __reduce_max_sync(FULL, hi == mh ? (unsigned)v : 0u);
    return (i64)(((u64)(unsigned)mh << 32) | ml);
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v += u;
    }
    return v;
}

// (v, c) <- the extremum of (v, c) and (w, d), with its holders summed
__device__ __forceinline__ void combine(i64& v, int& c, i64 w, int d,
                                        bool is_min) {
    const i64 m = is_min ? (w < v ? w : v) : (w > v ? w : v);
    c = (v == m ? c : 0) + (w == m ? d : 0);
    v = m;
}

// Every thread's (v[k], c[k]) -> the block's extremum and holder count,
// in every thread. All threads.
__device__ __noinline__ void block_ext(Block& sh, i64* v, int* c) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k = 0; k < NEXT; ++k) {
        for (int o = 16; o > 0; o >>= 1) {
            const i64 w = __shfl_xor_sync(FULL, v[k], o);
            const int d = __shfl_xor_sync(FULL, c[k], o);
            combine(v[k], c[k], w, d, k == E_IPN);
        }
        if (lane == 0) {
            sh.rv[warp][k] = v[k];
            sh.rc[warp][k] = c[k];
        }
    }
    __syncthreads();
    for (int k = 0; k < NEXT; ++k) {
        v[k] = sh.rv[0][k];
        c[k] = sh.rc[0][k];
        for (int w = 1; w < WARPS; ++w)
            combine(v[k], c[k], sh.rv[w][k], sh.rc[w][k], k == E_IPN);
    }
    __syncthreads();
}

// the position of the (r+1)-th lowest set bit of mask
__device__ __forceinline__ int nth_bit(unsigned mask, int r) {
    for (; r > 0; --r) mask &= mask - 1;
    return __ffs(mask) - 1;
}

// r = L mod total, in [0, total)
__device__ __forceinline__ int mod_total(i64 L, int total) {
    if ((u64)L < (1ULL << 32)) return (int)((unsigned)L % (unsigned)total);
    const i64 r = L % total;
    return (int)(r < 0 ? r + total : r);
}

// Recompute the extrema over the fit set and what depends on them: every
// fit node's j-independent part when a normalizer moved (or `first`, which
// also sets the slow scores at j = 0), every fit node's spread term when M
// moved. All threads.
template <int S>
__device__ __forceinline__ void refresh(const Params& p, Block& sh, Hot<S>& hot,
                                     const Cold& cold, int P, bool first,
                                     bool selfmatch, bool spread_live,
                                     i64 pnz_c, i64 pnz_m) {
    const int NS = S > 0 ? S : P;
    i64 old[NEXT];
#pragma unroll
    for (int k = 0; k < NEXT; ++k) old[k] = sh.ext[k];
    i64 v[NEXT] = {0, 0, 0, 0, 0};
    int c[NEXT] = {0, 0, 0, 0, 0};
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        if (!hot.fit_at(s)) continue;
        const int q = s * THREADS + threadIdx.x, n = cold.id[q];
        const i64 cn = (i64)((u64)cold.sb[q]
                             + (selfmatch ? (u64)cold.j[q] : 0));
        combine(v[E_M], c[E_M], cn, 1, false);
        if (p.w_na) combine(v[E_NA], c[E_NA], p.na[n], 1, false);
        if (p.w_tt) combine(v[E_TT], c[E_TT], p.tt[n], 1, false);
        if (p.w_ip) {
            combine(v[E_IPX], c[E_IPX], p.ip[n], 1, false);
            combine(v[E_IPN], c[E_IPN], p.ip[n], 1, true);
        }
    }
    block_ext(sh, v, c);
    const bool renorm = first || v[E_NA] != old[E_NA]
        || v[E_TT] != old[E_TT] || v[E_IPX] != old[E_IPX]
        || v[E_IPN] != old[E_IPN];
    const bool m_moved = spread_live && (first || v[E_M] != old[E_M]);
    if (threadIdx.x == 0) {
        for (int k = 0; k < NEXT; ++k) {
            sh.ext[k] = v[k];
            sh.cnt[k] = c[k];
        }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        if (!hot.fit_at(s)) continue;
        const int q = s * THREADS + threadIdx.x, n = cold.id[q];
        if (renorm) {
            // slow anew: the normalized terms plus LR + BA at depth j
            const u64 b = base_score(p.w_na, p.w_tt, p.w_ip, v[E_NA],
                                     v[E_TT], v[E_IPX], v[E_IPN],
                                     p.static_add[n], p.na[n], p.tt[n],
                                     p.ip[n]);
            hot.put_slow(s, (i64)(b + lrba_at(p, pnz_c, pnz_m, n,
                                              cold.j[q])));
            if (first) cold.delta[q] = lrba_step(p, pnz_c, pnz_m, n, 0);
        }
        if (m_moved) {
            const i64 cn = (i64)((u64)cold.sb[q]
                                 + (selfmatch ? (u64)cold.j[q] : 0));
            hot.put_h(s, spread_h(v[E_M], cn, hot.zi_at(s) > 0));
        }
    }
}

// Every fit node's spread term under the block's M. All threads.
template <int S>
__device__ __forceinline__ void rehash(const Params& p, const Block& sh,
                                    Hot<S>& hot, const Cold& cold, int P,
                                    bool selfmatch) {
    const int NS = S > 0 ? S : P;
    const i64 M = sh.ext[E_M];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        if (!hot.fit_at(s)) continue;
        const int q = s * THREADS + threadIdx.x;
        const i64 cn = (i64)((u64)cold.sb[q]
                             + (selfmatch ? (u64)cold.j[q] : 0));
        hot.put_h(s, spread_h(M, cn, hot.zi_at(s) > 0));
    }
}

// One thread: commit step i to the node in its slot s (cold slot q). Its
// inputs are on chip: the commit reads device memory only for the
// normalizer inputs of a node that leaves the fit set. In the register
// path the slot's cold.delta is used and the slot joins the thread's
// pending mask: its next delta is computed later, off the pick's critical
// path (settle), or here if the node is picked again before that.
template <int S>
__device__ __forceinline__ void commit(const Params& p, Block& sh, Hot<S>& hot,
                                    const Cold& cold, i64* zc, float* zt,
                                    int s, int q, int i, bool selfmatch,
                                    bool spread_live, bool zoned, i64 pnz_c,
                                    i64 pnz_m, unsigned& pend,
                                    unsigned& half) {
    const int m = cold.id[q];
    const i64 sb = cold.sb[q];
    const int z = hot.zi_rt(s);  // the zone where the blend reads it, else 0
    const int j_old = cold.j[q];
    const i64 jm = (i64)j_old + 1;
    const bool new_fit = (u64)jm < (u64)cold.fr[q];
    cold.j[q] = (int)jm;
    p.chosen[i] = m;
    u64 add;
    if (S > 0) {
        const unsigned bit = 1u << s;
        if ((pend | half) & bit) {
            cold.delta[q] = lrba_step(p, pnz_c, pnz_m, m, j_old);
            half &= ~bit;
        }
        add = cold.delta[q];
        pend |= bit;
    } else {
        add = lrba_step(p, pnz_c, pnz_m, m, j_old);
    }
    const i64 c_old = (i64)((u64)sb + (selfmatch ? (u64)j_old : 0));
    const i64 c_new = (i64)((u64)sb + (selfmatch ? (u64)jm : 0));
    int need = 0, m_changed = 0, zop = ZONE_NONE;
    const i64 M = sh.ext[E_M];
    if (new_fit) {
        if (spread_live) {
            if (c_new > M) {
                sh.ext[E_M] = c_new;
                sh.cnt[E_M] = 1;
                m_changed = 1;
            } else if (M > 0 && c_new == M && c_old != M) {
                sh.cnt[E_M] += 1;
            }
        }
    } else {
        sh.n_fit -= 1;
        if (spread_live && M > 0 && c_old == M && --sh.cnt[E_M] == 0)
            need = NEED_PASS;
        const i64 na = p.w_na ? p.na[m] : 0, tt = p.w_tt ? p.tt[m] : 0;
        const i64 ip = p.w_ip ? p.ip[m] : 0;
        const i64 val[NEXT] = {0, na, tt, ip, ip};
        const bool on[NEXT] = {false, p.w_na && sh.ext[E_NA] > 0,
                               p.w_tt && sh.ext[E_TT] > 0,
                               p.w_ip && sh.ext[E_IPX] > 0,
                               p.w_ip && sh.ext[E_IPN] < 0};
#pragma unroll
        for (int k = E_NA; k < NEXT; ++k)
            if (on[k] && val[k] == sh.ext[k] && --sh.cnt[k] == 0)
                need = NEED_PASS;
    }
    // m's zone count (read only by the blend, for zones > 0); its zone
    // term, or the zone maximum
    const i64 z_old = z > 0 ? zc[z] : 0;
    const i64 z_new = (i64)((u64)z_old + (new_fit ? (u64)c_new : 0)
                            - (u64)c_old);
    if (z > 0) zc[z] = z_new;
    if (z > 0 && z_new != z_old) {
        if (z_new > sh.mz) {
            sh.mz = z_new;
            zop = ZONE_ALL;
        } else if (z_old == sh.mz && z_new < z_old) {
            zop = ZONE_MAX;
        } else {
            zt[z] = zone_term(sh.mz, z_new);
        }
    }
    // when M moved, every spread term is recomputed after barrier B
    const bool set_h = spread_live && new_fit && !m_changed;
    hot.commit(s, add, set_h,
               set_h ? spread_h(M, c_new, z > 0) : 0.0f, new_fit);
    sh.need = need;
    sh.m_changed = m_changed;
    sh.zone_op = zop;
    sh.zone_z = z;
    if (jm >= p.rows_dyn) {
        sh.stop = 1;
        sh.bailed = 1;
        sh.n_done = i + 1;
    }
}

// One LR + BA evaluation towards the thread's pending deltas, so that it
// fits in the time of the owner's commit: a slot in `half` holds LR + BA
// at its depth j and gets its delta (LR + BA at j + 1 less that); else a
// slot in `pend` gets LR + BA at depth j and moves to `half`.
__device__ __forceinline__ void settle(const Params& p, const Cold& cold,
                                       unsigned& pend, unsigned& half,
                                       i64 pnz_c, i64 pnz_m) {
    const bool second = half != 0;
    const unsigned mk = second ? half : pend;
    const int s = __ffs(mk) - 1;
    const int q = s * THREADS + threadIdx.x;
    const i64 j = cold.j[q];
    const u64 v = lrba_at(p, pnz_c, pnz_m, cold.id[q], second ? j + 1 : j);
    if (second) {
        cold.delta[q] = v - cold.delta[q];
        half &= half - 1;
    } else {
        cold.delta[q] = v;
        pend &= pend - 1;
        half |= 1u << s;
    }
}

// The commit's zone work, by the owner's warp: the zone maximum over the
// zone counts when it may have fallen, then the zone terms.
__device__ __forceinline__ void zone_work(Block& sh, const i64* zc,
                                          float* zt, int nz, int lane) {
    const int zop = sh.zone_op;
    if (zop == ZONE_NONE) return;
    i64 mz = sh.mz;
    bool all = zop == ZONE_ALL;
    if (zop == ZONE_MAX) {
        i64 v = 0;
        for (int z = 1 + lane; z < nz; z += 32) v = zc[z] > v ? zc[z] : v;
        v = warp_max(v);
        all = v != mz;
        mz = v;
        if (lane == 0) {
            sh.mz = v;
            if (!all) zt[sh.zone_z] = zone_term(v, zc[sh.zone_z]);
        }
    }
    if (all)
        for (int z = 1 + lane; z < nz; z += 32) zt[z] = zone_term(mz, zc[z]);
}

template <int S>
__global__ void __launch_bounds__(THREADS, 1) zreplay_kernel(Params p) {
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ Block sh;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int N = p.N, nz = p.num_zones;
    const i64 pnz_c = p.scal[S_NZ_MCPU], pnz_m = p.scal[S_NZ_MEM];
    const bool selfmatch = p.scal[S_SELFMATCH] > 0;
    const bool active0 = p.scal[S_ACTIVE0] != 0;
    const bool spread_live = p.w_spread != 0 && p.has_selectors;
    const bool zoned = spread_live && nz > 1;

    for (int n = t; n < N; n += THREADS) p.j[n] = 0;
    if (!active0) {  // an aborted run: nothing schedules
        for (int q = t; q < p.K; q += THREADS) p.chosen[q] = -1;
        if (t == 0) {
            p.st[0] = p.scal[S_L0];
            p.st[1] = p.k_real;
            p.st[2] = 0;
        }
        return;
    }
    // shared memory: zone counts (i64), zone terms (f32), then the cold
    // state where it fits
    i64* zc = (i64*)dyn;
    float* zt = (float*)(zc + nz);
    const size_t zone_bytes = ((size_t)nz * 12 + 15) & ~(size_t)15;
    unsigned char* cold_mem = p.cold_smem ? dyn + zone_bytes : p.scratch;
    unsigned char* hot_mem = p.cold_smem
        ? p.scratch : p.scratch + (size_t)p.cap * COLD_BYTES;
    Cold cold;
    cold.delta = (u64*)cold_mem;
    cold.sb = (i64*)(cold.delta + p.cap);
    cold.id = (int*)(cold.sb + p.cap);
    cold.j = cold.id + p.cap;
    cold.fr = (unsigned*)(cold.j + p.cap);
    Hot<S> hot;
    hot.bind(hot_mem, p.cap, t);

    for (int z = t; z < nz; z += THREADS) {
        zc[z] = 0;
        zt[z] = 0.0f;
    }
    if (t == 0) {
        sh.n_done = p.k_real;
        sh.stop = 0;
        sh.bailed = 0;
        sh.need = 0;
        sh.m_changed = 0;
        sh.zone_op = ZONE_NONE;
        for (int k = 0; k < NEXT; ++k) sh.ext[k] = 0;
    }
    // compact the live ids (fit_static && frontier > 0) in index order:
    // thread t scans raw nodes [t*C, t*C + C)
    const int C = (N + THREADS - 1) / THREADS;
    const int n0 = t * C, n1 = min(N, n0 + C);
    int mine = 0;
    for (int n = n0; n < n1; ++n) mine += p.fit_static[n] && p.frontier[n] > 0;
    const int incl = warp_incl_scan(mine, lane);
    if (lane == 31) sh.wsum[warp] = incl;
    __syncthreads();
    int NL = 0, ci = incl - mine;
    for (int w = 0; w < WARPS; ++w) {
        ci += w < warp ? sh.wsum[w] : 0;
        NL += sh.wsum[w];
    }
    const int P = (NL + THREADS - 1) / THREADS;
    for (int n = n0; n < n1; ++n) {
        if (p.fit_static[n] && p.frontier[n] > 0) {
            cold.id[(ci % P) * THREADS + ci / P] = n;
            ++ci;
        }
    }
    __syncthreads();
    // thread t's slots: compacted [t*P, t*P + P), cold slot s*THREADS + t
    const int NS = S > 0 ? S : P;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        const bool live = s < P && t * P + s < NL;
        int zi = 0;
        if (live) {
            const int q = s * THREADS + t, n = cold.id[q];
            const i64 fr = p.frontier[n];
            cold.j[q] = 0;
            cold.sb[q] = p.spread_base[n];
            cold.fr[q] = (unsigned)(fr < (i64)p.K + 1 ? fr : (i64)p.K + 1);
            const int z = p.zone_id[n];
            atomicAdd((u64*)&zc[z], (u64)p.spread_base[n]);
            zi = zoned && z > 0 ? z : 0;
        }
        hot.init(s, 0, 10.0f, zi, live);
    }
    if (t == 0) sh.n_fit = NL;
    __syncthreads();
    if (zoned && warp == 0) {
        i64 v = 0;
        for (int z = 1 + lane; z < nz; z += 32) v = zc[z] > v ? zc[z] : v;
        v = warp_max(v);
        if (lane == 0) sh.mz = v;
        for (int z = 1 + lane; z < nz; z += 32) zt[z] = zone_term(v, zc[z]);
    }
    refresh<S>(p, sh, hot, cold, P, true, selfmatch, spread_live, pnz_c,
               pnz_m);
    __syncthreads();

    const u64 wsp = (u64)p.w_spread;
    i64 L = p.scal[S_L0];
    int i = 0;
    // slots whose cold.delta awaits their new depth (see settle)
    unsigned pend = 0, half = 0;
    while (i < p.k_real && sh.n_fit > 0) {
        // the sweep: each live node's score once; the thread's maximum and
        // its ties (a slot mask in registers, a count in memory)
        i64 tb;
        unsigned tm;
        int tc;
        sweep<S>(hot, zt, NS, wsp, tb, tm, tc);
        const i64 wb = warp_max_redux(tb);
        const int wc = __reduce_add_sync(FULL, tb == wb ? tc : 0);
        if (lane == 0) {
            sh.wb[warp] = wb;
            sh.wc[warp] = wc;
        }
        __syncthreads();  // A
        // every warp: the block maximum, the ties and the warp holding
        // the (L % ties)-th tie in index order; a ballot finds it when no
        // warp holds two ties, else a prefix sum
        const i64 b = lane < WARPS ? sh.wb[lane] : I64_MIN;
        const int c = lane < WARPS ? sh.wc[lane] : 0;
        const i64 bmax = warp_max_redux(b);
        const int tw = b == bmax ? c : 0;
        const int total = __reduce_add_sync(FULL, tw);
        const int r = total == 1 ? 0 : mod_total(L, total);
        const unsigned wmask = __ballot_sync(FULL, tw > 0);
        int ow, excl_w;
        if (__popc(wmask) == total) {
            ow = nth_bit(wmask, r);
            excl_w = r;
        } else {
            const int winc = warp_incl_scan(tw, lane);
            ow = __ffs(__ballot_sync(FULL, winc - tw <= r && r < winc)) - 1;
            excl_w = __shfl_sync(FULL, winc - tw, ow);
        }
        if (warp == ow) {
            // the lane, then the slot, the same way
            const int tt = tb == bmax ? tc : 0;
            const int rl = r - excl_w;
            const unsigned lmask = __ballot_sync(FULL, tt > 0);
            int ol, rr = 0;
            if (__popc(lmask) == __shfl_sync(FULL, tw, ow)) {
                ol = nth_bit(lmask, rl);
            } else {
                const int linc = warp_incl_scan(tt, lane);
                ol = __ffs(__ballot_sync(FULL, linc - tt <= rl && rl < linc))
                     - 1;
                rr = rl - (linc - tt);
            }
            if (lane == ol) {
                int s = 0;
                if (S > 0) {
                    unsigned mk = tm;
                    for (; rr > 0; --rr) mk &= mk - 1;
                    s = __ffs(mk) - 1;
                } else {
                    for (;; ++s) {
                        if (hot.fit_at(s)
                            && score_of(hot.slow_at(s), hot.h_at(s),
                                        zt[hot.zi_at(s)], wsp) == bmax) {
                            if (rr == 0) break;
                            --rr;
                        }
                    }
                }
                commit<S>(p, sh, hot, cold, zc, zt, s, s * THREADS + t, i,
                          selfmatch, spread_live, zoned, pnz_c, pnz_m, pend,
                          half);
            }
            __syncwarp();
            zone_work(sh, zc, zt, nz, lane);
        } else if (S > 0 && (pend | half)) {
            // while the owner commits: this thread's deferred LR + BA
            settle(p, cold, pend, half, pnz_c, pnz_m);
        }
        ++L;
        __syncthreads();  // B
        ++i;
        if (sh.stop) break;
        if (sh.need)
            refresh<S>(p, sh, hot, cold, P, false, selfmatch, spread_live,
                       pnz_c, pnz_m);
        else if (sh.m_changed)
            rehash<S>(p, sh, hot, cold, P, selfmatch);
    }
    // j back to device memory, once
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        if (s < P && t * P + s < NL) {
            const int q = s * THREADS + t;
            p.j[cold.id[q]] = cold.j[q];
        }
    }
    for (int q = i + t; q < p.K; q += THREADS) p.chosen[q] = -1;
    if (t == 0) {
        p.st[0] = L;
        p.st[1] = sh.n_done;
        p.st[2] = sh.bailed;
    }
}

// Nodes per thread in registers for N nodes, or 0 for the memory path.
static int slots_for(int N, int num_zones) {
    if (num_zones > MAX_ZONES_REG) return 0;
    for (int s = 1; s <= MAX_SLOTS; s *= 2)
        if (N <= s * THREADS) return s;
    return 0;
}

struct Layout {
    int slots, cap, cold_smem;
    size_t smem, scratch;
    void (*kern)(Params);
    int optin;  // dynamic shared memory the kernel may use
};

static void (*kernel_for(int slots))(Params) {
    switch (slots) {
        case 1: return zreplay_kernel<1>;
        case 2: return zreplay_kernel<2>;
        case 4: return zreplay_kernel<4>;
        case 8: return zreplay_kernel<8>;
        case 16: return zreplay_kernel<16>;
        case 32: return zreplay_kernel<32>;
        default: return zreplay_kernel<0>;
    }
}

// *bytes <- the dynamic shared memory kern may opt in to: the device's
// per-block maximum less the kernel's static shared memory
static int smem_optin(void (*kern)(Params), int* bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
    if (err == cudaSuccess) *bytes -= (int)attr.sharedSizeBytes;
    return (int)err;
}

// The launch's layout at (N, num_zones): -> 0, a CUDA error code, or -1
// when num_zones does not fit in shared memory.
static int layout(int N, int num_zones, Layout* lay) {
    lay->slots = slots_for(N, num_zones);
    lay->kern = kernel_for(lay->slots);
    const int err = smem_optin(lay->kern, &lay->optin);
    if (err != 0) return err;
    const size_t optin = (size_t)lay->optin;
    const size_t zone_bytes = ((size_t)num_zones * 12 + 15) & ~(size_t)15;
    if (zone_bytes > optin) return -1;
    lay->cap = lay->slots > 0 ? lay->slots * THREADS
        : (N + THREADS - 1) / THREADS * THREADS;
    const size_t cold = (size_t)lay->cap * COLD_BYTES;
    lay->cold_smem = zone_bytes + cold <= optin;
    lay->smem = zone_bytes + (lay->cold_smem ? cold : 0);
    size_t scratch = lay->cold_smem ? 0 : cold;
    if (lay->slots == 0) scratch += (size_t)lay->cap * HOT_BYTES;
    lay->scratch = (scratch + 15) & ~(size_t)15;
    return 0;
}

// Plain C interface for ctypes: pointers and the stream as void*.

// *bytes <- device-memory scratch the launch needs at (N, num_zones): 0
// when the node state fits on chip. Returns a CUDA error code, or -1 when
// num_zones does not fit in shared memory at all.
extern "C" int zreplay_scratch_bytes(int N, int num_zones, long long* bytes) {
    Layout lay;
    const int err = layout(N, num_zones, &lay);
    if (err == 0) *bytes = (long long)lay.scratch;
    return err;
}

// Returns cudaGetLastError() after the launch (0 == cudaSuccess), or -1
// when num_zones does not fit, -2 when scratch is needed and missing.
extern "C" int zreplay_launch(
    const void* fit_static, const void* frontier, const void* static_add,
    const void* spread_base, const void* na, const void* tt,
    const void* ip, const void* nz_cpu0, const void* nz_mem0,
    const void* alloc_cpu, const void* alloc_mem, const void* zone_id,
    const void* scal, void* chosen, void* j, void* st, void* scratch,
    int N, int K, int k_real, int num_zones, long long rows_dyn,
    long long w_lr, long long w_ba, long long w_spread, long long w_na,
    long long w_tt, long long w_ip, int has_selectors, void* stream) {
    Layout lay;
    const int err = layout(N, num_zones, &lay);
    if (err != 0) return err;
    if (lay.scratch && scratch == nullptr) return -2;
    static int attr_set[MAX_SLOTS + 1] = {0};
    if (!attr_set[lay.slots]) {
        const cudaError_t e = cudaFuncSetAttribute(
            lay.kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            lay.optin);
        if (e != cudaSuccess) return (int)e;
        attr_set[lay.slots] = 1;
    }
    Params p;
    p.fit_static = (const unsigned char*)fit_static;
    p.frontier = (const i64*)frontier;
    p.static_add = (const i64*)static_add;
    p.spread_base = (const i64*)spread_base;
    p.na = (const i64*)na;
    p.tt = (const i64*)tt;
    p.ip = (const i64*)ip;
    p.nz_cpu0 = (const i64*)nz_cpu0;
    p.nz_mem0 = (const i64*)nz_mem0;
    p.alloc_cpu = (const i64*)alloc_cpu;
    p.alloc_mem = (const i64*)alloc_mem;
    p.zone_id = (const int*)zone_id;
    p.scal = (const i64*)scal;
    p.chosen = (int*)chosen;
    p.j = (i64*)j;
    p.st = (i64*)st;
    p.scratch = lay.scratch ? (unsigned char*)scratch : nullptr;
    p.N = N;
    p.K = K;
    p.k_real = k_real;
    p.num_zones = num_zones;
    p.has_selectors = has_selectors;
    p.cap = lay.cap;
    p.cold_smem = lay.cold_smem;
    p.rows_dyn = rows_dyn;
    p.w_lr = w_lr;
    p.w_ba = w_ba;
    p.w_spread = w_spread;
    p.w_na = w_na;
    p.w_tt = w_tt;
    p.w_ip = w_ip;
    lay.kern<<<1, THREADS, lay.smem, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}
