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
// Bound: latency. The steps are sequential and each ends in a block-wide
// pick, so the loop runs in ONE block of 1,024 threads; the bytes it must
// move (its inputs once, j and chosen once) take a few microseconds of
// HBM time in all. The design keeps the per-step work small:
// - per-node state lives in shared memory (device memory when N is too
//   large for it): the cached score without SelectorSpread ("slow", i64),
//   the spread count c (i64), the zone (i32) and the fit flag (u8);
// - only the picked node's slow score is recomputed after a commit; the
//   whole slow row is recomputed only when a normalizer (the NodeAffinity,
//   TaintToleration or InterPod max/min over the fit set) moves, which can
//   happen only when a node leaves the fit set;
// - the spread maximum M, the per-zone counts zc, their maximum and the
//   per-zone float32 zone scores are kept incrementally; a fit flip
//   recomputes them in one block pass;
// - a step is two block passes: the score maximum (warp shuffles, then one
//   warp), then one ballot per 32 nodes of the tie mask and one warp that
//   finds the (L % ties)-th tie in index order by a prefix sum over the
//   ballots. One thread commits.
//
// Bit-identity with the reference (the host spec replay
// models/replay._scores, the oracle, the JAX scan):
// - SelectorSpread rounds op by op in float32: __fdiv_rn, __fmul_rn,
//   __fadd_rn, and the build passes --fmad=false; int64 -> float32 is
//   __ll2float_rn, float32 -> int64 truncates (__float2ll_rz); a NaN
//   (max_zone == 0, 0/0) maps to INT64_MIN.
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

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr i64 I64_MIN = (i64)0x8000000000000000ULL;
// selector_spreading.go:226 rounds the exact 1/3 and 2/3 once to float32
constexpr float THIRD = (float)(1.0 / 3.0);
constexpr float TWO_THIRDS = (float)(2.0 / 3.0);
// bytes of per-node state: slow (8), c (8), zone (4), fit (1)
constexpr int NODE_BYTES = 21;

// layout of the i64 scalar vector (ops/zreplay_kernel.SCALARS)
enum { S_NZ_MCPU, S_NZ_MEM, S_SELFMATCH, S_L0, S_ACTIVE0 };

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
    unsigned char* scratch;  // node state in device memory, or null
    int N, K, k_real, num_zones, has_selectors;
    i64 rows_dyn, w_lr, w_ba, w_spread, w_na, w_tt, w_ip;
};

struct Norms {
    i64 na_mx, tt_mx, ip_mx, ip_mn;
};

struct Block {
    i64 wmax[WARPS];
    i64 red[5];  // full pass: M, na_mx, tt_mx, ip_mx (max), ip_mn (min)
    int any_fit, have_zones;
    i64 M, max_zone, L, smax, n_done;
    Norms norms;
    int m, stop, bailed, need_full, renorm;
};

// the reference's `//` on int64 (d != 0)
__device__ __forceinline__ i64 floor_div(i64 n, i64 d) {
    const i64 q = n / d;
    return (q * d != n && ((n < 0) != (d < 0))) ? q - 1 : q;
}

// priorities.go:33 calculateScore
__device__ __forceinline__ i64 calc_score(i64 req, i64 cap) {
    if (cap == 0 || req > cap) return 0;
    return floor_div((i64)(((u64)cap - (u64)req) * 10u), cap);
}

// The score of node n at commit depth jn without SelectorSpread.
// InterPod's part is masked by fit in the reference; only fit nodes'
// scores are ever read, so it is left unmasked here.
__device__ __noinline__ i64 slow_score(const Params& p, int n, i64 jn,
                                       Norms nm, i64 pnz_c, i64 pnz_m) {
    u64 s = (u64)p.static_add[n];
    if (p.w_lr || p.w_ba) {
        const i64 tc = (i64)((u64)p.nz_cpu0[n] + (u64)(jn + 1) * (u64)pnz_c);
        const i64 tm = (i64)((u64)p.nz_mem0[n] + (u64)(jn + 1) * (u64)pnz_m);
        const i64 ac = p.alloc_cpu[n], am = p.alloc_mem[n];
        if (p.w_lr) {
            const i64 lr = (i64)((u64)calc_score(tc, ac)
                                 + (u64)calc_score(tm, am)) >> 1;
            s += (u64)p.w_lr * (u64)lr;
        }
        if (p.w_ba) {
            const double cf = ac == 0 ? 1.0
                : __ddiv_rn(__ll2double_rn(tc), __ll2double_rn(ac));
            const double mf = am == 0 ? 1.0
                : __ddiv_rn(__ll2double_rn(tm), __ll2double_rn(am));
            i64 ba = 0;
            if (!(cf >= 1.0 || mf >= 1.0))
                ba = __double2ll_rz(__dsub_rn(
                    10.0, __dmul_rn(fabs(__dsub_rn(cf, mf)), 10.0)));
            s += (u64)p.w_ba * (u64)ba;
        }
    }
    if (p.w_na) {
        const double f = nm.na_mx > 0
            ? __dmul_rn(10.0, __ddiv_rn(__ll2double_rn(p.na[n]),
                                        __ll2double_rn(nm.na_mx)))
            : 0.0;
        s += (u64)p.w_na * (u64)__double2ll_rz(f);
    }
    if (p.w_tt) {
        const double f = nm.tt_mx > 0
            ? __dmul_rn(__dsub_rn(1.0, __ddiv_rn(__ll2double_rn(p.tt[n]),
                                                 __ll2double_rn(nm.tt_mx))),
                        10.0)
            : 10.0;
        s += (u64)p.w_tt * (u64)__double2ll_rz(f);
    }
    if (p.w_ip) {
        const i64 rng = (i64)((u64)nm.ip_mx - (u64)nm.ip_mn);
        const double f = rng > 0
            ? __dmul_rn(10.0, __ddiv_rn(
                  __ll2double_rn((i64)((u64)p.ip[n] - (u64)nm.ip_mn)),
                  __ll2double_rn(rng)))
            : 0.0;
        s += (u64)p.w_ip * (u64)__double2ll_rz(f);
    }
    return (i64)s;
}

// float32 zone score of zone z: 10 * ((max_zone - zc[z]) / max_zone)
__device__ __forceinline__ float zone_score(i64 max_zone, i64 zcz) {
    return __fmul_rn(10.0f, __fdiv_rn(__ll2float_rn(max_zone - zcz),
                                      __ll2float_rn(max_zone)));
}

// The combined score: the cached slow part plus w_spread * SelectorSpread.
__device__ __forceinline__ i64 node_score(const Params& p, i64 slow, i64 c,
                                          bool fit, int zone, i64 M,
                                          float Mf, bool blend,
                                          const float* zs) {
    if (!p.w_spread) return slow;
    float f = 10.0f;
    if (p.has_selectors) {
        const i64 cm = fit ? c : 0;
        if (M > 0) f = __fmul_rn(10.0f, __fdiv_rn(__ll2float_rn(M - cm), Mf));
        if (blend && zone > 0)
            f = __fadd_rn(__fmul_rn(f, THIRD), __fmul_rn(TWO_THIRDS, zs[zone]));
    }
    const i64 sp = isnan(f) ? I64_MIN : __float2ll_rz(f);
    return (i64)((u64)slow + (u64)p.w_spread * (u64)sp);
}

__device__ __forceinline__ i64 warp_max(i64 v) {
    for (int o = 16; o > 0; o >>= 1) {
        const i64 w = __shfl_xor_sync(FULL, v, o);
        v = w > v ? w : v;
    }
    return v;
}

__device__ __forceinline__ i64 warp_min(i64 v) {
    for (int o = 16; o > 0; o >>= 1) {
        const i64 w = __shfl_xor_sync(FULL, v, o);
        v = w < v ? w : v;
    }
    return v;
}

struct State {
    i64* slow;
    i64* c;
    int* zone;
    unsigned char* fit;
    i64* zc;
    float* zs;
    unsigned* masks;
};

// Recompute everything that depends on the whole fit set: M, any fit,
// have_zones, the normalizers, max_zone and the zone scores; and, when a
// normalizer moved (or `first`), every node's slow score. All threads.
__device__ __noinline__ void full_pass(const Params& p, Block& sh,
                                       const State& s, bool first,
                                       i64 pnz_c, i64 pnz_m) {
    const int tid = threadIdx.x, lane = tid & 31;
    const int N = p.N, P = (N + THREADS - 1) / THREADS;
    if (tid == 0) {
        for (int q = 0; q < 5; ++q) sh.red[q] = 0;
        sh.any_fit = 0;
        sh.have_zones = 0;
    }
    __syncthreads();
    i64 M = 0, na = 0, tt = 0, ipx = 0, ipn = 0;
    int anyf = 0, hz = 0;
    for (int k = 0; k < P; ++k) {
        const int n = k * THREADS + tid;
        if (n < N && s.fit[n]) {
            const i64 c = s.c[n];
            M = c > M ? c : M;
            if (p.w_na) na = p.na[n] > na ? p.na[n] : na;
            if (p.w_tt) tt = p.tt[n] > tt ? p.tt[n] : tt;
            if (p.w_ip) {
                ipx = p.ip[n] > ipx ? p.ip[n] : ipx;
                ipn = p.ip[n] < ipn ? p.ip[n] : ipn;
            }
            anyf = 1;
            hz |= s.zone[n] > 0;
        }
    }
    M = warp_max(M);
    na = warp_max(na);
    tt = warp_max(tt);
    ipx = warp_max(ipx);
    ipn = warp_min(ipn);
    anyf = __any_sync(FULL, anyf);
    hz = __any_sync(FULL, hz);
    if (lane == 0) {
        atomicMax(&sh.red[0], M);
        atomicMax(&sh.red[1], na);
        atomicMax(&sh.red[2], tt);
        atomicMax(&sh.red[3], ipx);
        atomicMin(&sh.red[4], ipn);
        if (anyf) sh.any_fit = 1;
        if (hz) sh.have_zones = 1;
    }
    __syncthreads();
    if (tid == 0) {
        sh.M = sh.red[0];
        const Norms nm = {sh.red[1], sh.red[2], sh.red[3], sh.red[4]};
        sh.renorm = first || nm.na_mx != sh.norms.na_mx
            || nm.tt_mx != sh.norms.tt_mx || nm.ip_mx != sh.norms.ip_mx
            || nm.ip_mn != sh.norms.ip_mn;
        sh.norms = nm;
        i64 mz = 0;
        for (int z = 1; z < p.num_zones; ++z) mz = s.zc[z] > mz ? s.zc[z] : mz;
        sh.max_zone = mz;
        for (int z = 1; z < p.num_zones; ++z) s.zs[z] = zone_score(mz, s.zc[z]);
        sh.need_full = 0;
    }
    __syncthreads();
    if (sh.renorm) {
        const Norms nm = sh.norms;
        for (int k = 0; k < P; ++k) {
            const int n = k * THREADS + tid;
            if (n < N) s.slow[n] = slow_score(p, n, p.j[n], nm, pnz_c, pnz_m);
        }
        __syncthreads();
    }
}

// One thread: commit step i to node sh.m.
__device__ __noinline__ void commit(const Params& p, Block& sh,
                                    const State& s, int i, bool selfmatch,
                                    i64 pnz_c, i64 pnz_m) {
    const int m = sh.m;
    const i64 jm = p.j[m] + 1;
    p.j[m] = jm;
    sh.L += 1;
    p.chosen[i] = m;
    const bool new_fit = p.fit_static[m] && jm < p.frontier[m];
    const i64 c_old = s.c[m];  // m was fit: its contribution was c_old
    const i64 c_new = (i64)((u64)p.spread_base[m] + (selfmatch ? (u64)jm : 0));
    const i64 contrib_new = new_fit ? c_new : 0;
    const int z = s.zone[m];
    s.zc[z] = (i64)((u64)s.zc[z] + (u64)contrib_new - (u64)c_old);
    s.c[m] = c_new;
    s.fit[m] = new_fit;
    s.slow[m] = slow_score(p, m, jm, sh.norms, pnz_c, pnz_m);
    if (new_fit) {
        if (c_new > sh.M) sh.M = c_new;
        if (p.num_zones > 1 && z > 0) {
            if (s.zc[z] > sh.max_zone) {
                sh.max_zone = s.zc[z];
                for (int q = 1; q < p.num_zones; ++q)
                    s.zs[q] = zone_score(sh.max_zone, s.zc[q]);
            } else {
                s.zs[z] = zone_score(sh.max_zone, s.zc[z]);
            }
        }
    } else {
        sh.need_full = 1;  // a node left the fit set
    }
    if (jm >= p.rows_dyn) {
        sh.stop = 1;
        sh.bailed = 1;
        sh.n_done = i + 1;
    }
}

__global__ void __launch_bounds__(THREADS, 1) zreplay_kernel(Params p) {
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ Block sh;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int N = p.N, nz = p.num_zones, P = (N + THREADS - 1) / THREADS;
    const i64 pnz_c = p.scal[S_NZ_MCPU], pnz_m = p.scal[S_NZ_MEM];
    const bool selfmatch = p.scal[S_SELFMATCH] > 0;
    const bool active0 = p.scal[S_ACTIVE0] != 0;

    for (int n = tid; n < N; n += THREADS) p.j[n] = 0;
    if (!active0) {  // an aborted run: nothing schedules
        for (int q = tid; q < p.K; q += THREADS) p.chosen[q] = -1;
        if (tid == 0) {
            p.st[0] = p.scal[S_L0];
            p.st[1] = p.k_real;
            p.st[2] = 0;
        }
        return;
    }
    State s;
    s.zc = (i64*)dyn;
    s.zs = (float*)(s.zc + nz);
    s.masks = (unsigned*)(s.zs + nz);
    size_t off = (size_t)nz * 12 + (size_t)P * WARPS * 4;
    unsigned char* nodes = p.scratch ? p.scratch : dyn + ((off + 15) & ~(size_t)15);
    s.slow = (i64*)nodes;
    s.c = s.slow + N;
    s.zone = (int*)(s.c + N);
    s.fit = (unsigned char*)(s.zone + N);

    for (int z = tid; z < nz; z += THREADS) {
        s.zc[z] = 0;
        s.zs[z] = 0.0f;
    }
    if (tid == 0) {
        sh.L = p.scal[S_L0];
        sh.n_done = p.k_real;
        sh.stop = 0;
        sh.bailed = 0;
        sh.norms = Norms{0, 0, 0, 0};
    }
    __syncthreads();
    for (int n = tid; n < N; n += THREADS) {
        const bool f = p.fit_static[n] && 0 < p.frontier[n];
        const int z = p.zone_id[n];
        s.fit[n] = f;
        s.c[n] = p.spread_base[n];
        s.zone[n] = z;
        if (f) atomicAdd((u64*)&s.zc[z], (u64)p.spread_base[n]);
    }
    __syncthreads();
    full_pass(p, sh, s, true, pnz_c, pnz_m);

    int i = 0;
    while (i < p.k_real && sh.any_fit) {
        const i64 M = sh.M;
        const float Mf = __ll2float_rn(M);
        const bool blend = nz > 1 && sh.have_zones;
        // pass A: the maximum score over the fit set
        i64 best = I64_MIN;
        for (int k = 0; k < P; ++k) {
            const int n = k * THREADS + tid;
            if (n < N && s.fit[n]) {
                const i64 sc = node_score(p, s.slow[n], s.c[n], true,
                                          s.zone[n], M, Mf, blend, s.zs);
                best = sc > best ? sc : best;
            }
        }
        best = warp_max(best);
        if (lane == 0) sh.wmax[warp] = best;
        __syncthreads();
        if (warp == 0) {
            const i64 v = warp_max(sh.wmax[lane]);
            if (lane == 0) sh.smax = v;
        }
        __syncthreads();
        // pass B: the tie mask, one ballot per 32 nodes (entry k*32 + warp)
        const i64 smax = sh.smax;
        for (int k = 0; k < P; ++k) {
            const int n = k * THREADS + tid;
            bool tie = false;
            if (n < N && s.fit[n])
                tie = node_score(p, s.slow[n], s.c[n], true, s.zone[n], M,
                                 Mf, blend, s.zs) == smax;
            const unsigned mk = __ballot_sync(FULL, tie);
            if (lane == 0) s.masks[k * WARPS + warp] = mk;
        }
        __syncthreads();
        if (warp == 0) {
            // lane l holds entries [l*P, l*P + P): index order across lanes
            int cnt = 0;
            for (int q = 0; q < P; ++q) cnt += __popc(s.masks[lane * P + q]);
            int incl = cnt;
            for (int o = 1; o < 32; o <<= 1) {
                const int v = __shfl_up_sync(FULL, incl, o);
                if (lane >= o) incl += v;
            }
            const int total = __shfl_sync(FULL, incl, 31);
            i64 r = sh.L % total;
            if (r < 0) r += total;
            const int excl = incl - cnt;
            if (excl <= r && r < incl) {
                int rem = (int)(r - excl);
                for (int q = 0; q < P; ++q) {
                    unsigned mk = s.masks[lane * P + q];
                    const int pc = __popc(mk);
                    if (rem < pc) {
                        for (int t = 0; t < rem; ++t) mk &= mk - 1;
                        const int e = lane * P + q;
                        sh.m = (e / WARPS) * THREADS + (e % WARPS) * 32
                               + (__ffs(mk) - 1);
                        break;
                    }
                    rem -= pc;
                }
            }
            __syncwarp();
            if (lane == 0) commit(p, sh, s, i, selfmatch, pnz_c, pnz_m);
        }
        __syncthreads();
        if (sh.need_full) full_pass(p, sh, s, false, pnz_c, pnz_m);
        ++i;
        if (sh.stop) break;
    }
    for (int q = i + tid; q < p.K; q += THREADS) p.chosen[q] = -1;
    if (tid == 0) {
        p.st[0] = sh.L;
        p.st[1] = sh.n_done;
        p.st[2] = sh.bailed;
    }
}

static size_t fixed_bytes(int N, int num_zones) {
    const size_t P = ((size_t)N + THREADS - 1) / THREADS;
    return (((size_t)num_zones * 12 + P * WARPS * 4) + 15) & ~(size_t)15;
}

static int smem_optin(int* bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    // the static Block struct shares the block's shared memory
    *bytes -= (int)sizeof(Block);
    return (int)err;
}

// Plain C interface for ctypes: pointers and the stream as void*.

// *bytes <- device-memory scratch the launch needs at (N, num_zones): 0
// when the node state fits in shared memory. Returns a CUDA error code, or
// -1 when num_zones does not fit in shared memory at all.
extern "C" int zreplay_scratch_bytes(int N, int num_zones, long long* bytes) {
    int optin = 0;
    const int err = smem_optin(&optin);
    if (err != 0) return err;
    const size_t fixed = fixed_bytes(N, num_zones);
    if (fixed > (size_t)optin) return -1;
    *bytes = fixed + (size_t)N * NODE_BYTES <= (size_t)optin
        ? 0 : (long long)(((size_t)N * NODE_BYTES + 15) & ~(size_t)15);
    return 0;
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
    int optin = 0;
    const int err = smem_optin(&optin);
    if (err != 0) return err;
    size_t bytes = fixed_bytes(N, num_zones);
    if (bytes > (size_t)optin) return -1;
    const bool in_smem = bytes + (size_t)N * NODE_BYTES <= (size_t)optin;
    if (in_smem) bytes += (size_t)N * NODE_BYTES;
    else if (scratch == nullptr) return -2;
    static int attr_set = 0;
    if (!attr_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            zreplay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            optin);
        if (e != cudaSuccess) return (int)e;
        attr_set = 1;
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
    p.scratch = in_smem ? nullptr : (unsigned char*)scratch;
    p.N = N;
    p.K = K;
    p.k_real = k_real;
    p.num_zones = num_zones;
    p.has_selectors = has_selectors;
    p.rows_dyn = rows_dyn;
    p.w_lr = w_lr;
    p.w_ba = w_ba;
    p.w_spread = w_spread;
    p.w_na = w_na;
    p.w_tt = w_tt;
    p.w_ip = w_ip;
    zreplay_kernel<<<1, THREADS, bytes, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}
