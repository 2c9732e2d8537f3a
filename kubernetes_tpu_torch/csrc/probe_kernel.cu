// The wave probe's resource sweep, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernel kubernetes_tpu/ops/pallas_probe.py:_kernel
// (:63; launched by resource_probe, pl.pallas_call at :128). For a run of
// identical pods, at each commit depth j < J and node n < N:
//
//   res_fit[j,n] = PodFitsResources at usage + j*commit (cpu, mem, gpu,
//                  pod count; a zero-request pod skips cpu/mem/gpu but
//                  not the pod count; all true when wants_res == 0)
//   frontier[n]  = sum_j res_fit[j,n]
//   tab[j,n]     = w_lr * LeastRequested + w_ba * BalancedAllocation at
//                  nz + (j+1)*pod_nz (BalancedAllocation in float64)
//
// The bf16 mode (resource_probe_bf16_kernel, pallas_probe.py:95-104, the
// KUBERNETES_TPU_QUANT=bf16 profile) keeps the frontier and computes tab
// from the ordered term list ((kind, weight), at most MAX_TERMS): each
// term weight*score in int64, rounded to bfloat16 (int64 -> float
// __ll2float_rn, float -> bfloat16 __float2bfloat16_rn), added into a
// bfloat16 accumulator that starts at 0 and is rounded to nearest even
// after every add, in declaration order; then bfloat16 -> float -> int32
// toward zero -> int64. Summed weights cannot express that: the rounding
// is per term. The two kernels share one body (probe_body); only the
// store differs.
//
// Bound: bytes. The sweep writes J*N*8 bytes of tab once and reads about
// 10*N*8 bytes of node tables; at J=128, N=8192 that is ~8.5 MB, ~2.7 us
// at the H100's 3.35 TB/s. It has no matrix product and no tile that is
// read twice, so wgmma, TMA and clusters have nothing to do here. The
// design goals are, in order: occupancy, instructions per (j, n), store
// width.
//
// - Occupancy: the (j, n) plane runs in parallel. A block is a tile of
//   TILE_N = 32 consecutive nodes (threadIdx.x, one warp, so node-table
//   loads and each tab row store are coalesced: 256 bytes a warp) by
//   LANES_J j lanes (threadIdx.y). The grid is (node tiles, j chunks);
//   resource_probe_grid sizes the chunk from J, N and the SM count so
//   that a launch has about BLOCKS_PER_SM blocks per SM, and a lane at
//   least MIN_STEPS depths. Both edges (n >= N, j >= J) are masked.
// - No multiply in the j loop: each j-dependent term (usage + j*commit,
//   nz + (j+1)*pod_nz, the pod count, the tab address) is a running sum
//   advanced by a per-lane stride. The sums run in u64, so they equal the
//   reference's int64 products bit for bit, wrap-around included.
// - No 64-bit integer division in the loop: calculateScore's quotient
//   (cap - req)*10 / cap is estimated from the float64 fraction req/cap
//   that BalancedAllocation computes anyway, then corrected by one
//   integer step (see calculate_score). Only inputs outside
//   0 <= req <= cap <= 2^59 take a true (floor) division.
// - The frontier across blocks: the j lanes' fit counts sum in shared
//   memory, then one 64-bit atomicAdd per node per block adds that into
//   the frontier, which the wrapper zeroes. Integer addition is exact in
//   any order, so the frontier is deterministic.
//
// Bit-identity with the reference (oracle, JAX lax build, plain torch):
// - BalancedAllocation keeps its two float64 divisions (__ddiv_rn): a
//   reciprocal multiply is not correctly rounded. 10 - diff*10 must round
//   twice, as the oracle does: __dmul_rn/__dsub_rn, and the build passes
//   --fmad=false besides.
// - float64 -> int64 truncates toward zero (__double2ll_rz), as
//   astype(int64) does; int64 -> float64 rounds to nearest.
// - calculateScore's and LeastRequested's `//` are floors (the halving
//   is an arithmetic shift).
// - a zero allocation makes BalancedAllocation's fraction 1.0.
// - the host-port cap of the frontier stays outside, as in the JAX code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef long long i64;
typedef unsigned long long u64;

// layout of the pod scalar vector (ops/probe_kernel.POD_SCALARS)
enum {
    REQ_MCPU, REQ_MEM, REQ_GPU, ZERO_REQ, COMMIT_MCPU, COMMIT_MEM,
    COMMIT_GPU, NZ_MCPU, NZ_MEM
};

constexpr int TILE_N = 32;        // nodes per block: one warp's lanes
constexpr int LANES_J = 8;        // j lanes per block (threadIdx.y)
constexpr int BLOCKS_PER_SM = 8;  // blocks a launch aims for, per SM
constexpr int MIN_STEPS = 4;      // depths a j lane walks, at least
// calculate_score's estimate needs 10*cap to fit in int64
constexpr i64 EST_CAP_MAX = 1LL << 59;
// the bf16 mode's ordered term list, passed by value
constexpr int MAX_TERMS = 8;
struct ProbeTerms {
    int n;                 // terms in use
    int ba[MAX_TERMS];     // 0: LeastRequested, 1: BalancedAllocation
    i64 w[MAX_TERMS];      // weights, in declaration order
};

// the reference's `//` on int64 (d != 0)
__device__ __noinline__ i64 floor_div(i64 n, i64 d) {
    const i64 q = n / d;
    return (q * d != n && ((n < 0) != (d < 0))) ? q - 1 : q;
}

// priorities.go:33 calculateScore: floor((cap - req)*10 / cap), 0 when
// cap == 0 or req > cap. frac is req/cap as BalancedAllocation rounds it
// (__ddiv_rn of the two, each rounded to float64).
//
// When 0 <= req <= cap <= 2^59 the quotient Q lies in [0, 10] and 10*cap
// fits in int64. frac is within 4e-16 of req/cap, so the estimate
// (1 - frac)*10 is within 1e-14 of Q; truncated it is floor(Q) - 1,
// floor(Q) or floor(Q) + 1, and lies in [0, 10]. One step on the exact
// remainder num - q*cap (in [-cap, 2*cap)) corrects it.
__device__ __forceinline__ i64 calculate_score(i64 req, i64 cap,
                                               double frac) {
    if (cap == 0 || req > cap) return 0;
    if (req < 0 || cap > EST_CAP_MAX)
        return floor_div((i64)(((u64)cap - (u64)req) * 10u), cap);
    const i64 num = (cap - req) * 10;
    const int q = __double2int_rz(__dmul_rn(__dsub_rn(1.0, frac), 10.0));
    const i64 r = num - (i64)q * cap;
    return q + (r >= cap) - (r < 0);
}

// priorities.go:215 BalancedResourceAllocation on the two fractions
__device__ __forceinline__ i64 balanced(double cpu_frac, double mem_frac) {
    if (cpu_frac >= 1.0 || mem_frac >= 1.0) return 0;
    const double diff = fabs(__dsub_rn(cpu_frac, mem_frac));
    return __double2ll_rz(__dsub_rn(10.0, __dmul_rn(diff, 10.0)));
}

// the bf16 mode's weighted sum: per-term rounding to bfloat16, a bfloat16
// accumulator rounded after each add, then back through int32 toward
// zero. A float add of two bfloat16 values then __float2bfloat16_rn is
// the correctly rounded bfloat16 add: float's 24-bit significand holds
// the exact sum, or a value too close to it to cross a bfloat16 rounding
// boundary
__device__ __forceinline__ i64 bf16_sum(const ProbeTerms& t, i64 lr,
                                        i64 ba) {
    __nv_bfloat16 acc = __float2bfloat16_rn(0.0f);
    // unrolled, so every index into the parameter struct is static and
    // the list never goes through local memory
#pragma unroll
    for (int k = 0; k < MAX_TERMS; ++k) {
        if (k >= t.n) break;
        const i64 term = (i64)((u64)t.w[k] * (u64)(t.ba[k] ? ba : lr));
        const __nv_bfloat16 tb = __float2bfloat16_rn(__ll2float_rn(term));
        acc = __float2bfloat16_rn(
            __fadd_rn(__bfloat162float(acc), __bfloat162float(tb)));
    }
    return (i64)__float2int_rz(__bfloat162float(acc));
}

template <bool BF16>
__device__ __forceinline__ void probe_body(
    const i64* __restrict__ pod,
    const i64* __restrict__ a_cpu, const i64* __restrict__ a_mem,
    const i64* __restrict__ a_gpu, const i64* __restrict__ a_pods,
    const i64* __restrict__ u_cpu, const i64* __restrict__ u_mem,
    const i64* __restrict__ u_gpu, const i64* __restrict__ u_nzc,
    const i64* __restrict__ u_nzm, const i64* __restrict__ u_cnt,
    u64* __restrict__ frontier, i64* __restrict__ tab,
    int J, int N, int chunk, i64 w_lr, i64 w_ba, const ProbeTerms& terms,
    int wants_res) {
    __shared__ int fits[LANES_J][TILE_N];
    const int n = blockIdx.x * TILE_N + threadIdx.x;
    const int j0 = blockIdx.y * chunk + threadIdx.y;
    const int j_end = min(J, (blockIdx.y + 1) * chunk);
    int fit = 0;
    if (n < N && j0 < j_end) {
        const bool zero_req = pod[ZERO_REQ] != 0;
        const i64 ac = a_cpu[n], am = a_mem[n], ag = a_gpu[n];
        const i64 ap = a_pods[n];
        const double ac_d = __ll2double_rn(ac), am_d = __ll2double_rn(am);
        // at depth j: req + usage + j*commit, pod_count + j + 1 and
        // nz + (j+1)*pod_nz, each with its stride over LANES_J depths
        const u64 jj = (u64)j0;
        u64 need_c = (u64)pod[REQ_MCPU] + (u64)u_cpu[n]
                     + jj * (u64)pod[COMMIT_MCPU];
        u64 need_m = (u64)pod[REQ_MEM] + (u64)u_mem[n]
                     + jj * (u64)pod[COMMIT_MEM];
        u64 need_g = (u64)pod[REQ_GPU] + (u64)u_gpu[n]
                     + jj * (u64)pod[COMMIT_GPU];
        u64 count = (u64)u_cnt[n] + jj + 1u;
        u64 tot_c = (u64)u_nzc[n] + (jj + 1u) * (u64)pod[NZ_MCPU];
        u64 tot_m = (u64)u_nzm[n] + (jj + 1u) * (u64)pod[NZ_MEM];
        const u64 step_c = LANES_J * (u64)pod[COMMIT_MCPU];
        const u64 step_m = LANES_J * (u64)pod[COMMIT_MEM];
        const u64 step_g = LANES_J * (u64)pod[COMMIT_GPU];
        const u64 step_nc = LANES_J * (u64)pod[NZ_MCPU];
        const u64 step_nm = LANES_J * (u64)pod[NZ_MEM];
        i64* out = tab + (size_t)j0 * N + n;
        const size_t out_step = (size_t)LANES_J * N;
        // four depths unrolled: independent division chains to interleave
#pragma unroll 4
        for (int j = j0; j < j_end; j += LANES_J) {
            fit += !wants_res
                || ((i64)count <= ap
                    && (zero_req || ((i64)need_c <= ac && (i64)need_m <= am
                                     && (i64)need_g <= ag)));
            const i64 tc = (i64)tot_c, tm = (i64)tot_m;
            const double cpu_frac = ac == 0 ? 1.0
                : __ddiv_rn(__ll2double_rn(tc), ac_d);
            const double mem_frac = am == 0 ? 1.0
                : __ddiv_rn(__ll2double_rn(tm), am_d);
            const u64 lr2 = (u64)calculate_score(tc, ac, cpu_frac)
                            + (u64)calculate_score(tm, am, mem_frac);
            const i64 lr = (i64)lr2 >> 1;
            const i64 ba = balanced(cpu_frac, mem_frac);
            if constexpr (BF16)
                *out = bf16_sum(terms, lr, ba);
            else
                *out = (i64)((u64)w_lr * (u64)lr + (u64)w_ba * (u64)ba);
            need_c += step_c;
            need_m += step_m;
            need_g += step_g;
            count += LANES_J;
            tot_c += step_nc;
            tot_m += step_nm;
            out += out_step;
        }
    }
    fits[threadIdx.y][threadIdx.x] = fit;
    __syncthreads();
    if (threadIdx.y == 0 && n < N) {
        int sum = 0;
        for (int y = 0; y < LANES_J; ++y) sum += fits[y][threadIdx.x];
        atomicAdd(frontier + n, (u64)sum);
    }
}

__global__ void __launch_bounds__(TILE_N * LANES_J) resource_probe_kernel(
    const i64* __restrict__ pod,
    const i64* __restrict__ a_cpu, const i64* __restrict__ a_mem,
    const i64* __restrict__ a_gpu, const i64* __restrict__ a_pods,
    const i64* __restrict__ u_cpu, const i64* __restrict__ u_mem,
    const i64* __restrict__ u_gpu, const i64* __restrict__ u_nzc,
    const i64* __restrict__ u_nzm, const i64* __restrict__ u_cnt,
    u64* __restrict__ frontier, i64* __restrict__ tab,
    int J, int N, int chunk, i64 w_lr, i64 w_ba, int wants_res) {
    const ProbeTerms none{};
    probe_body<false>(pod, a_cpu, a_mem, a_gpu, a_pods, u_cpu, u_mem, u_gpu,
                      u_nzc, u_nzm, u_cnt, frontier, tab, J, N, chunk, w_lr,
                      w_ba, none, wants_res);
}

__global__ void __launch_bounds__(TILE_N * LANES_J)
resource_probe_bf16_kernel(
    const i64* __restrict__ pod,
    const i64* __restrict__ a_cpu, const i64* __restrict__ a_mem,
    const i64* __restrict__ a_gpu, const i64* __restrict__ a_pods,
    const i64* __restrict__ u_cpu, const i64* __restrict__ u_mem,
    const i64* __restrict__ u_gpu, const i64* __restrict__ u_nzc,
    const i64* __restrict__ u_nzm, const i64* __restrict__ u_cnt,
    u64* __restrict__ frontier, i64* __restrict__ tab,
    int J, int N, int chunk, ProbeTerms terms, int wants_res) {
    probe_body<true>(pod, a_cpu, a_mem, a_gpu, a_pods, u_cpu, u_mem, u_gpu,
                     u_nzc, u_nzm, u_cnt, frontier, tab, J, N, chunk, 0, 0,
                     terms, wants_res);
}

// The launch shape for (J, N) on the current device.
static int probe_grid(int J, int N, dim3* grid, dim3* block, int* chunk) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (N + TILE_N - 1) / TILE_N;
    const int max_chunks = (J + LANES_J * MIN_STEPS - 1)
                           / (LANES_J * MIN_STEPS);
    int chunks = (BLOCKS_PER_SM * sms + tiles - 1) / tiles;
    chunks = chunks < max_chunks ? chunks : max_chunks;
    chunks = chunks > 1 ? chunks : 1;
    // a chunk is a whole number of LANES_J-wide steps
    int c = (J + chunks - 1) / chunks;
    c = (c + LANES_J - 1) / LANES_J * LANES_J;
    *chunk = c > 0 ? c : LANES_J;
    *grid = dim3(tiles, (J + *chunk - 1) / *chunk);
    *block = dim3(TILE_N, LANES_J);
    return 0;
}

// Plain C interface for ctypes: pointers and the stream as void*.

// dims <- {grid.x, grid.y, block.x, block.y, j chunk} of a launch at
// (J, N) on the current device. Returns a CUDA error code (0 == success).
extern "C" int resource_probe_grid(int J, int N, int* dims) {
    dim3 grid, block;
    int chunk = 0;
    const int err = probe_grid(J, N, &grid, &block, &chunk);
    if (err == 0) {
        dims[0] = grid.x;
        dims[1] = grid.y;
        dims[2] = block.x;
        dims[3] = block.y;
        dims[4] = chunk;
    }
    return err;
}

// frontier must hold N zeros. Returns cudaGetLastError() after the
// launch (0 == cudaSuccess).
extern "C" int resource_probe_launch(
    const void* pod, const void* a_cpu, const void* a_mem,
    const void* a_gpu, const void* a_pods, const void* u_cpu,
    const void* u_mem, const void* u_gpu, const void* u_nzc,
    const void* u_nzm, const void* u_cnt, void* frontier, void* tab,
    int J, int N, long long w_lr, long long w_ba, int wants_res,
    void* stream) {
    if (J > 0 && N > 0) {
        dim3 grid, block;
        int chunk = 0;
        const int err = probe_grid(J, N, &grid, &block, &chunk);
        if (err != 0) return err;
        resource_probe_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
            (const i64*)pod, (const i64*)a_cpu, (const i64*)a_mem,
            (const i64*)a_gpu, (const i64*)a_pods, (const i64*)u_cpu,
            (const i64*)u_mem, (const i64*)u_gpu, (const i64*)u_nzc,
            (const i64*)u_nzm, (const i64*)u_cnt, (u64*)frontier,
            (i64*)tab, J, N, chunk, w_lr, w_ba, wants_res);
    }
    return (int)cudaGetLastError();
}

// The bf16 mode: the same launch with the ordered term list (n_terms <=
// MAX_TERMS; kinds[k] 0 for LeastRequested, 1 for BalancedAllocation)
// in place of the summed weights. frontier must hold N zeros. Returns
// cudaErrorInvalidValue for n_terms outside [0, MAX_TERMS], else
// cudaGetLastError() after the launch.
extern "C" int resource_probe_bf16_launch(
    const void* pod, const void* a_cpu, const void* a_mem,
    const void* a_gpu, const void* a_pods, const void* u_cpu,
    const void* u_mem, const void* u_gpu, const void* u_nzc,
    const void* u_nzm, const void* u_cnt, void* frontier, void* tab,
    int J, int N, int n_terms, const int* kinds, const long long* weights,
    int wants_res, void* stream) {
    if (n_terms < 0 || n_terms > MAX_TERMS) return (int)cudaErrorInvalidValue;
    ProbeTerms terms{};
    terms.n = n_terms;
    for (int k = 0; k < n_terms; ++k) {
        terms.ba[k] = kinds[k] != 0;
        terms.w[k] = weights[k];
    }
    if (J > 0 && N > 0) {
        dim3 grid, block;
        int chunk = 0;
        const int err = probe_grid(J, N, &grid, &block, &chunk);
        if (err != 0) return err;
        resource_probe_bf16_kernel<<<grid, block, 0,
                                     (cudaStream_t)stream>>>(
            (const i64*)pod, (const i64*)a_cpu, (const i64*)a_mem,
            (const i64*)a_gpu, (const i64*)a_pods, (const i64*)u_cpu,
            (const i64*)u_mem, (const i64*)u_gpu, (const i64*)u_nzc,
            (const i64*)u_nzm, (const i64*)u_cnt, (u64*)frontier,
            (i64*)tab, J, N, chunk, terms, wants_res);
    }
    return (int)cudaGetLastError();
}
