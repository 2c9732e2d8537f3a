// The wave probe's resource sweep, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernel kubernetes_tpu/ops/pallas_probe.py:_kernel
// (launched by resource_probe, pl.pallas_call at :128). For a run of
// identical pods, at each commit depth j < J and node n < N:
//
//   res_fit[j,n] = PodFitsResources at usage + j*commit (cpu, mem, gpu,
//                  pod count; a zero-request pod skips cpu/mem/gpu but
//                  not the pod count; all true when wants_res == 0)
//   frontier[n]  = sum_j res_fit[j,n]
//   tab[j,n]     = w_lr * LeastRequested + w_ba * BalancedAllocation at
//                  nz + j*pod_nz (BalancedAllocation in float64)
//
// Design: one thread per node, consecutive threads on consecutive nodes,
// so every node-table load and every tab row store is coalesced. The j
// axis, a sequential grid in the Pallas kernel, is a loop inside the
// thread, and the frontier accumulates in a register: no reduction
// crosses blocks. The nine pod scalars are read from a device buffer, so
// the host never syncs to read them. In int64 the weighted sum is exact,
// so the summed LR weight and the summed BA weight stand for the
// config's terms in any order.
//
// Bound: bytes. The kernel writes J*N*8 bytes of tab and reads about
// 10*N*8 bytes of node tables; at J=128, N=8192 that is ~8.4 MB, ~2.5 us
// at the H100's 3.35 TB/s, so at these sizes the launch cost dominates.
//
// Bit-identity with the JAX reference:
// - 10 - diff*10 must round twice, as XLA does: the product and the
//   difference use __dmul_rn/__dsub_rn, and the build passes
//   --fmad=false besides.
// - float64 -> int64 truncates toward zero (__double2ll_rz), as
//   astype(int64) does; int64 -> float64 rounds to nearest.
// - calculateScore's `//` is a floor and C's `/` truncates; they agree
//   because the negative and zero-capacity cases are masked to 0 first.
// - a zero allocation makes BalancedAllocation's fraction 1.0.
// - the host-port cap of the frontier stays outside, as in the JAX code.

#include <cuda_runtime.h>

typedef long long i64;

// layout of the pod scalar vector (ops/probe_kernel.POD_SCALARS)
enum {
    REQ_MCPU, REQ_MEM, REQ_GPU, ZERO_REQ, COMMIT_MCPU, COMMIT_MEM,
    COMMIT_GPU, NZ_MCPU, NZ_MEM
};

// priorities.go:33 calculateScore on the values the JAX code keeps
__device__ __forceinline__ i64 calculate_score(i64 requested, i64 capacity) {
    if (capacity == 0 || requested > capacity) return 0;
    return ((capacity - requested) * 10) / capacity;
}

// priorities.go:215 BalancedResourceAllocation
__device__ __forceinline__ i64 balanced(i64 total_cpu, i64 total_mem,
                                        i64 alloc_cpu, i64 alloc_mem) {
    const double cpu_frac = alloc_cpu == 0 ? 1.0
        : __ddiv_rn(__ll2double_rn(total_cpu), __ll2double_rn(alloc_cpu));
    const double mem_frac = alloc_mem == 0 ? 1.0
        : __ddiv_rn(__ll2double_rn(total_mem), __ll2double_rn(alloc_mem));
    if (cpu_frac >= 1.0 || mem_frac >= 1.0) return 0;
    const double diff = fabs(__dsub_rn(cpu_frac, mem_frac));
    return __double2ll_rz(__dsub_rn(10.0, __dmul_rn(diff, 10.0)));
}

__global__ void resource_probe_kernel(
    const i64* __restrict__ pod,
    const i64* __restrict__ a_cpu, const i64* __restrict__ a_mem,
    const i64* __restrict__ a_gpu, const i64* __restrict__ a_pods,
    const i64* __restrict__ u_cpu, const i64* __restrict__ u_mem,
    const i64* __restrict__ u_gpu, const i64* __restrict__ u_nzc,
    const i64* __restrict__ u_nzm, const i64* __restrict__ u_cnt,
    i64* __restrict__ frontier, i64* __restrict__ tab,
    int J, int N, i64 w_lr, i64 w_ba, int wants_res) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    const i64 req_mcpu = pod[REQ_MCPU], req_mem = pod[REQ_MEM];
    const i64 req_gpu = pod[REQ_GPU];
    const bool zero_req = pod[ZERO_REQ] != 0;
    const i64 c_mcpu = pod[COMMIT_MCPU], c_mem = pod[COMMIT_MEM];
    const i64 c_gpu = pod[COMMIT_GPU];
    const i64 nz_mcpu = pod[NZ_MCPU], nz_mem = pod[NZ_MEM];
    const i64 ac = a_cpu[n], am = a_mem[n], ag = a_gpu[n], ap = a_pods[n];
    const i64 uc = u_cpu[n], um = u_mem[n], ug = u_gpu[n];
    const i64 unc = u_nzc[n], unm = u_nzm[n], ucnt = u_cnt[n];
    i64 fr = 0;
    for (int j = 0; j < J; ++j) {
        const i64 jj = j;
        if (wants_res) {
            const bool count_ok = ucnt + jj + 1 <= ap;
            const bool res_ok = zero_req
                || (ac >= req_mcpu + (uc + jj * c_mcpu)
                    && am >= req_mem + (um + jj * c_mem)
                    && ag >= req_gpu + (ug + jj * c_gpu));
            fr += (count_ok && res_ok) ? 1 : 0;
        } else {
            fr += 1;
        }
        const i64 total_cpu = (unc + jj * nz_mcpu) + nz_mcpu;
        const i64 total_mem = (unm + jj * nz_mem) + nz_mem;
        const i64 lr = (calculate_score(total_cpu, ac)
                        + calculate_score(total_mem, am)) / 2;
        const i64 ba = balanced(total_cpu, total_mem, ac, am);
        tab[(size_t)j * N + n] = w_lr * lr + w_ba * ba;
    }
    frontier[n] = fr;
}

// Plain C interface for ctypes: pointers and the stream as void*.
// Returns cudaGetLastError() after the launch (0 == cudaSuccess).
extern "C" int resource_probe_launch(
    const void* pod, const void* a_cpu, const void* a_mem,
    const void* a_gpu, const void* a_pods, const void* u_cpu,
    const void* u_mem, const void* u_gpu, const void* u_nzc,
    const void* u_nzm, const void* u_cnt, void* frontier, void* tab,
    int J, int N, long long w_lr, long long w_ba, int wants_res,
    void* stream) {
    if (N > 0) {
        const int threads = 128;
        const int blocks = (N + threads - 1) / threads;
        resource_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const i64*)pod, (const i64*)a_cpu, (const i64*)a_mem,
            (const i64*)a_gpu, (const i64*)a_pods, (const i64*)u_cpu,
            (const i64*)u_mem, (const i64*)u_gpu, (const i64*)u_nzc,
            (const i64*)u_nzm, (const i64*)u_cnt, (i64*)frontier,
            (i64*)tab, J, N, w_lr, w_ba, wants_res);
    }
    return (int)cudaGetLastError();
}
