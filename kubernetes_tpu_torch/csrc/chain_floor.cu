// The chain floor of a one-block pick loop on this card, and the floor of
// a grid sync: yardsticks for K3 (csrc/zreplay_kernel.cu) and K7
// (csrc/assign_kernel.cu), not part of the scheduler's path.
//
// A pick loop's steps are sequential: each ends in a block-wide choice
// that the next step reads. This kernel runs one block doing only that
// per step: a warp shuffle max, one shared-memory slot per warp, one
// barrier, and a second shuffle max that broadcasts the block maximum
// into every thread, whose value feeds the next step. Its time over
// `steps` steps, divided by `steps`, is the least time one step of such a
// loop takes in a block of that many threads; times the picks of a run it
// is K3's chain bound. The block has 256 threads (K3's own), 1,024, or
// 128 (the four warps of the K7 beam's chain).
//
// grid_sync_floor_kernel does nothing but `steps` grid syncs of one
// cooperative launch; launched with the K7 auction's grid, block size and
// dynamic shared memory (so its blocks sit on the SMs as the auction's
// do), its time over `steps` is the least time of one of the auction's
// grid syncs.
//
// launch_floor_kernel does nothing at all: launched as K8
// (csrc/resident_scatter.cu) is, through a plain C call from ctypes on
// the current stream, back to back, its time a launch is the least time
// any launch takes, the bound of a kernel whose bytes take nanoseconds.
// chip_smoke.py times all three with CUDA events.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

typedef long long i64;

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ i64 warp_max(i64 v) {
    for (int o = 16; o > 0; o >>= 1) {
        const i64 w = __shfl_xor_sync(FULL, v, o);
        v = w > v ? w : v;
    }
    return v;
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS, 1) chain_floor_kernel(i64* out,
                                                                 int steps) {
    __shared__ i64 slot[2][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    i64 v = threadIdx.x;
    for (int i = 0; i < steps; ++i) {
        const i64 w = warp_max(v);
        if (lane == 0) slot[i & 1][warp] = w;
        __syncthreads();
        const i64 b = lane < THREADS / 32 ? slot[i & 1][lane] : w;
        v = warp_max(b) + (threadIdx.x ^ i);
    }
    if (threadIdx.x == 0) out[0] = v;
}

__global__ void grid_sync_floor_kernel(i64* out, int steps) {
    cg::grid_group grid = cg::this_grid();
    for (int i = 0; i < steps; ++i) grid.sync();
    if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = steps;
}

__global__ void launch_floor_kernel() {}

// Plain C interface for ctypes. Returns cudaGetLastError() after the
// launch (0 == cudaSuccess), or -1 when threads is not 128, 256 or 1,024.
extern "C" int chain_floor_launch(void* out, int steps, int threads,
                                  void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (threads == 128)
        chain_floor_kernel<128><<<1, 128, 0, s>>>((i64*)out, steps);
    else if (threads == 256)
        chain_floor_kernel<256><<<1, 256, 0, s>>>((i64*)out, steps);
    else if (threads == 1024)
        chain_floor_kernel<1024><<<1, 1024, 0, s>>>((i64*)out, steps);
    else
        return -1;
    return (int)cudaGetLastError();
}

// A cooperative launch of `blocks` x `threads` with `smem` bytes of
// dynamic shared memory a block. Returns the launch's error (0 ==
// cudaSuccess).
extern "C" int grid_sync_floor_launch(void* out, int steps, int blocks,
                                      int threads, int smem, void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        grid_sync_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    i64* o = (i64*)out;
    void* args[] = {&o, &steps};
    err = cudaLaunchCooperativeKernel((const void*)grid_sync_floor_kernel,
                                      dim3(blocks), dim3(threads), args,
                                      (size_t)smem, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// One launch of the empty kernel: `blocks` x `threads`. Returns the
// launch's error (0 == cudaSuccess).
extern "C" int launch_floor_launch(int blocks, int threads, void* stream) {
    launch_floor_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
