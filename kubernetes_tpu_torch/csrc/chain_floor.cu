// The chain floor of a one-block pick loop on this card: a yardstick for
// K3 (csrc/zreplay_kernel.cu), not part of the scheduler's path.
//
// A pick loop's steps are sequential: each ends in a block-wide choice
// that the next step reads. This kernel runs one block doing only that
// per step: a warp shuffle max, one shared-memory slot per warp, one
// barrier, and a second shuffle max that broadcasts the block maximum
// into every thread, whose value feeds the next step. Its time over
// `steps` steps, divided by `steps`, is the least time one step of such a
// loop takes in a block of that many threads; times the picks of a run it
// is K3's chain bound. The block has 256 threads (K3's own) or 1,024.
// chip_smoke.py times it with CUDA events.

#include <cuda_runtime.h>

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

// Plain C interface for ctypes. Returns cudaGetLastError() after the
// launch (0 == cudaSuccess), or -1 when threads is not 256 or 1,024.
extern "C" int chain_floor_launch(void* out, int steps, int threads,
                                  void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (threads == 256)
        chain_floor_kernel<256><<<1, 256, 0, s>>>((i64*)out, steps);
    else if (threads == 1024)
        chain_floor_kernel<1024><<<1, 1024, 0, s>>>((i64*)out, steps);
    else
        return -1;
    return (int)cudaGetLastError();
}
