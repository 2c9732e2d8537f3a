// The resident row scatter K8, written by hand for Hopper (sm_90a).
//
// Replaces kubernetes_tpu/parallel/resident.py:_scatter_fn (:167), a
// program that XLA fuses inside shard_map (it has no Pallas source): the
// mesh's resident node tables take the changed rows of a node update in
// place. One launch serves one shard and every field of the shipment.
//
// Inputs: one packed row buffer (models/pack.pack_arrays layout, uint8,
// every segment 8-byte aligned) as it landed on the device; the offset
// of its __idx__ segment (i64[M], global node ids, -1 padding, no id
// twice: the host dedups); and a descriptor a field: its rows' segment
// offset, their element width and kind (signed, unsigned, float, bool),
// the shard's resident tensor (pointer, element width and kind) and its
// node axis as (outer, n_per_shard, inner) element strides. A field's
// rows are (M, outer, inner) row-major: the node axis moved first.
//
// For every field f, packed row m with offset <= idx[m] < offset +
// n_per_shard, and (a, b) < (outer, inner):
//
//   dst_f[(a * n_per_shard + idx[m] - offset) * inner + b] = cvt(row_f[m, a, b])
//
// where cvt sign-extends a signed row, zero-extends an unsigned one (a
// uint32 bitset widens to int64 as snapshot/carry.place widens it),
// keeps a float's bits, and makes a bool of row != 0; an integer
// destination keeps the low bits of its width (a narrowed int8/int16
// table ships at its own width, so nothing is cut). Rows of other shards
// and padding write nothing; every other element is left as it was.
//
// On the main path cvt is a same-width copy: ResidentClusterState.
// _scatter ships every row already at its resident tensor's dtype, as the
// JAX package's resident._scatter does. The widening is kept because
// _scatter_fn itself takes rows at any host width (its r.astype), and a
// pack_arrays layout names each segment's dtype, so the kernel computes
// that function whole; chip_smoke.py's SCATTER_CASES hold it to the plain
// version on every dtype pair the snapshot has.
//
// Bound: bytes. The shard's owned rows are read once at their shipped
// widths and written once at the placed widths, plus __idx__ (8 B a
// row); chip_smoke.py's shipment_bound_bytes counts them from the churn
// wave's own shipment (rows owned by the shard, not M). At that shape (4
// shards x 2,048 nodes, M = 64, the 7 int64 fields a label and
// allocatable update changes) it is a few kB a shard: the launch, not
// the bytes, sets the time.
//
// Design. A grid-stride loop over (row, element) of one field, the
// field on blockIdx.y, so every field of the shipment takes one launch.
// A thread reads idx[m] (cached in L1 across the row's elements), skips
// off-shard rows, loads the element at its width and kind, converts and
// stores. The descriptors ride in the kernel's parameter space (at most
// MAX_FIELDS of them, 32 B each). Nothing is sorted or reduced: the host
// dedups ids, so no two rows write one element.

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;
typedef unsigned long long u64;

constexpr int MAX_FIELDS = 96;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS_X = 1024;

// element kinds of a descriptor (parallel/resident_kernel.py KIND_*):
// 0 signed, 1 unsigned, 2 float, 3 bool. Only two change what a thread
// does: a signed row sign-extends, and a bool destination stores row != 0;
// an unsigned row zero-extends and a float row keeps its bits.
constexpr int KIND_SIGNED = 0;
constexpr int KIND_BOOL = 3;

struct FieldDesc {
    i64 src_off;  // byte offset of the field's rows in the buffer
    i64 dst;      // the shard's resident tensor (device pointer)
    int outer;    // elements before the node axis
    int inner;    // elements after it
    int src;      // width | kind << 8 of the shipped rows
    int dst_code; // width | kind << 8 of the resident tensor
};

struct Fields {
    FieldDesc f[MAX_FIELDS];
};

__device__ __forceinline__ u64 load_bits(const unsigned char* p, int code) {
    const int width = code & 0xff;
    const int kind = code >> 8;
    switch (width) {
        case 1:
            return kind == KIND_SIGNED ? (u64)(i64)*(const int8_t*)p
                                       : (u64)*(const uint8_t*)p;
        case 2:
            return kind == KIND_SIGNED ? (u64)(i64)*(const int16_t*)p
                                       : (u64)*(const uint16_t*)p;
        case 4:
            return kind == KIND_SIGNED ? (u64)(i64)*(const int32_t*)p
                                       : (u64)*(const uint32_t*)p;
        default:
            return *(const u64*)p;
    }
}

__device__ __forceinline__ void store_bits(unsigned char* p, int code,
                                           u64 v, bool nonzero) {
    const int width = code & 0xff;
    if ((code >> 8) == KIND_BOOL) {
        *(uint8_t*)p = nonzero ? 1 : 0;
        return;
    }
    switch (width) {
        case 1: *(uint8_t*)p = (uint8_t)v; break;
        case 2: *(uint16_t*)p = (uint16_t)v; break;
        case 4: *(uint32_t*)p = (uint32_t)v; break;
        default: *(u64*)p = v; break;
    }
}

__global__ void __launch_bounds__(THREADS)
resident_scatter_kernel(const unsigned char* __restrict__ buf, i64 idx_off,
                        int M, i64 n_per_shard, i64 offset, Fields fields) {
    const FieldDesc d = fields.f[blockIdx.y];
    const i64 per_row = (i64)d.outer * d.inner;
    const i64 total = (i64)M * per_row;
    const i64* __restrict__ idx = (const i64*)(buf + idx_off);
    const int src_w = d.src & 0xff;
    const int dst_w = d.dst_code & 0xff;
    const unsigned char* __restrict__ rows = buf + d.src_off;
    unsigned char* out = (unsigned char*)d.dst;
    const i64 step = (i64)gridDim.x * blockDim.x;
    for (i64 e = (i64)blockIdx.x * blockDim.x + threadIdx.x; e < total;
         e += step) {
        const i64 m = e / per_row;
        const i64 g = __ldg(idx + m);
        const i64 local = g - offset;
        if (g < 0 || local < 0 || local >= n_per_shard) continue;
        const i64 r = e - m * per_row;
        const i64 a = r / d.inner;
        const i64 b = r - a * d.inner;
        const u64 v = load_bits(rows + e * src_w, d.src);
        // a float row's bits are kept; its zero test is not needed (a
        // float field has a float destination of its width)
        store_bits(out + ((a * n_per_shard + local) * d.inner + b) * dst_w,
                   d.dst_code, v, v != 0);
    }
}

// desc: n_fields x 6 int64 host values a field, in FieldDesc order
// (src_off, dst, outer, inner, src code, dst code). Returns a CUDA error
// code (cudaErrorInvalidValue for a bad argument).
extern "C" int resident_scatter_launch(const void* buf, i64 idx_off, int M,
                                       i64 n_per_shard, i64 offset,
                                       int n_fields, const i64* desc,
                                       void* stream) {
    if (n_fields < 0 || n_fields > MAX_FIELDS || M < 0 || n_per_shard < 0)
        return (int)cudaErrorInvalidValue;
    if (n_fields == 0 || M == 0 || n_per_shard == 0) return 0;
    Fields fields;
    i64 widest = 0;
    for (int i = 0; i < n_fields; ++i) {
        const i64* q = desc + 6 * i;
        FieldDesc& d = fields.f[i];
        d.src_off = q[0];
        d.dst = q[1];
        d.outer = (int)q[2];
        d.inner = (int)q[3];
        d.src = (int)q[4];
        d.dst_code = (int)q[5];
        const i64 per = (i64)M * q[2] * q[3];
        if (per > widest) widest = per;
    }
    if (widest == 0) return 0;
    i64 blocks = (widest + THREADS - 1) / THREADS;
    if (blocks > MAX_BLOCKS_X) blocks = MAX_BLOCKS_X;
    dim3 grid((unsigned)blocks, (unsigned)n_fields);
    resident_scatter_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)buf, idx_off, M, n_per_shard, offset, fields);
    return (int)cudaGetLastError();
}
