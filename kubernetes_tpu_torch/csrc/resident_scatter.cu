// The resident row scatter K8, written by hand for Hopper (sm_90a).
//
// Replaces kubernetes_tpu/parallel/resident.py:_scatter_fn (:167), a
// program that XLA fuses inside shard_map (it has no Pallas source): the
// mesh's resident node tables take the changed rows of a node update in
// place. The JAX package runs it as one program a shipment over every
// shard; here one launch a device serves the whole shipment: every shard
// on that device that owns a changed row, and every field.
//
// Inputs: one packed row buffer (models/pack.pack_arrays layout, uint8,
// every segment 8-byte aligned) as it landed on the device; the offset
// of its __idx__ segment (i64[M], global node ids, -1 padding, no id
// twice: the host dedups); the launch's shards, as a bit set over the
// mesh's shards; the device's destination table (i64, rows x n_shards:
// the device pointer of every node-axis resident tensor of every shard
// on the device, 0 elsewhere; it lives on the device beside the tensors
// it points to and is rebuilt only when they are placed anew); and, a
// shipped field, its rows' segment offset, their element width and kind
// (signed, unsigned, float, bool), the resident tensor's element width
// and kind, its row in the table and its node axis as (outer,
// n_per_shard, inner) element strides. A field's rows are (M, outer,
// inner) row-major: the node axis moved first.
//
// For every field f and packed row m whose shard s = idx[m] / n_per_shard
// is in the launch, with local = idx[m] - s * n_per_shard and (a, b) <
// (outer, inner):
//
//   dst_{f,s}[(a * n_per_shard + local) * inner + b] = cvt(row_f[m, a, b])
//
// where cvt sign-extends a signed row, zero-extends an unsigned one (a
// uint32 bitset widens to int64 as snapshot/carry.place widens it),
// keeps a float's bits, and makes a bool of row != 0; an integer
// destination keeps the low bits of its width (a narrowed int8/int16
// table ships at its own width, so nothing is cut). Rows of shards
// outside the launch and padding write nothing; every other element is
// left as it was. Shard s's window is parallel/shard.shard_slice(s,
// n_per_shard), so that is _scatter_fn's update of every shard at once.
//
// On the main path cvt is a same-width copy: ResidentClusterState.
// _scatter ships every row already at its resident tensor's dtype, as the
// JAX package's resident._scatter does. The widening is kept because
// _scatter_fn itself takes rows at any host width (its r.astype), and a
// pack_arrays layout names each segment's dtype, so the kernel computes
// that function whole; chip_smoke.py's SCATTER_CASES hold it to the plain
// version on every dtype pair the snapshot has.
//
// Bound. Bytes: the owned rows read once at their shipped widths and
// written once at the placed widths, plus __idx__ (8 B a row), a few kB
// on the churn wave's shipment (4 shards x 2,048 nodes, M = 64, 7 int64
// fields): nanoseconds at 3.35 TB/s. The launch sets the time, so the
// bound a launch can reach is the launch floor (an empty kernel,
// csrc/chain_floor.cu) times the launches the shipment needs: one a
// device holding an owning shard.
//
// Design. One launch a device, so a shipment costs one launch where the
// first port paid one a shard. The parameters hold a few scalars, the
// shard bit set and, a shipped field, 24 bytes (offset, strides, codes,
// table row): the kernel is instanced at 8, 32 and 96 fields, so the
// common shipment passes a few hundred bytes, not a 3 kB block of
// destination pointers, which stay on the device. A team of LANES (1, 8
// or 32) threads takes one (row, field) pair: the field on blockIdx.y,
// the row from the thread's index (a shift). The team is as wide as the
// widest row's elements (to 32): one thread copying a row's elements in
// turn waits out each one's load and store, where the team's lanes copy
// them at once. A thread reads idx[m] once, finds the shard with one
// shift (a division where n_per_shard is not a power of two), tests its
// bit, reads the destination from the table and copies the row's outer
// segments of inner elements:
// 16-byte loads and stores where the copy keeps the width and kind (not
// bool) and the segment, its destination and its length are 16-byte
// aligned, else element by element at its width and kind, the element's
// (a, b) stepped without a division. Nothing is sorted or reduced: the
// host dedups ids, so no two rows write one element, and the kernel
// allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;
typedef unsigned long long u64;

constexpr int MAX_FIELDS = 96;
constexpr int MAX_SHARDS = 256;
constexpr int MASK_WORDS = MAX_SHARDS / 64;
constexpr int THREADS = 256;

// element kinds of a code (parallel/resident_kernel.py KIND_*): 0 signed,
// 1 unsigned, 2 float, 3 bool. Only two change what a thread does: a
// signed row sign-extends, and a bool destination stores row != 0; an
// unsigned row zero-extends and a float row keeps its bits.
constexpr int KIND_SIGNED = 0;
constexpr int KIND_BOOL = 3;

struct FieldArg {
    i64 src_off;  // byte offset of the field's rows in the buffer
    int outer;    // elements before the node axis
    int inner;    // elements after it
    int codes;    // shipped rows' code | resident tensor's code << 16,
                  // a code being width | kind << 8
    int row;      // the field's row in the destination table
};

template <int F>
struct Shipment {
    const i64* dests;      // the device's table: rows x n_shards pointers
    i64 idx_off;           // byte offset of __idx__ in the buffer
    i64 n_per_shard;
    int M;
    int n_shards;          // the table's columns: the mesh's shards
    int shift;             // log2(n_per_shard) if a power of two, else -1
    int pad;
    u64 shards[MASK_WORDS];  // the launch's shards, bit s for shard s
    FieldArg f[F];
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
                                           u64 v) {
    const int width = code & 0xff;
    if ((code >> 8) == KIND_BOOL) {
        // a float row's bits are kept; its zero test is not needed (a
        // float field has a float destination of its width)
        *(uint8_t*)p = v != 0 ? 1 : 0;
        return;
    }
    switch (width) {
        case 1: *(uint8_t*)p = (uint8_t)v; break;
        case 2: *(uint16_t*)p = (uint16_t)v; break;
        case 4: *(uint32_t*)p = (uint32_t)v; break;
        default: *(u64*)p = v; break;
    }
}

template <int F, int LANES>
__global__ void __launch_bounds__(THREADS)
resident_scatter_kernel(const unsigned char* __restrict__ buf,
                        const Shipment<F> sh) {
    const i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    const i64 m = t / LANES;  // LANES is a power of two: a shift
    const int lane = (int)(t & (LANES - 1));
    if (m >= sh.M) return;
    const i64 g = __ldg((const i64*)(buf + sh.idx_off) + m);
    if (g < 0) return;  // padding
    const i64 s = sh.shift >= 0 ? g >> sh.shift : g / sh.n_per_shard;
    if (s >= sh.n_shards || !((sh.shards[s >> 6] >> (s & 63)) & 1)) return;
    const i64 local = g - s * sh.n_per_shard;
    const FieldArg d = sh.f[blockIdx.y];
    unsigned char* out =
        (unsigned char*)__ldg(sh.dests + (i64)d.row * sh.n_shards + s);
    const int src_code = d.codes & 0xffff;
    const int dst_code = d.codes >> 16;
    const int src_w = src_code & 0xff;
    const int dst_w = dst_code & 0xff;
    const i64 inner = d.inner;
    const i64 per_row = (i64)d.outer * inner;
    if (per_row == 0) return;
    const unsigned char* row = buf + d.src_off + m * per_row * src_w;
    if (src_code == dst_code && (dst_code >> 8) != KIND_BOOL) {
        // a copy at one width: 16-byte chunks of each aligned segment
        const i64 len = inner * src_w;
        bool vec = (len & 15) == 0;
        for (int a = 0; vec && a < d.outer; ++a)
            vec = (((uintptr_t)(row + a * len)
                    | (uintptr_t)(out + (a * sh.n_per_shard + local) * len))
                   & 15) == 0;
        if (vec) {
            const i64 chunks = len >> 4;
            for (int a = 0; a < d.outer; ++a) {
                const uint4* src = (const uint4*)(row + a * len);
                uint4* dst =
                    (uint4*)(out + (a * sh.n_per_shard + local) * len);
                for (i64 c = lane; c < chunks; c += LANES)
                    dst[c] = __ldg(src + c);
            }
            return;
        }
    }
    // element by element: element e = lane + k * LANES is (a, b) with
    // e = a * inner + b, stepped by LANES without a division
    i64 a = 0, b = lane;
    while (b >= inner && a < d.outer) {
        b -= inner;
        ++a;
    }
    for (i64 e = lane; e < per_row; e += LANES) {
        const u64 v = load_bits(row + e * src_w, src_code);
        store_bits(out + ((a * sh.n_per_shard + local) * inner + b) * dst_w,
                   dst_code, v);
        b += LANES;
        while (b >= inner) {
            b -= inner;
            ++a;
        }
    }
}

template <int F, int LANES>
static int launch_as(const unsigned char* buf, const Shipment<F>& sh,
                     int n_fields, cudaStream_t stream) {
    const i64 threads_needed = (i64)sh.M * LANES;
    const int block =
        threads_needed < THREADS ? (int)((threads_needed + 31) & ~31LL)
                                 : THREADS;
    const dim3 grid((unsigned)((threads_needed + block - 1) / block),
                    (unsigned)n_fields);
    resident_scatter_kernel<F, LANES><<<grid, block, 0, stream>>>(buf, sh);
    return (int)cudaGetLastError();
}

template <int F>
static int launch_fields(const void* buf, const void* dests, i64 idx_off,
                         int M, i64 n_per_shard, int n_shards,
                         const u64* shards, int n_fields, const i64* desc,
                         int lanes, cudaStream_t stream) {
    Shipment<F> sh;
    sh.dests = (const i64*)dests;
    sh.idx_off = idx_off;
    sh.n_per_shard = n_per_shard;
    sh.M = M;
    sh.n_shards = n_shards;
    sh.shift = -1;
    sh.pad = 0;
    for (int b = 0; b < 63; ++b)
        if (n_per_shard == (1LL << b)) sh.shift = b;
    for (int w = 0; w < MASK_WORDS; ++w) sh.shards[w] = shards[w];
    for (int i = 0; i < F; ++i) {
        FieldArg& d = sh.f[i];
        if (i < n_fields) {
            const i64* q = desc + 5 * i;
            d.src_off = q[0];
            d.outer = (int)q[1];
            d.inner = (int)q[2];
            d.codes = (int)q[3];
            d.row = (int)q[4];
        } else {
            d = FieldArg{0, 0, 0, 0, 0};
        }
    }
    const unsigned char* b = (const unsigned char*)buf;
    switch (lanes) {
        case 1: return launch_as<F, 1>(b, sh, n_fields, stream);
        case 8: return launch_as<F, 8>(b, sh, n_fields, stream);
        default: return launch_as<F, 32>(b, sh, n_fields, stream);
    }
}

// The parameter bytes of the instance a launch of n_fields fields takes.
extern "C" int resident_scatter_param_bytes(int n_fields) {
    const int base = (int)sizeof(const unsigned char*);
    if (n_fields <= 8) return base + (int)sizeof(Shipment<8>);
    if (n_fields <= 32) return base + (int)sizeof(Shipment<32>);
    return base + (int)sizeof(Shipment<MAX_FIELDS>);
}

// dests: the device's destination table (i64, rows x n_shards); shards:
// MASK_WORDS words of the launch's shard bit set; desc: n_fields x 5 i64
// host values a field, in FieldArg order (src_off, outer, inner, codes,
// row); lanes: 1, 8 or 32 threads a (row, field) pair. Returns a CUDA
// error code (cudaErrorInvalidValue for a bad argument).
extern "C" int resident_scatter_launch(const void* buf, const void* dests,
                                       i64 idx_off, int M, i64 n_per_shard,
                                       int n_shards, const u64* shards,
                                       int n_fields, const i64* desc,
                                       int lanes, void* stream) {
    if (n_fields < 0 || n_fields > MAX_FIELDS || M < 0 || n_per_shard < 1
        || n_shards < 1 || n_shards > MAX_SHARDS
        || (lanes != 1 && lanes != 8 && lanes != 32))
        return (int)cudaErrorInvalidValue;
    if (n_fields == 0 || M == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (n_fields <= 8)
        return launch_fields<8>(buf, dests, idx_off, M, n_per_shard, n_shards,
                                shards, n_fields, desc, lanes, s);
    if (n_fields <= 32)
        return launch_fields<32>(buf, dests, idx_off, M, n_per_shard,
                                 n_shards, shards, n_fields, desc, lanes, s);
    return launch_fields<MAX_FIELDS>(buf, dests, idx_off, M, n_per_shard,
                                     n_shards, shards, n_fields, desc, lanes,
                                     s);
}
