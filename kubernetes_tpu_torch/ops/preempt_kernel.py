"""The preemption victim scorer K6: the CUDA kernel's wrapper.

Replaces kubernetes_tpu/ops/preempt.py `_victim_score_fn` (a program
that XLA fuses; no Pallas source). Per node row of C candidate slots it
sorts the candidates by the eviction key, prefix-sums what they free,
and finds the shortest prefix that fits one gang member and its summed
priority (ops/preempt.py says what each output means).

- victim_score: the wrapper. On CUDA tensors it launches the kernel of
  csrc/preempt_kernel.cu (built with nvcc for sm_90a on first use, see
  native/build.py) or raises; it never falls back. On CPU tensors, and
  only there, it runs ops/preempt.victim_score_plain.
- LAUNCHES counts kernel launches (incremented only where the kernel is
  launched); LAUNCHES_BY_SHAPE counts them by (N, C).
- layout(C): the path the launcher takes for C, its threads a block and
  node rows a block.

Bound on the card: bytes, counted from what the outputs depend on
(chip_smoke.victim_bound_ms): 8 B a slot (prio read, order written), 36
B more a valid candidate (ord and four res rows), 44 B a node (free
read, needed and cost written); at the gang phase's table, (8,192, 32)
with 24 candidates on each of 5,000 rows, 6.78 MB, 0.00202 ms at 3.35
TB/s. The kernel reads only those bytes: ord and res only where prio <
gang_prio. For C <= 32 one W-lane warp segment holds a node row (W =
C, 256 / C rows a block of 256 threads): the bitonic sort on (key,
column), the gather of the sorted slots' resources and the segmented
scan all run in registers by shuffles, and a ballot finds the shortest
fitting prefix. For 64 <= C <= 1,024 one block of C threads holds a row:
the sort's stages inside a warp by shuffles, the wider ones through
shared memory, one barrier each. See the kernel source.
"""

from __future__ import annotations

import ctypes

import torch

from kubernetes_tpu_torch.ops.preempt import RES_ROWS, victim_score_plain

I32 = torch.int32
I64 = torch.int64

#: the largest candidate axis the kernel takes (one thread a slot)
MAX_C = 1024
#: the widest row of the segment path (one warp segment a row), and its
#: threads a block; wider rows take a block each
SEG_MAX_C = 32
SEG_THREADS = 256

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0
#: kernel launches by (N, C) since the last reset (clear() to reset)
LAUNCHES_BY_SHAPE: dict = {}

_LIB = None


def load(path: str) -> ctypes.CDLL:
    """Load a built K6 library and declare its C interface."""
    lib = ctypes.CDLL(path)
    fn = lib.victim_score_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 4)
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = load(build())
    return _LIB


def build() -> str:
    """Build the kernel library (unless built) -> its path. It is
    otherwise built at the first launch."""
    from kubernetes_tpu_torch.native.build import build_cuda

    return build_cuda("preempt_kernel")


def layout(C: int) -> dict:
    """-> {"path": "segment" | "block", "threads": a block's, "rows": node
    rows a block} of the launch for candidate axis C, as the launcher in
    csrc/preempt_kernel.cu picks it."""
    if C <= SEG_MAX_C:
        return {"path": "segment", "threads": SEG_THREADS,
                "rows": SEG_THREADS // C}
    return {"path": "block", "threads": C, "rows": 1}


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"victim_score: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _launch(prio, ord_, res, free, req, gang_prio: int, lib=None):
    """Launch the kernel (of `lib`, a library from load(); this
    checkout's by default)."""
    global LAUNCHES
    device = prio.device
    N, C = prio.shape
    if C < 1 or C > MAX_C or C & (C - 1):
        raise ValueError(
            f"victim_score: the kernel takes a power-of-two candidate axis "
            f"of at most {MAX_C} slots, got C={C}")
    _check("prio", prio, I32, (N, C), device)
    _check("ord", ord_, I32, (N, C), device)
    _check("res", res, I64, (N, C, RES_ROWS), device)
    _check("free", free, I64, (N, RES_ROWS), device)
    _check("req", req, I64, (RES_ROWS,), device)
    needed = torch.empty((N,), dtype=I32, device=device)
    cost = torch.empty((N,), dtype=I64, device=device)
    order = torch.empty((N, C), dtype=I32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = (lib or _lib()).victim_score_launch(
            prio.data_ptr(), ord_.data_ptr(), res.data_ptr(),
            free.data_ptr(), req.data_ptr(), int(gang_prio), int(N), int(C),
            needed.data_ptr(), cost.data_ptr(), order.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"victim_score kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(N, C)] = LAUNCHES_BY_SHAPE.get((N, C), 0) + 1
    return needed, cost, order


def victim_score(prio, ord_, res, free, req, gang_prio: int):
    """-> (victims_needed i32[N], cost i64[N], order i32[N, C]) of
    prio i32[N, C], ord i32[N, C], res i64[N, C, 4], free i64[N, 4],
    req i64[4] and the gang's priority. CUDA tensors launch the kernel;
    CPU tensors run the plain version; any other device raises."""
    device = prio.device
    if device.type == "cpu":
        return victim_score_plain(prio, ord_, res, free, req, gang_prio)
    if device.type != "cuda":
        raise ValueError(f"victim_score: no kernel for device {device}")
    return _launch(prio, ord_, res, free, req, gang_prio)
