"""The joint-assignment solve K7: the CUDA kernel's wrappers.

Replaces kubernetes_tpu/scheduler/optimizer/ops/assign.py
`_auction_assign_fn` and `_beam_assign_fn` (programs that XLA fuses; no
Pallas source). Both take one wave's slot x node tables (fit, score,
req, commit, check, cap) and return owner i32[P], a node per slot or -1
(scheduler/optimizer/ops/assign.py says what each input means).

- auction_assign (K7a) and beam_assign (K7b): the wrappers. On CUDA
  tensors they launch the kernels of csrc/assign_kernel.cu (built with
  nvcc for sm_90a on first use, see native/build.py) or raise; they
  never fall back. On CPU tensors, and only there, they run the plain
  versions ops/assign._auction_assign_fn and _beam_assign_fn.
- LAUNCHES counts kernel launches, one a solve (incremented only where
  a kernel is launched); LAUNCHES_BY_SHAPE counts them by (solver, P,
  N), solver "auction" or "beam".
- auction_grid(P, N): the blocks of the auction's cooperative launch;
  auction_smem_bytes(N): its dynamic shared memory a block (0 where the
  tiles' node state lies in device memory, past 270,336 nodes on an
  H100).

The auction is ONE cooperative launch (cudaLaunchCooperativeKernel, the
grid at most the co-resident limit) whose rounds are a bid and one grid
sync when the slots' keys are unique (bid, sync, claim, sync when they
repeat): each block keeps a tile of the node state in shared memory for
the whole launch and seats the last round's winners on it as a round
starts, and a round's slots are spread over every warp. It stops after
a round in which no slot bid. The beam is one launch: a block a slot
sorts the slot's best nodes, then the last block walks the slots with
one warp a beam. Bounds on the card (chip_smoke.py): bytes,
the tables read once (assign_bound_ms) and the rows of the slots that
bid in each round (assign_rounds_bound_ms); the auction's grid syncs
(assign_sync_bound_ms); the beam's chain of P steps
(assign_beam_chain_bound_ms). See the kernel source.

The auction's C interface is the same as that of the kernel it
replaced, so an earlier build's auction runs through _launch_auction
(`lib=`, a library with assign_auction_scratch_bytes and
assign_auction_launch declared).
"""

from __future__ import annotations

import ctypes

import torch

from kubernetes_tpu_torch.native.build import load_library
from kubernetes_tpu_torch.scheduler.optimizer.ops.assign import (
    RES_ROWS,
    _auction_assign_fn,
    _beam_assign_fn,
)

I32 = torch.int32
I64 = torch.int64

#: the beam the kernel is built for (csrc/assign_kernel.cu BEAM_K, BEAM_C)
BEAM_K = 4
BEAM_C = 4
#: threads a block of the auction (csrc/assign_kernel.cu AUCTION_THREADS)
AUCTION_THREADS = 512

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0
#: kernel launches by (solver, P, N) since the last reset (clear() to
#: reset)
LAUNCHES_BY_SHAPE: dict = {}

_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: the library's exports: (name, result type, argument types)
_EXPORTS = (
    ("assign_auction_launch", _I, [_P] * 8 + [_L, _I, _I, _I, _P, _P, _P]),
    ("assign_auction_scratch_bytes", _L, [_I] * 3),
    ("assign_auction_bids_offset", _L, [_I] * 3),
    ("assign_auction_smem_bytes", _I, [_I]),
    ("assign_auction_grid", _I, [_I] * 2),
    ("assign_beam_launch", _I, [_P] * 6 + [_I, _I, _P, _P, _P, _P]),
    ("assign_beam_scratch_bytes", _L, [_I] * 2),
    ("assign_beam_max_slots", _I, []),
)


def load(path: str) -> ctypes.CDLL:
    """Load a built K7 library and declare its C interface."""
    lib = load_library(path)
    for name, res, args in _EXPORTS:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
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

    return build_cuda("assign_kernel")


def auction_grid(P: int, N: int) -> int:
    """Blocks of the auction's cooperative launch at (P, N) on the
    current card (0 when it cannot launch cooperatively)."""
    return int(_lib().assign_auction_grid(int(P), int(N)))


def auction_smem_bytes(N: int) -> int:
    """Dynamic shared memory a block of the auction takes at N nodes: its
    tile's node state, or 0 where the tiles outnumber the co-resident
    blocks and that state lies in device memory."""
    return int(_lib().assign_auction_smem_bytes(int(N)))


def beam_max_slots() -> int:
    """The beam kernel's largest P."""
    return int(_lib().assign_beam_max_slots())


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"assign: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _check_tables(fit, score, req, commit, check, cap):
    device = fit.device
    P, N = fit.shape
    _check("fit", fit, torch.bool, (P, N), device)
    _check("score", score, I64, (P, N), device)
    _check("req", req, I64, (P, RES_ROWS), device)
    _check("commit", commit, I64, (P, RES_ROWS), device)
    _check("check", check, torch.bool, (P, RES_ROWS), device)
    _check("cap", cap, I64, (N, RES_ROWS), device)
    if P < 1 or N < 1:
        raise ValueError(f"assign: empty problem P={P} N={N}")
    return device, P, N


def _outputs(fit, score, req, commit, check, cap, prio=None, order=None):
    """Check one launch's inputs (the auction's prio and order where
    given) -> its output owner i32[P], allocated on their device."""
    device, P, N = _check_tables(fit, score, req, commit, check, cap)
    if prio is not None:
        _check("prio", prio, I32, (P,), device)
        _check("order", order, I32, (P,), device)
    return torch.empty((P,), dtype=I32, device=device)


def _count(solver: str, P: int, N: int) -> None:
    global LAUNCHES
    LAUNCHES += 1
    key = (solver, P, N)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1


def _launch_auction(fit, score, req, commit, check, cap, prio, order,
                    eps0: int, rounds: int, bids=False, lib=None):
    """Launch K7a (of lib; this checkout's by default) -> owner i32[P],
    or with bids=True (owner, bids i32[rounds], general i32[1]): the
    slots that bid in each round, zero from the round the kernel stopped
    in, and 1 when the launch took the general (claim) path for repeated
    keys (views of its scratch, valid once the launch is done; bids=True
    needs a library that exports where they lie)."""
    owner = _outputs(fit, score, req, commit, check, cap, prio, order)
    device = owner.device
    P, N = fit.shape
    lib = lib or _lib()
    nbytes = int(lib.assign_auction_scratch_bytes(P, N, int(rounds)))
    scratch = torch.empty(((nbytes + 7) // 8,), dtype=I64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.assign_auction_launch(
            fit.data_ptr(), score.data_ptr(), req.data_ptr(),
            commit.data_ptr(), check.data_ptr(), cap.data_ptr(),
            prio.data_ptr(), order.data_ptr(), int(eps0), int(P), int(N),
            int(rounds), owner.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"assign auction kernel launch failed: CUDA "
                           f"error {err}")
    _count("auction", P, N)
    if not bids:
        return owner
    start = int(lib.assign_auction_bids_offset(P, N, int(rounds))) // 4
    state = scratch.view(I32)[start:start + int(rounds) + 1]
    return owner, state[:int(rounds)], state[int(rounds):]


def rounds_run(bids: torch.Tensor) -> int:
    """The rounds an auction launch ran, from its bids: through the first
    round without a bid (the kernel stops there), or all of them."""
    zero = (bids == 0).nonzero()
    return int(zero[0]) + 1 if zero.numel() else int(bids.numel())


def _launch_beam(fit, score, req, commit, check, cap):
    """Launch K7b -> owner i32[P]. Raises above the kernel's largest
    P."""
    owner = _outputs(fit, score, req, commit, check, cap)
    device = owner.device
    P, N = fit.shape
    lib = _lib()
    limit = beam_max_slots()
    if P > limit:
        raise ValueError(f"beam_assign: P={P} slots, the kernel takes at "
                         f"most {limit}")
    nbytes = int(lib.assign_beam_scratch_bytes(P, N))
    scratch = torch.empty(((nbytes + 7) // 8,), dtype=I64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.assign_beam_launch(
            fit.data_ptr(), score.data_ptr(), req.data_ptr(),
            commit.data_ptr(), check.data_ptr(), cap.data_ptr(), int(P),
            int(N), scratch.data_ptr(), None, owner.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"assign beam kernel launch failed: CUDA error "
                           f"{err}")
    _count("beam", P, N)
    return owner


def auction_assign(fit, score, req, commit, check, cap, prio, order,
                   eps0: int, rounds: int):
    """-> owner i32[P] of the auction over fit bool[P, N], score i64[P, N],
    req/commit i64[P, 4], check bool[P, 4], cap i64[N, 4], prio i32[P],
    order i32[P], the first epsilon eps0 and `rounds` rounds. CUDA
    tensors launch K7a; CPU tensors run the plain version; any other
    device raises."""
    device = fit.device
    if device.type == "cpu":
        return _auction_assign_fn(rounds, fit, score, req, commit, check,
                                  cap, prio, order, eps0)
    if device.type != "cuda":
        raise ValueError(f"auction_assign: no kernel for device {device}")
    return _launch_auction(fit, score, req, commit, check, cap, prio, order,
                           eps0, rounds)


def beam_assign(fit, score, req, commit, check, cap):
    """-> owner i32[P] of the top-BEAM_K beam (BEAM_C candidates a beam)
    over the same tables as auction_assign. CUDA tensors launch K7b (P at
    most beam_max_slots(), 64); CPU tensors run the plain version; any
    other device raises."""
    device = fit.device
    if device.type == "cpu":
        return _beam_assign_fn(BEAM_K, BEAM_C, fit, score, req, commit,
                               check, cap)
    if device.type != "cuda":
        raise ValueError(f"beam_assign: no kernel for device {device}")
    return _launch_beam(fit, score, req, commit, check, cap)
