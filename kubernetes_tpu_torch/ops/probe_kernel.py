"""The wave probe's resource sweep: the CUDA kernel and its plain version.

Replaces kubernetes_tpu/ops/pallas_probe.py (the Pallas `_kernel`,
launched by `resource_probe`). For a run of J identical pods over N
nodes it returns the fit frontier (i64[N], the number of commit depths
j at which PodFitsResources still holds) and the weighted
LeastRequested + BalancedAllocation j-table (i64[J, N]). With bf16=True
(the KUBERNETES_TPU_QUANT=bf16 profile, pallas_probe.py:95-104) the
j-table is the ordered terms' bfloat16 sum instead: each weighted term
rounded to bfloat16, added into a bfloat16 accumulator in declaration
order, the result truncated through int32; the frontier is the same.

- resource_probe: the wrapper. On CUDA tensors it launches the kernel
  of csrc/probe_kernel.cu (built with nvcc for sm_90a on first use, see
  native/build.py) or raises; it never falls back. On CPU tensors, and
  only there, it runs resource_probe_plain.
- resource_probe_plain: the same function in plain torch ops, built from
  the scan's own predicate and priority functions. The CPU tests hold it
  against the JAX kernel; chip_smoke.py holds the kernel against it.
- LAUNCHES counts kernel launches (incremented only where the kernel is
  launched), so a run can show that it went through the kernel;
  LAUNCHES_BY_SHAPE counts them by (J, N, mode), mode "i64" or "bf16"
  (the two modes are two kernels of csrc/probe_kernel.cu). launch_grid(J,
  N) is the grid either takes at that shape.

Bound on the card: bytes (J*N*8 written, ~10*N*8 read). The kernel
spreads the (j, n) plane over the grid and sums the frontier across
blocks with integer atomics, so the wrapper hands it a zeroed frontier;
see the kernel source for the design and the bit-identity hazards.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from kubernetes_tpu_torch.native.build import load_library
from kubernetes_tpu_torch.ops import predicates as P
from kubernetes_tpu_torch.ops import priorities as R

I64 = torch.int64

#: pod scalar vector layout (one i64[9] device buffer feeds the kernel)
POD_SCALARS = (
    "req_mcpu", "req_mem", "req_gpu", "zero_req",
    "commit_mcpu", "commit_mem", "commit_gpu", "nz_mcpu", "nz_mem",
)

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0
#: kernel launches by (J, N, mode) since the last reset (clear() to reset)
LAUNCHES_BY_SHAPE: dict = {}
#: the bf16 mode's longest term list (csrc/probe_kernel.cu MAX_TERMS)
MAX_TERMS = 8

_LIB = None


def pod_vector(pod) -> torch.Tensor:
    """The pod's nine scalars as one i64[9] tensor on their device."""
    return torch.stack([pod[f].to(I64) for f in POD_SCALARS])


def term_weights(terms: Sequence[Tuple[str, int]]) -> Tuple[int, int]:
    """(("lr"|"ba", weight), ...) -> (summed LR weight, summed BA
    weight): in int64 the weighted sum is exact in any order."""
    w_lr = sum(int(w) for kind, w in terms if kind == "lr")
    w_ba = sum(int(w) for kind, w in terms if kind == "ba")
    return w_lr, w_ba


def resource_probe_plain(J: int, alloc, usage, pod, terms, *,
                         wants_res: bool = True, bf16: bool = False):
    """-> (frontier i64[N], tab i64[J, N]) in plain torch ops. bf16: each
    weighted term .to(torch.bfloat16), summed in bfloat16 from 0 in
    declaration order (one rounding per add, as torch rounds every
    bfloat16 op), then int32 -> int64."""
    a_cpu, a_mem, a_gpu, a_pods = alloc
    u_cpu, u_mem, u_gpu, u_nzc, u_nzm, u_cnt = usage
    pv = pod_vector(pod)
    w_lr, w_ba = term_weights(terms)
    j = torch.arange(J, dtype=I64, device=a_cpu.device)[:, None]
    if wants_res:
        res_fit = P.pod_fits_resources(
            pv[0], pv[1], pv[2], pv[3] != 0, a_cpu, a_mem, a_gpu, a_pods,
            u_cpu[None, :] + j * pv[4],
            u_mem[None, :] + j * pv[5],
            u_gpu[None, :] + j * pv[6],
            u_cnt[None, :] + j,
        )
        frontier = res_fit.sum(dim=0, dtype=I64)
    else:
        frontier = torch.full(a_cpu.shape, J, dtype=I64, device=a_cpu.device)
    nzj_cpu = u_nzc[None, :] + j * pv[7]
    nzj_mem = u_nzm[None, :] + j * pv[8]
    lr = R.least_requested(pv[7], pv[8], nzj_cpu, nzj_mem, a_cpu, a_mem)
    ba = R.balanced_resource_allocation(pv[7], pv[8], nzj_cpu, nzj_mem,
                                        a_cpu, a_mem)
    if not bf16:
        return frontier, w_lr * lr + w_ba * ba
    tab = torch.zeros((J,) + tuple(a_cpu.shape), dtype=torch.bfloat16,
                      device=a_cpu.device)
    for kind, w in terms:
        tab = tab + (int(w) * (lr if kind == "lr" else ba)).to(
            torch.bfloat16)
    return frontier, tab.to(torch.int32).to(I64)


def load(path: str) -> ctypes.CDLL:
    """Load a built probe kernel library and declare its C interface."""
    lib = load_library(path)
    fn = lib.resource_probe_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 13
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    # an earlier source timed against this one (chip_smoke.py --baseline)
    # may have no bf16 mode
    if hasattr(lib, "resource_probe_bf16_launch"):
        fn = lib.resource_probe_bf16_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 13
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int),
                          ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                          ctypes.c_void_p])
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

    return build_cuda("probe_kernel")


def launch_grid(J: int, N: int, device=None) -> dict:
    """-> {"grid": [x, y], "block": [x, y], "j_chunk": c}: the launch
    shape the kernel takes at (J, N) on the device (the current one by
    default): x over node tiles, y over chunks of c depths."""
    fn = _lib().resource_probe_grid
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    dims = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = fn(int(J), int(N), dims)
    if err != 0:
        raise RuntimeError(f"resource_probe_grid failed: CUDA error {err}")
    return {"grid": [dims[0], dims[1]], "block": [dims[2], dims[3]],
            "j_chunk": dims[4]}


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != I64 or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"resource_probe: {name} must be a contiguous int64 tensor of "
            f"shape {shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _outputs(J: int, alloc, usage, pv):
    """Check one launch's inputs -> (zeroed frontier, tab) on their
    device: the kernel adds each block's fit count into the frontier."""
    device = pv.device
    N = alloc[0].shape[0]
    _check("pod vector", pv, (len(POD_SCALARS),), device)
    for i, t in enumerate(tuple(alloc) + tuple(usage)):
        _check(f"node table {i}", t, (N,), device)
    return (torch.zeros((N,), dtype=I64, device=device),
            torch.empty((J, N), dtype=I64, device=device))


def _launch(J: int, alloc, usage, pv, w_lr: int, w_ba: int,
            wants_res: bool, lib=None):
    """Launch the kernel (of `lib`, a library from load(); this
    checkout's by default)."""
    device = pv.device
    N = alloc[0].shape[0]
    frontier, tab = _outputs(J, alloc, usage, pv)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = (lib or _lib()).resource_probe_launch(
            pv.data_ptr(), *(t.data_ptr() for t in alloc),
            *(t.data_ptr() for t in usage), frontier.data_ptr(),
            tab.data_ptr(), int(J), int(N), int(w_lr), int(w_ba),
            int(bool(wants_res)), stream)
    if err != 0:
        raise RuntimeError(f"resource_probe kernel launch failed: CUDA "
                           f"error {err}")
    _counted(J, N, "i64")
    return frontier, tab


def _counted(J: int, N: int, mode: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(J, N, mode)] = LAUNCHES_BY_SHAPE.get((J, N, mode),
                                                            0) + 1


def _launch_bf16(J: int, alloc, usage, pv, terms, wants_res: bool,
                 lib=None):
    """Launch the bf16 mode's kernel on the ordered term list (of
    `lib`, this checkout's by default)."""
    device = pv.device
    N = alloc[0].shape[0]
    if len(terms) > MAX_TERMS:
        raise ValueError(f"resource_probe: the bf16 mode takes at most "
                         f"{MAX_TERMS} terms, got {len(terms)}")
    frontier, tab = _outputs(J, alloc, usage, pv)
    kinds = (ctypes.c_int * MAX_TERMS)(
        *(int(kind == "ba") for kind, _w in terms))
    weights = (ctypes.c_longlong * MAX_TERMS)(*(int(w) for _k, w in terms))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = (lib or _lib()).resource_probe_bf16_launch(
            pv.data_ptr(), *(t.data_ptr() for t in alloc),
            *(t.data_ptr() for t in usage), frontier.data_ptr(),
            tab.data_ptr(), int(J), int(N), len(terms), kinds, weights,
            int(bool(wants_res)), stream)
    if err != 0:
        raise RuntimeError(f"resource_probe bf16 kernel launch failed: "
                           f"CUDA error {err}")
    _counted(J, N, "bf16")
    return frontier, tab


def resource_probe(J: int, alloc, usage, pod, terms, *,
                   wants_res: bool = True, bf16: bool = False):
    """-> (frontier i64[N], tab i64[J, N]) for a run-of-identical probe.

    alloc: (alloc_mcpu, alloc_mem, alloc_gpu, alloc_pods) node tables;
    usage: the carry's (req_mcpu, req_mem, req_gpu, nz_mcpu, nz_mem,
    pod_count) resource rows; pod: the pod dict (the POD_SCALARS are
    read); terms: (("lr"|"ba", weight), ...), the config's LR/BA
    priorities in declaration order (the order is the bf16 mode's
    rounding order). CUDA tensors launch the kernel of the mode; CPU
    tensors run the plain version; any other device raises."""
    device = alloc[0].device
    if device.type == "cpu":
        return resource_probe_plain(J, alloc, usage, pod, terms,
                                    wants_res=wants_res, bf16=bf16)
    if device.type != "cuda":
        raise ValueError(f"resource_probe: no kernel for device {device}")
    if J == 0 or alloc[0].shape[0] == 0:  # the launcher launches nothing
        return _outputs(J, alloc, usage, pod_vector(pod))
    if bf16:
        return _launch_bf16(J, alloc, usage, pod_vector(pod), tuple(terms),
                            wants_res)
    w_lr, w_ba = term_weights(terms)
    return _launch(J, alloc, usage, pod_vector(pod), w_lr, w_ba, wants_res)
