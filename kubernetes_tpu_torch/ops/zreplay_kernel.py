"""The zoned device replay's pick loop (K3): the CUDA kernel and its plain
version.

Replaces the K-step lax.scan of kubernetes_tpu/models/zreplay.py
_replay_run (`scores` and `step`), which XLA fuses and which has no
Pallas source. For one run of identical pods, in permuted (name-
descending) node space, it replays up to k_real picks: the combined
score at the per-node commit counts j (LeastRequested and
BalancedAllocation at nz + (j+1)*pod_nz, the zone-blended SelectorSpread
in float32, the NodeAffinity / TaintToleration / InterPod normalizers in
float64 over the live fit set), selectHost's round-robin tie rule, and
the commit; it stops after the pick whose node reaches rows_dyn commits.

- replay_picks: the wrapper. On CUDA tensors it launches the kernel of
  csrc/zreplay_kernel.cu (built with nvcc for sm_90a on first use, see
  native/build.py) or raises; it never falls back. On CPU tensors, and
  only there, it runs replay_picks_plain.
- replay_picks_plain: the same function in plain torch ops, a Python
  loop over the steps mirroring the JAX step function. The CPU tests
  hold it against the JAX scan and the host spec replay; chip_smoke.py
  holds the kernel against it.
- LAUNCHES counts kernel launches (incremented only where the kernel is
  launched); LAUNCHES_BY_SHAPE counts them by (N, K, num_zones).

Inputs (all of length N, permuted): fit_static u8, frontier i64 (already
vetoed: min(frontier, 1) where the self-anti veto holds), static_add,
spread_base, na_counts, tt_counts, ip_totals, nz_cpu0, nz_mem0,
alloc_cpu, alloc_mem (i64), zone_id (i32, 0 <= id < num_zones; the
wrapper widens an int8 or int16 one, a table that parallel/quant
narrowed, to the kernel's int32), and
`scalars` i64[5] (SCALARS: the pod's nonzero cpu and memory requests,
the spread self-match flag, the round-robin counter L0 and the active
flag), read by the kernel from device memory so that a group of runs
chains launches without a host sync. Outputs: chosen i32[K] (-1 where a
step scheduled nothing or did not run), j i64[N], and state i64[3] =
(L, n_done, bailed).

Bound on the card: latency. The steps are sequential; the kernel runs
one block, keeps each thread's nodes in registers (up to 8,192 nodes;
beyond that in device memory) and moves a few hundred kilobytes in all
(see the source).
"""

from __future__ import annotations

import ctypes

import torch

from kubernetes_tpu_torch.ops import priorities as R

I64 = torch.int64
F32 = torch.float32
F64 = torch.float64

#: layout of the i64 scalar vector
SCALARS = ("nz_mcpu", "nz_mem", "selfmatch", "L0", "active0")
#: the per-node inputs, in the order of the C interface
NODE_INPUTS = ("fit_static", "frontier", "static_add", "spread_base",
               "na_counts", "tt_counts", "ip_totals", "nz_cpu0", "nz_mem0",
               "alloc_cpu", "alloc_mem", "zone_id")
#: the weights, in the order of the C interface
WEIGHTS = ("w_lr", "w_ba", "w_spread", "w_na", "w_tt", "w_ip")

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0
#: kernel launches by (N, K, num_zones) since the last reset
LAUNCHES_BY_SHAPE: dict = {}

_LIB = None
_INT64_MIN = -(2**63)


def replay_picks_plain(nodes: dict, scalars: torch.Tensor, weights: dict,
                       *, K: int, k_real: int, rows_dyn: int,
                       num_zones: int, has_selectors: bool):
    """-> (chosen i32[K], j i64[N], state i64[3]) in plain torch ops (see
    the module docstring). Steps that can no longer schedule (no fit node)
    end the loop: the JAX scan runs them and they change nothing."""
    fs = nodes["fit_static"] != 0
    frontier = nodes["frontier"]
    dev = frontier.device
    N = frontier.shape[0]
    nz_c, nz_m, selfm, L0, active0 = (int(v) for v in scalars.tolist())
    chosen = torch.full((K,), -1, dtype=torch.int32, device=dev)
    j = torch.zeros((N,), dtype=I64, device=dev)
    if not active0:
        return chosen, j, torch.tensor([L0, k_real, 0], dtype=I64, device=dev)
    zone = nodes["zone_id"].to(I64)
    base = nodes["spread_base"]
    fit = fs & (frontier > 0)
    zc = torch.zeros((num_zones,), dtype=I64, device=dev).index_add_(
        0, zone, torch.where(fit, base, 0))
    L, n_done, bailed = L0, k_real, 0
    for i in range(k_real):
        if not bool(fit.any()):
            break
        score = _scores(nodes, weights, j, fit, zc, nz_c, nz_m, selfm,
                        num_zones, has_selectors)
        smax = torch.where(fit, score, _INT64_MIN).max()
        ties = torch.nonzero(fit & (score == smax)).flatten()
        m = int(ties[L % ties.shape[0]])
        chosen[i] = m
        L += 1
        c_old = base[m] + selfm * j[m]  # m was fit
        j[m] += 1
        jm = int(j[m])
        new_fit = bool(fs[m]) and jm < int(frontier[m])
        fit[m] = new_fit
        c_new = base[m] + selfm * j[m]
        zc[zone[m]] += (c_new if new_fit else 0) - c_old
        if jm >= rows_dyn:
            n_done, bailed = i + 1, 1
            break
    return chosen, j, torch.tensor([L, n_done, bailed], dtype=I64,
                                   device=dev)


def _scores(nodes, weights, j, fit, zc, nz_c, nz_m, selfm, num_zones,
            has_selectors):
    """The combined i64 score vector at commit counts j (models/zreplay
    `scores` of the JAX package, one torch op per JAX op)."""
    score = nodes["static_add"].clone()
    w_lr, w_ba = weights["w_lr"], weights["w_ba"]
    if w_lr or w_ba:
        nzj_c = nodes["nz_cpu0"] + j * nz_c
        nzj_m = nodes["nz_mem0"] + j * nz_m
        pc = torch.tensor(nz_c, dtype=I64, device=j.device)
        pm = torch.tensor(nz_m, dtype=I64, device=j.device)
        args = (pc, pm, nzj_c, nzj_m, nodes["alloc_cpu"], nodes["alloc_mem"])
        if w_lr:
            score = score + w_lr * R.least_requested(*args)
        if w_ba:
            score = score + w_ba * R.balanced_resource_allocation(*args)
    if weights["w_spread"]:
        ten = torch.tensor(10.0, dtype=F32, device=j.device)
        c = nodes["spread_base"] + (j if selfm else 0)
        M = torch.where(fit, c, 0).max().clamp(min=0)
        cm = torch.where(fit, c, 0)
        f = torch.where(M > 0, ten * ((M - cm).to(F32) / M.to(F32)), ten)
        if num_zones > 1:
            zone = nodes["zone_id"].to(I64)
            have_zones = (fit & (zone > 0)).any()
            ids = torch.arange(num_zones, device=j.device)
            max_zone = torch.where(ids > 0, zc, 0).max().clamp(min=0)
            zone_score = ten * ((max_zone - zc[zone]).to(F32)
                                / max_zone.to(F32))
            third = torch.tensor(1.0 / 3.0, dtype=F32, device=j.device)
            two_thirds = torch.tensor(2.0 / 3.0, dtype=F32, device=j.device)
            blended = f * third + two_thirds * zone_score
            f = torch.where(have_zones & (zone > 0), blended, f)
        if not has_selectors:
            f = torch.full_like(f, 10.0)
        nan = torch.isnan(f)
        fi = torch.where(nan, 0.0, f).to(I64)
        score = score + weights["w_spread"] * torch.where(nan, _INT64_MIN,
                                                          fi)
    if weights["w_na"]:
        na = nodes["na_counts"]
        mx = torch.where(fit, na, 0).max().clamp(min=0)
        f = torch.where(mx > 0, 10.0 * (na.to(F64) / mx.to(F64)), 0.0)
        score = score + weights["w_na"] * f.to(I64)
    if weights["w_tt"]:
        tt = nodes["tt_counts"]
        mx = torch.where(fit, tt, 0).max().clamp(min=0)
        f = torch.where(mx > 0, (1.0 - tt.to(F64) / mx.to(F64)) * 10.0,
                        10.0)
        score = score + weights["w_tt"] * f.to(I64)
    if weights["w_ip"]:
        ip = nodes["ip_totals"]
        big = 2**62
        mx = torch.where(fit, ip, -big).max().clamp(min=0)
        mn = torch.where(fit, ip, big).min().clamp(max=0)
        rng = mx - mn
        f = torch.where(rng > 0, 10.0 * ((ip - mn).to(F64) / rng.to(F64)),
                        0.0)
        score = score + weights["w_ip"] * torch.where(fit, f.to(I64), 0)
    return score


def load(path: str) -> ctypes.CDLL:
    """Load a built K3 library and declare its C interface."""
    lib = ctypes.CDLL(path)
    fn = lib.zreplay_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 17
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 7
                   + [ctypes.c_int, ctypes.c_void_p])
    fn = lib.zreplay_scratch_bytes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong)]
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

    return build_cuda("zreplay_kernel")


def scratch_bytes(N: int, num_zones: int, device=None, lib=None) -> int:
    """Device-memory bytes the kernel (of `lib`; this checkout's by
    default) needs for its per-node state at (N, num_zones): 0 when the
    state fits on chip. Raises when num_zones does not fit in shared
    memory at all."""
    out = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        err = (lib or _lib()).zreplay_scratch_bytes(int(N), int(num_zones),
                                                    ctypes.byref(out))
    if err == -1:
        raise ValueError(f"replay_picks: {num_zones} zones do not fit in "
                         f"shared memory")
    if err != 0:
        raise RuntimeError(f"zreplay_scratch_bytes failed: CUDA error {err}")
    return int(out.value)


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"replay_picks: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _c_args(nodes: dict, scalars: torch.Tensor, weights: dict, *, K: int,
            k_real: int, rows_dyn: int, num_zones: int, has_selectors: bool,
            lib=None):
    """Check one launch's inputs and allocate its outputs -> (the C
    entry's arguments, (chosen, j, state), scratch or None)."""
    device = scalars.device
    N = nodes["frontier"].shape[0]
    for name in NODE_INPUTS:
        dtype = (torch.uint8 if name == "fit_static"
                 else torch.int32 if name == "zone_id" else I64)
        _check(name, nodes[name], dtype, (N,), device)
    _check("scalars", scalars, I64, (len(SCALARS),), device)
    if not 0 <= k_real <= K:
        raise ValueError(f"replay_picks: k_real {k_real} outside [0, {K}]")
    chosen = torch.empty((K,), dtype=torch.int32, device=device)
    j = torch.empty((N,), dtype=I64, device=device)
    state = torch.empty((3,), dtype=I64, device=device)
    nbytes = scratch_bytes(N, num_zones, device, lib)
    scratch = (torch.empty((nbytes,), dtype=torch.uint8, device=device)
               if nbytes else None)
    args = (*(nodes[name].data_ptr() for name in NODE_INPUTS),
            scalars.data_ptr(), chosen.data_ptr(), j.data_ptr(),
            state.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            int(N), int(K), int(k_real), int(num_zones), int(rows_dyn),
            *(int(weights[w]) for w in WEIGHTS), int(bool(has_selectors)),
            torch.cuda.current_stream(device).cuda_stream)
    return args, (chosen, j, state), scratch


def _launch(nodes: dict, scalars: torch.Tensor, weights: dict, *, K: int,
            k_real: int, rows_dyn: int, num_zones: int, has_selectors: bool,
            lib=None):
    """Launch the kernel (of `lib`, a library from load(); this
    checkout's by default)."""
    global LAUNCHES
    args, out, _scratch = _c_args(
        nodes, scalars, weights, K=K, k_real=k_real, rows_dyn=rows_dyn,
        num_zones=num_zones, has_selectors=has_selectors, lib=lib)
    with torch.cuda.device(scalars.device):
        err = (lib or _lib()).zreplay_launch(*args)
    if err != 0:
        raise RuntimeError(f"zreplay kernel launch failed: error {err}")
    LAUNCHES += 1
    key = (nodes["frontier"].shape[0], K, num_zones)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1
    return out


def replay_picks(nodes: dict, scalars: torch.Tensor, weights: dict, *,
                 K: int, k_real: int, rows_dyn: int, num_zones: int,
                 has_selectors: bool):
    """-> (chosen i32[K], j i64[N], state i64[3] = (L, n_done, bailed))
    for one run's pick loop. nodes: NODE_INPUTS name -> tensor;
    scalars: i64[5] (SCALARS); weights: WEIGHTS name -> int. CUDA
    tensors launch the kernel; CPU tensors run the plain version; any
    other device raises."""
    device = scalars.device
    kw = dict(K=K, k_real=k_real, rows_dyn=rows_dyn, num_zones=num_zones,
              has_selectors=has_selectors)
    if device.type == "cpu":
        return replay_picks_plain(nodes, scalars, weights, **kw)
    if device.type != "cuda":
        raise ValueError(f"replay_picks: no kernel for device {device}")
    if nodes["zone_id"].dtype in (torch.int8, torch.int16):
        # a narrowed zone table: widened explicitly to the kernel's dtype
        nodes = dict(nodes, zone_id=nodes["zone_id"].to(torch.int32))
    return _launch(nodes, scalars, weights, **kw)
