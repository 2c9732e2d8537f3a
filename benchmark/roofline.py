"""The frozen yardstick: published H100 peaks, the least time of the
scheduler's kernels from their shapes, and the reader of a profiler
trace.

The two bounds are copies of chip_smoke.py's probe_bound_ms and
zreplay_bound_ms as they stood when this benchmark was written; they
live here so that no change to the program moves them.
"""

from __future__ import annotations

import subprocess

#: NVIDIA H100 SXM data sheet: the HBM3 rate and the float64 and float32
#: rates of the CUDA cores (the probe's float64 BalancedAllocation math,
#: the pick loop's float32 SelectorSpread math); the int32 rate of the
#: CUDA cores from NVIDIA's H100 architecture whitepaper (SXM5: 33.5
#: TOPS), for the pick loop's 64-bit score sums and compares. All at
#: the card's full power limit of 700 W.
HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 34e12
F32_FLOP_PER_S = 67e12
INT32_OPS_PER_S = 33.5e12
PEAK_POWER_W = 700.0

#: the kernels' symbols in a trace
K1_SYMBOL = "resource_probe"
K3_SYMBOL = "zreplay_kernel"

#: the kernel a trace starts with (torch.cuda._sleep's) and its length in
#: cycles; it is left out of every sum
PRIMER_KERNEL, PRIMER_CYCLES = "spin_kernel", 1000


def probe_bound_ms(J: int, N: int) -> tuple:
    """Least time of one K1 sweep: each input read once, each output
    written once, over the HBM rate; the float64 operations (2 div, 2
    sub, 1 mul per (j, n)) over the float64 rate.
    -> (ms, "bytes" | "operations")."""
    nbytes = 9 * 8 + 10 * N * 8 + N * 8 + J * N * 8
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 5 * J * N / F64_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def zreplay_bound_ms(N: int, K: int, node_picks: int) -> tuple:
    """Least time of one K3 run: its inputs read once (eleven i64 rows,
    the u8 fit row, the i32 zones, five scalars) and its outputs written
    once (chosen i32[K], j i64[N], three i64) over the HBM rate; what
    each pick needs of each node that fits at it (node_picks in all):
    the float32 add of its spread and zone terms and the truncation,
    over the float32 rate, and the 64-bit add to its score and the
    compare with the maximum (two int32 operations each), over the int32
    rate. -> (ms, "bytes" | "operations")."""
    nbytes = N * (11 * 8 + 1 + 4) + 5 * 8 + K * 4 + N * 8 + 3 * 8
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (2 * node_picks / F32_FLOP_PER_S
             + 4 * node_picks / INT32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def power_limit_w():
    """The card's power limit in watts, as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_events(prof) -> list:
    """A finished torch.profiler trace -> [(name, start ns, end ns)] of
    every device event in it (kernels, copies, sets), the primer and
    hidden events left out. It reads the trace's raw Kineto events:
    building the profiler's own event list takes minutes for a long
    trace."""
    import torch

    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA \
                or getattr(ev, "is_hidden_event", lambda: False)():
            continue
        name = ev.name()
        if PRIMER_KERNEL in name:
            continue
        start = ev.start_ns()
        out.append((name, start, start + ev.duration_ns()))
    return out


def union_ns(events) -> int:
    """Nanoseconds covered by at least one of the events."""
    total, end = 0, None
    for _name, s, e in sorted(events, key=lambda x: x[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def kernel_ns(events, symbol: str) -> tuple:
    """-> (summed device ns, count) of the events whose name holds
    symbol."""
    ns = n = 0
    for name, s, e in events:
        if symbol in name:
            ns += e - s
            n += 1
    return ns, n


def top_ops(events, k: int = 10) -> list:
    """The k device operations that took most time: [[name, seconds]]."""
    by = {}
    for name, s, e in events:
        by[name] = by.get(name, 0) + (e - s)
    ranked = sorted(by.items(), key=lambda x: -x[1])[:k]
    return [[name[:120], ns / 1e9] for name, ns in ranked]
