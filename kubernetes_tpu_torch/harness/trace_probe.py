"""Does a CUDA profiler trace keep every kernel event? A probe for the
card, the reason chip_smoke.py starts every trace with a primer kernel.

It traces the victim scorer K6 (20 launches a trace, back to back, and
each behind a 100 MB write that flushes L2) 40 times on a quiet host,
then with five CPU-bound processes running, then after they stopped;
with and without a 1,000-cycle torch.cuda._sleep primer as the first
kernel of each trace. One JSON row a condition, with each trace's count
of K6 events and the order of the first device events of a few traces
(K: K6, F: the flush, S: the primer):

    python -m kubernetes_tpu_torch.harness.trace_probe

It needs a card and exits 1 without one.
"""

import json
import multiprocessing as mp
import sys
import time

import torch

LAUNCHES = 20
TRACES = 6
PRIMER_CYCLES = 1000
BURNERS = 5


def burn(stop) -> None:
    """A CPU-bound process (two torch threads) until stop is set."""
    torch.set_num_threads(2)
    a = torch.randn(384, 384)
    while not stop.is_set():
        for _ in range(50):
            a = (a @ a).clamp(-1, 1)


def trace(fn, primer: bool) -> dict:
    """One trace of LAUNCHES calls of fn -> {"k6": K6 events, "order":
    the device events in time order, one letter each}."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if primer:
            torch.cuda._sleep(PRIMER_CYCLES)
        for _ in range(LAUNCHES):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    order = "".join("K" if "victim_score" in e.name
                    else "S" if "spin_kernel" in e.name
                    else "F" if "elementwise" in e.name else "o"
                    for e in evs)
    return {"k6": order.count("K"), "order": order}


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_probe: needs a CUDA device", file=sys.stderr)
        return 1
    from kubernetes_tpu_torch.harness import scenarios as S
    from kubernetes_tpu_torch.ops import preempt_kernel as VK

    label, N, C, kind = S.VICTIM_CASES[0]
    c = S.victim_case(N, C, 0, kind)
    args = [torch.as_tensor(c[k]).cuda()
            for k in ("prio", "ord", "res", "free", "req")]
    flush = torch.empty(100 << 20, dtype=torch.uint8, device="cuda")

    def warm():
        VK._launch(*args, c["gang_prio"])

    def cold():
        flush.zero_()
        VK._launch(*args, c["gang_prio"])

    warm()
    cold()
    torch.cuda.synchronize()
    rows = [trace(warm, False) for _ in range(40)]
    print(json.dumps({"case": label, "host": "quiet", "primer": False,
                      "mode": "warm", "k6": [r["k6"] for r in rows]}),
          flush=True)
    for host in ("loaded", "after"):
        ctx = mp.get_context("spawn")
        stop, procs = ctx.Event(), []
        if host == "loaded":
            procs = [ctx.Process(target=burn, args=(stop,), daemon=True)
                     for _ in range(BURNERS)]
            for p in procs:
                p.start()
            time.sleep(8)
        for primer in (False, True):
            for mode, fn in (("warm", warm), ("cold", cold)):
                rows = [trace(fn, primer) for _ in range(TRACES)]
                print(json.dumps({
                    "case": label, "host": host, "primer": primer,
                    "mode": mode, "k6": [r["k6"] for r in rows],
                    "orders": [r["order"][:12] for r in rows[:3]]}),
                    flush=True)
        stop.set()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
