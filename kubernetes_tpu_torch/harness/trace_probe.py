"""Does a CUDA profiler trace keep every kernel event? A probe for the
card, the reason chip_smoke.py opens every trace the way cuda_trace does.

It traces the victim scorer K6 (20 launches a trace, back to back) in
one process, first on a quiet host, then after each of the things a
chip_smoke run does to its process: a fork and exec of a short command
(subprocess), a bare os.fork() whose child exits at once, a spawned
process that imports torch and exits, a spawned pool of CPU-bound
workers (running, then stopped), and, before each trace, what
chip_smoke.py's phase 3c does between two cases (a ~20 ms device sleep
with CUDA timing events around queued launches, and the plain version's
torch ops). Under each condition it takes TRACES traces of each way to
open a trace:

- plain: torch.profiler.profile(activities=[CUDA]) around the launches;
- primer: the same, a 1,000-cycle torch.cuda._sleep first;
- warmup: a profiler schedule with one warm-up step (the CUPTI activity
  enabled, a primer launched and synchronized, its records discarded)
  before the active step that holds the launches;
- warmup3: the same with three warm-up steps;
- flush: plain, with a synchronize and a 50 ms host wait inside the
  context after the launches.

Every way synchronizes inside the context before it closes. One JSON
row a condition and way: each trace's count of K6 events and the first
device events of a few traces in time order (K: K6, S: the primer):

    python -m kubernetes_tpu_torch.harness.trace_probe

It needs a card and exits 1 without one.
"""

import json
import multiprocessing as mp
import os
import subprocess
import sys
import time

import torch

LAUNCHES = 20
TRACES = 8
PRIMER_CYCLES = 1000
BURNERS = 3
WAYS = ("plain", "primer", "warmup", "warmup3", "flush")


def burn(stop) -> None:
    """A CPU-bound process (two torch threads) until stop is set."""
    torch.set_num_threads(2)
    a = torch.randn(384, 384)
    while not stop.is_set():
        for _ in range(50):
            a = (a @ a).clamp(-1, 1)


def touch_torch() -> None:
    """A spawned process that imports torch and exits."""
    torch.zeros(1)


def trace(fn, way: str) -> dict:
    """One trace of LAUNCHES calls of fn, opened the given way -> {"k6":
    K6 events, "order": the device events in time order, one letter
    each}."""
    from torch.profiler import ProfilerActivity, profile, schedule

    steps = {"warmup": 1, "warmup3": 3}.get(way, 0)
    if steps:
        ctx = profile(activities=[ProfilerActivity.CUDA],
                      schedule=schedule(wait=0, warmup=steps, active=1,
                                        repeat=1))
    else:
        ctx = profile(activities=[ProfilerActivity.CUDA])
    with ctx as prof:
        if way == "primer":
            torch.cuda._sleep(PRIMER_CYCLES)
        for _ in range(steps):
            torch.cuda._sleep(PRIMER_CYCLES)
            torch.cuda.synchronize()
            prof.step()
        for _ in range(LAUNCHES):
            fn()
        torch.cuda.synchronize()
        if way == "flush":
            time.sleep(0.05)
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    order = "".join("K" if "victim_score" in e.name
                    else "S" if "spin_kernel" in e.name else "o"
                    for e in evs)
    return {"k6": order.count("K"), "order": order}


def rows(label: str, fn, before=None) -> None:
    """TRACES traces of fn each way; before() runs ahead of each trace."""
    for way in WAYS:
        got = []
        for _ in range(TRACES):
            if before is not None:
                before()
            got.append(trace(fn, way))
        print(json.dumps({"host": label, "way": way,
                          "k6": [r["k6"] for r in got],
                          "whole": sum(r["k6"] == LAUNCHES for r in got),
                          "orders": [r["order"][:6] for r in got[:3]]}),
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_probe: needs a CUDA device", file=sys.stderr)
        return 1
    from kubernetes_tpu_torch.harness import scenarios as S
    from kubernetes_tpu_torch.ops import preempt as P
    from kubernetes_tpu_torch.ops import preempt_kernel as VK

    label, N, C, kind = S.VICTIM_CASES[0]
    c = S.victim_case(N, C, 0, kind)
    args = [torch.as_tensor(c[k]).cuda()
            for k in ("prio", "ord", "res", "free", "req")]

    def warm():
        VK._launch(*args, c["gang_prio"])

    def timed_work():
        """phase 3c between two cases: launches queued behind a device
        sleep inside CUDA timing events, then the plain version."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)
        start.record()
        for _ in range(10):
            warm()
        end.record()
        P.victim_score_plain(*args, c["gang_prio"])
        torch.cuda.synchronize()
        start.elapsed_time(end)
        warm()
        torch.cuda.synchronize()

    warm()
    torch.cuda.synchronize()
    print(json.dumps({"case": label, "launches": LAUNCHES,
                      "traces": TRACES}), flush=True)
    rows("quiet", warm)
    rows("after timed work", warm, timed_work)
    subprocess.run(["true"], check=True)
    rows("after subprocess", warm)
    pid = os.fork()
    if pid == 0:
        os._exit(0)
    os.waitpid(pid, 0)
    rows("after os.fork", warm)
    ctx = mp.get_context("spawn")
    p = ctx.Process(target=touch_torch)
    p.start()
    p.join(60)
    rows("after a spawned torch process", warm)
    stop = ctx.Event()
    procs = [ctx.Process(target=burn, args=(stop,), daemon=True)
             for _ in range(BURNERS)]
    for p in procs:
        p.start()
    time.sleep(8)
    rows("spawned burners running", warm)
    stop.set()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
    rows("burners stopped", warm)
    rows("burners stopped, after timed work", warm, timed_work)
    return 0


if __name__ == "__main__":
    sys.exit(main())
