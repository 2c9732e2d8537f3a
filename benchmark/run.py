"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell names a configuration (its file in BENCHMARK.json) and a
traffic mix (benchmark/traffic/<name>.json); per-layer metrics are
readers in benchmark/metrics/<name>.py. All three are found by name, so
a cell, a mix or a metric is added by adding files and entries.

Set-up makes the cluster description from the seed (benchmark/traffic.py),
builds the program's objects and one TorchScheduleAlgorithm on the card,
and makes one warm call on each initial state. The window then calls
schedule_backlog back to back, alternating the initial states, until the
first return after --seconds. With --trace 1 the program's tracing is on
and the window runs under the profiler; with --trace 0 both are off.

After the window the plain NumPy reference (benchmark/reference/)
re-derives the node of every pod of a sample of the window's calls drawn
from the seed, and every call is checked to have placed every pod and to
have pushed no node past its allocatable pods, CPU or memory. The
compared numbers and their limits are printed as the last lines of
standard error and under "checks", the last key of the result line.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from benchmark import traffic  # noqa: E402

#: top-level module names that may not be loaded in the process that
#: prints the result: JAX and the JAX package the program was ported from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "kubernetes_tpu")
#: traced windows taken before a short trace is an error
TRACE_TRIES = 3
#: pods of the window's calls whose every answer the reference re-derives
CHECK_PODS = 200_000
#: the kernel caches a run may fill, each at a fixed directory under
#: build/benchmark_cache/ in the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def load_manifest(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_config(root: str, manifest: dict, name: str) -> dict:
    """A configuration by name, from the file BENCHMARK.json gives it."""
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(bench_dir: str, name: str) -> dict:
    """A traffic mix by name: benchmark/traffic/<name>.json."""
    with open(os.path.join(bench_dir, "traffic", f"{name}.json")) as f:
        return json.load(f)


def load_metric(bench_dir: str, name: str):
    """A per-layer metric's reader by name: benchmark/metrics/<name>.py,
    whose read(ctx) returns the value or None."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, cell: str, section: str) -> list:
    """The entries of a section ("end_to_end" or "per_layer") that the
    cell reports."""
    return [m for m in manifest[section]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES,
    compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def sample_size(desc: dict) -> int:
    """Calls the reference re-derives: enough for CHECK_PODS pods, and
    at least one of each initial state."""
    count = traffic.backlog_size(desc)
    return max(len(desc["states"]), -(-CHECK_PODS // count))


def sample_calls(n_calls: int, k: int, seed: int) -> list:
    """The window's calls the reference re-derives: the last one, one of
    the other initial state where there is one, and the rest drawn from
    the seed, k in all (fewer where the window made fewer)."""
    if n_calls == 0:
        return []
    rng = traffic.rng_of(seed, 1000)
    picked = [n_calls - 1]
    other = list(range(n_calls % 2, n_calls - 1, 2))
    if other:
        picked.append(int(other[rng.integers(len(other))]))
    rest = [w for w in range(n_calls) if w not in picked]
    for w in rng.permutation(len(rest))[:max(k - len(picked), 0)]:
        picked.append(rest[int(w)])
    return sorted(picked)


def capacity_violations(cluster, groups, names) -> int:
    """Nodes that one call's answers push past their allocatable pods,
    CPU or memory, plus pods sent to a name that is no node."""
    from benchmark.reference.scheduler import container_requests

    pos, N = cluster.pos, len(cluster.names)
    pods = cluster.npods.copy()
    cpu = cluster.req_cpu.copy()
    mem = cluster.req_mem.copy()
    bad = 0
    start = 0
    for g in groups:
        part = names[start:start + g["count"]]
        start += g["count"]
        idx = np.fromiter((pos.get(n, -1) for n in part if n is not None),
                          np.int64)
        bad += int((idx < 0).sum())
        placed = np.bincount(idx[idx >= 0], minlength=N)
        g_cpu, g_mem, _, _ = container_requests(g["containers"])
        pods += placed
        cpu += placed * g_cpu
        mem += placed * g_mem
    return bad + int(((pods > cluster.alloc_pods) | (cpu > cluster.alloc_cpu)
                      | (mem > cluster.alloc_mem)).sum())


def check(desc: dict, outputs: list, first_g: int, seed: int) -> dict:
    """Judge the window's answers. outputs[w]: the node names of window
    call w, the process's call first_g + w. Every call is checked to
    place every pod and to overfill no node; the reference re-derives
    every answer of a sample of calls drawn from the seed.
    -> {"checks": {name: {"value", "limit", "of"}}, "node_picks":
    {state: picks a call}, "checked_calls": [w]}."""
    from benchmark.reference.scheduler import Cluster

    groups = desc["groups"]
    count = traffic.backlog_size(desc)
    clusters = [Cluster(st, desc["services"], desc["controllers"],
                        desc["namespace"]) for st in desc["states"]]
    for s, c in enumerate(clusters):
        if c.room(groups) < count:
            raise SystemExit(f"traffic error: state {s} may hold fewer "
                             f"than the backlog's {count} pods")
    n_calls = len(outputs)
    unplaced = overfull = 0
    for w, names in enumerate(outputs):
        unplaced += sum(n is None for n in names)
        overfull += capacity_violations(
            clusters[(first_g + w) % len(clusters)], groups, names)
    # every call places all its pods, so lastNodeIndex is the call's
    # index times the backlog
    mismatched = 0
    picks = {}
    sample = sample_calls(n_calls, sample_size(desc), seed)
    for w in sample:
        g = first_g + w
        s = g % len(clusters)
        want, _last, node_picks = clusters[s].schedule(groups, g * count)
        got = outputs[w]
        mismatched += sum(a != b for a, b in zip(got, want))
        mismatched += abs(len(got) - len(want))
        picks.setdefault(s, []).append(node_picks)
    return {"checks": {
        "mismatched_pods": {"value": mismatched, "limit": 0,
                            "of": count * len(sample)},
        "unplaced_pods": {"value": unplaced, "limit": 0,
                          "of": count * n_calls},
        "overfull_nodes": {"value": overfull, "limit": 0,
                           "of": len(clusters[0].names) * n_calls}},
        "node_picks": {s: sum(v) / len(v) for s, v in picks.items()},
        "checked_calls": sample}


def five_numbers(xs) -> list:
    """[least, lower quartile, median, upper quartile, most] of xs."""
    xs = sorted(xs)
    n = len(xs)
    return [xs[0], xs[n // 4], xs[n // 2], xs[3 * n // 4], xs[-1]]


def window(system, g0: int, seconds: float):
    """Calls back to back from process call g0 until the first return
    after `seconds`. -> (wall seconds, [names of each call], each call's
    seconds)."""
    outputs, stamps = [], []
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        outputs.append(system.call(g0 + len(outputs)))
        now = time.perf_counter()
        stamps.append(now)
        if now >= end:
            break
    return (now - t0, outputs,
            [b - a for a, b in zip([t0] + stamps, stamps)])


def traced_window(system, g0: int, seconds: float):
    """window() under the profiler, retaken (from the next call on) while
    the trace holds fewer K1 or K3 events than the wrappers launched.
    -> (window()'s three, the window's first call, counters' diff, device
    events, traces taken)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import roofline, sut

    seen = []
    for _ in range(TRACE_TRIES):
        before = system.counters()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(roofline.PRIMER_CYCLES)
            timed = window(system, g0, seconds)
        diff = sut.diff_counters(system.counters(), before)
        events = roofline.device_events(prof)
        k1 = roofline.kernel_ns(events, roofline.K1_SYMBOL)[1]
        k3 = roofline.kernel_ns(events, roofline.K3_SYMBOL)[1]
        seen.append({"k1": [k1, diff["k1"]], "k3": [k3, diff["k3"]]})
        if k1 == diff["k1"] and k3 == diff["k3"]:
            return (*timed, g0, diff, events, seen)
        g0 += len(timed[1])
    raise RuntimeError(f"{TRACE_TRIES} traces recorded [events, launches] "
                       f"{seen}")


def run_cell(root: str, bench_dir: str, manifest: dict, cell: dict,
             seed: int, seconds: float, trace: bool, device: str,
             t0: float) -> dict:
    """One run of a cell: -> the result line's object. device "cpu"
    serves the tests; a measured run is on "cuda"."""
    import torch

    from benchmark import roofline, sut

    stages = {"start": time.perf_counter() - t0}
    config = load_config(root, manifest, cell["config"])
    mix = load_traffic(bench_dir, cell["traffic"])
    desc = traffic.describe(config, mix, seed)
    count = traffic.backlog_size(desc)
    stages["describe"] = time.perf_counter() - t0
    system = sut.System(desc, device)
    stages["objects"] = time.perf_counter() - t0
    for g in range(len(desc["states"])):
        system.call(g)
        stages[f"warm_call_{g}"] = time.perf_counter() - t0
    g0 = len(desc["states"])
    gc.collect()
    gc.freeze()
    on_card = device != "cpu"
    setup_s = time.perf_counter() - t0

    if trace and on_card:
        (wall, outputs, call_s, first_g, diff, events,
         seen) = traced_window(system, g0, seconds)
    else:
        before = system.counters()
        wall, outputs, call_s = window(system, g0, seconds)
        diff = sut.diff_counters(system.counters(), before)
        first_g, events, seen = g0, [], []
    n_calls = len(outputs)

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name() if on_card
                    else "cpu"),
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if on_card else 0)}
    if on_card:
        dev["power_limit_w"] = roofline.power_limit_w()
    del system
    gc.unfreeze()
    gc.collect()

    t_check = time.perf_counter()
    verdict = check(desc, outputs, first_g, seed)
    stages["reference_s"] = time.perf_counter() - t_check
    checks = verdict["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    unplaced = checks["unplaced_pods"]["value"]
    pods = n_calls * count - unplaced

    metrics = {}
    breakdown = None
    name = cell["name"]
    if not trace:
        values = {"pods_per_s": pods / wall, "setup_s": setup_s}
        for m in cell_metrics(manifest, name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        busy_ns = roofline.union_ns(events)
        dev["busy_s"] = busy_ns / 1e9
        dev["window_s"] = wall
        diff["dispatches"] = {k: v for k, v in diff["dispatches"].items()
                              if k not in sut.POD_TALLIES}
        routes = set(diff["dispatches"])
        zreplay_pods = (count * n_calls
                        if routes <= set(sut.ZREPLAY_ROUTES) else None)
        state_picks = verdict["node_picks"]
        n_states = len(desc["states"])
        node_picks = sum(state_picks.get((first_g + w) % n_states, 0)
                         for w in range(n_calls))
        ctx = {"window_s": wall, "calls": n_calls, "pods": pods,
               "zreplay_pods": zreplay_pods, "node_picks": node_picks,
               "busy_ns": busy_ns, "events": events, **diff}
        for m in cell_metrics(manifest, name, "per_layer"):
            value = load_metric(bench_dir, m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        host = sorted(diff["phases"].items(), key=lambda x: -x[1])
        other = wall - sum(v for _k, v in host)
        breakdown = {"device_ops": roofline.top_ops(events),
                     "idle_gaps": [[f"host phase {k}", v]
                                   for k, v in host][:9]
                     + [["host outside the phases", other]]}
        dev["traces"] = seen
        k3_ms = [(e - s) / 1e6 for n, s, e in events
                 if roofline.K3_SYMBOL in n]
        if k3_ms:
            dev["k3_ms"] = five_numbers(k3_ms)

    result = {"correct": correct,
              "attempted": n_calls * count,
              "failed": unplaced,
              "metrics": metrics,
              "device": dev,
              "calls": n_calls,
              "call_s": five_numbers(call_s),
              "checked_calls": verdict["checked_calls"]}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_stages_s"] = stages
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's behaviour switches stay at their defaults; tracing is
    # on only in traced runs
    for key in [k for k in os.environ if k.startswith("KUBERNETES_TPU_")]:
        del os.environ[key]
    os.environ["KUBERNETES_TPU_TRACE"] = "1" if args.trace else "0"
    # kernel caches at fixed paths inside the checkout (the program's own
    # CUDA builds go to build/torch_kernels/ beside its package)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(ROOT, "build", "benchmark_cache", sub)

    import torch

    manifest = load_manifest(ROOT)
    cell = find_cell(manifest, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(ROOT, BENCH_DIR, manifest, cell, args.seed,
                      args.seconds, bool(args.trace), "cuda", T0)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']}, "
              f"of {c['of']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
