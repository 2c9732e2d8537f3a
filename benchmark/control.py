"""The control of `correct`: the reference put in the program's place,
its float32 SelectorSpread steps rounded to bfloat16, judged by the
harness's own check (run.check). It must come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

For each seed it makes the cell's description, computes in bfloat16 as
many calls as a run's check re-derives (the first window calls after the
two warm ones), hands them to run.check as a window's answers, and
prints one JSON line a seed with the check's numbers. The benchmark's
own runs do not run it; it needs no card.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run, traffic  # noqa: E402
from benchmark.reference.scheduler import Cluster  # noqa: E402


def control(root: str, manifest: dict, cell: dict, seed: int) -> dict:
    config = run.load_config(root, manifest, cell["config"])
    mix = run.load_traffic(BENCH_DIR, cell["traffic"])
    desc = traffic.describe(config, mix, seed)
    count = traffic.backlog_size(desc)
    states = len(desc["states"])
    clusters = [Cluster(st, desc["services"], desc["controllers"],
                        desc["namespace"]) for st in desc["states"]]
    t0 = time.perf_counter()
    outputs = []
    for w in range(run.sample_size(desc)):
        g = states + w
        names, _, _ = clusters[g % states].schedule(desc["groups"],
                                                     g * count, bf16=True)
        outputs.append(names)
    verdict = run.check(desc, outputs, states, seed)
    return {"workload": cell["name"], "seed": seed,
            "checks": verdict["checks"],
            "correct": all(c["value"] <= c["limit"]
                           for c in verdict["checks"].values()),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    manifest = run.load_manifest(ROOT)
    cell = run.find_cell(manifest, args.workload)
    for seed in args.seeds:
        print(json.dumps(control(ROOT, manifest, cell, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
