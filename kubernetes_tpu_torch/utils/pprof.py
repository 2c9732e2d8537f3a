"""In-process profiling endpoints (the pkg/httplog + net/http/pprof
role; the reference mounts /debug/pprof on every daemon's mux,
kube-scheduler server.go:96-99 gated by --profiling).

Two views, both text (pprof's debug=1 style):

- thread_stacks(): every live thread's current Python stack — the
  goroutine-dump analogue (`/debug/pprof/goroutine?debug=1`).
- sample_profile(seconds): statistical wall-clock profile — all threads
  sampled at `hz`, aggregated into "count  frame<-frame<-frame" lines,
  hottest first (`/debug/pprof/profile` without the protobuf wire).

Sampling, not tracing: a live daemon under load must stay usable while
being profiled (the same reason the reference profiles with pprof's
sampler rather than an instrumenting tracer). For the device side,
jax.profiler traces are driven by the operator (JAX_TRACEBACK... /
jax.profiler.start_trace) — these endpoints cover the host shell.

Copy of kubernetes_tpu/utils/pprof.py: only the import package differs.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
import traceback
from typing import Dict


def thread_stacks() -> str:
    """Every thread's stack, named (the goroutine dump analogue)."""
    names: Dict[int, str] = {
        t.ident: t.name for t in threading.enumerate() if t.ident
    }
    out = []
    for tid, frame in sorted(sys._current_frames().items()):
        out.append(f"thread {names.get(tid, '?')} (id {tid}):")
        out.extend(
            line.rstrip()
            for line in traceback.format_stack(frame)
        )
        out.append("")
    return "\n".join(out)


def sample_profile(seconds: float = 5.0, hz: float = 100.0,
                   depth: int = 6) -> str:
    """Sample all threads for `seconds`, aggregate identical stack
    prefixes, report hottest first."""
    counts: "collections.Counter[str]" = collections.Counter()
    me = threading.get_ident()
    interval = 1.0 / max(hz, 1.0)
    deadline = time.monotonic() + max(0.1, min(seconds, 60.0))
    n = 0
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            parts = []
            f = frame
            while f is not None and len(parts) < depth:
                code = f.f_code
                parts.append(
                    f"{code.co_filename.rsplit('/', 1)[-1]}:"
                    f"{code.co_name}"
                )
                f = f.f_back
            counts[" <- ".join(parts)] += 1
        n += 1
        time.sleep(interval)
    total = sum(counts.values()) or 1
    lines = [f"# {n} sampling rounds over {seconds}s "
             f"({len(counts)} distinct stacks)"]
    for stack, c in counts.most_common(60):
        lines.append(f"{100 * c / total:6.2f}%  {c:6d}  {stack}")
    return "\n".join(lines) + "\n"
