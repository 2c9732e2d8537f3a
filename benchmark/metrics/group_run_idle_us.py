"""Median idle time between consecutive K3 launches, in microseconds:
for each pair of K3 events in start order, the time from the first's end
to the second's start less what other device events cover of it (their
union). Inside a grouped device replay this is the time the card waits
for the host to enqueue the next run; the one pair a call that spans the
encode falls outside the median where a call holds many runs."""

import bisect
import statistics

from benchmark import roofline


def _merged(spans) -> list:
    """Sorted (start, end) spans -> their union as disjoint spans."""
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(ctx):
    k3 = sorted((s, e) for name, s, e in ctx["events"]
                if roofline.K3_SYMBOL in name)
    if len(k3) < 2:
        return None
    busy = _merged(sorted((s, e) for name, s, e in ctx["events"]
                          if roofline.K3_SYMBOL not in name))
    ends = [e for _s, e in busy]
    gaps = []
    for (_s, a), (b, _e) in zip(k3, k3[1:]):
        idle = max(b - a, 0)
        i = bisect.bisect_right(ends, a)
        while idle and i < len(busy) and busy[i][0] < b:
            idle -= min(busy[i][1], b) - max(busy[i][0], a)
            i += 1
        gaps.append(idle)
    return statistics.median(gaps) / 1e3
