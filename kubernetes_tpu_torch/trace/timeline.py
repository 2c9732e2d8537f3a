"""A window's spans against a device trace: the clock that joins them,
and what the host was doing while the device sat idle.

Reads what trace/spans.BUFFER recorded over a window (BUFFER.since: span
records with "start_ns" and "end_ns" in time.perf_counter_ns()) and a
device trace's events, [(name, start ns, end ns)] on the trace's own
clock (torch.profiler's Kineto timestamps).

- clock_offset checks, rather than assumes, where the device clock sits
  on the host's. Each K3 event is paired, in order, with the
  `wave.replay.launch` span that enqueued it (its `k3` attribute counts
  them): the kernel cannot start before that span began, nor end after
  the next `wave.replay.wait` span ended, since the wait returns only
  once the device has finished. Every pair bounds the host-minus-device
  offset; the bounds must leave an interval, and the offset is 0 where
  0 lies in it (one clock), else its midpoint.
- idle_by_span splits the window's device-idle time by the innermost
  span open at each instant, None where no span was open.

The JAX package has no counterpart: its device trace is XLA's.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

#: the span around a device replay's enqueue, and the one around its
#: device-to-host copy (models/zreplay.ZReplay.run / run_group)
LAUNCH = "wave.replay.launch"
WAIT = "wave.replay.wait"
#: K3's symbol in a trace (csrc/zreplay_kernel.cu)
K3_SYMBOL = "zreplay_kernel"

Event = Tuple[str, int, int]


def _named(spans: Sequence[dict], name: str) -> List[dict]:
    return sorted((s for s in spans if s["name"] == name),
                  key=lambda s: s["start_ns"])


def clock_offset(spans: Sequence[dict], events: Sequence[Event],
                 symbol: str = K3_SYMBOL) -> Optional[Tuple[int, int, int]]:
    """-> (lo, hi, offset) in ns, host = device + offset for any offset
    in [lo, hi]; None where the window launched no K3 and the trace
    holds none. Raises ValueError where the trace's K3 events are not
    the ones the launch spans enqueued, a launch has no wait after it,
    or no offset fits every pair."""
    launches = _named(spans, LAUNCH)
    waits = _named(spans, WAIT)
    k3 = sorted((e for e in events if symbol in e[0]), key=lambda e: e[1])
    counts = [int(s.get("attrs", {}).get("k3", 0)) for s in launches]
    if sum(counts) != len(k3):
        raise ValueError(f"{len(k3)} {symbol} events in the trace, "
                         f"{sum(counts)} enqueued by {len(launches)} launch "
                         f"spans")
    if not k3:
        return None
    wait_starts = [w["start_ns"] for w in waits]
    lo, hi = None, None
    ev = iter(k3)
    for s, n in zip(launches, counts):
        i = bisect_left(wait_starts, s["end_ns"])
        if i == len(waits):
            raise ValueError(f"a {LAUNCH} span at {s['start_ns']} ns has "
                             f"no {WAIT} span after it")
        wait_end = waits[i]["end_ns"]
        for _ in range(n):
            _name, k_start, k_end = next(ev)
            a, b = s["start_ns"] - k_start, wait_end - k_end
            lo = a if lo is None else max(lo, a)
            hi = b if hi is None else min(hi, b)
    if lo > hi:
        raise ValueError(f"no host-minus-device offset fits every K3 "
                         f"event: [{lo}, {hi}] ns")
    return lo, hi, (0 if lo <= 0 <= hi else (lo + hi) // 2)


def _busy(events: Sequence[Event], offset: int, start: int,
          end: int) -> List[List[int]]:
    """The device events on the host clock, merged and clipped to
    [start, end]: [[start, end]] in order."""
    out: List[List[int]] = []
    for _name, s, e in sorted(events, key=lambda x: x[1]):
        s, e = max(s + offset, start), min(e + offset, end)
        if s >= e:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(spans: Sequence[dict], start: int,
               end: int) -> List[Tuple[int, int, Optional[str]]]:
    """[start, end] cut into pieces, each with the name of the innermost
    span open through it (the latest-started of those open, the earlier
    ending of two that started together), or None."""
    marks = []
    for k, s in enumerate(spans):
        marks.append((s["start_ns"], 1, k))
        marks.append((s["end_ns"], 0, k))
    marks.sort()
    open_: Dict[int, Tuple[int, int]] = {}
    pieces = []
    t = start

    def inner():
        if not open_:
            return None
        return spans[max(open_, key=open_.get)]["name"]

    for when, opens, k in marks:
        when = min(max(when, start), end)
        if when > t:
            pieces.append((t, when, inner()))
            t = when
        if opens:
            open_[k] = (spans[k]["start_ns"], -spans[k]["end_ns"])
        else:
            open_.pop(k, None)
    if t < end:
        pieces.append((t, end, inner()))
    return pieces


def idle_by_span(spans: Sequence[dict], events: Sequence[Event],
                 offset: int, start: int,
                 end: int) -> Dict[Optional[str], int]:
    """Nanoseconds of [start, end] (host clock) in which no device event
    ran, by the innermost span open then (None: no span open). The
    device events are placed on the host clock by `offset`
    (clock_offset's)."""
    busy = _busy(events, offset, start, end)
    idle, t = [], start
    for s, e in busy:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if t < end:
        idle.append((t, end))
    out: Dict[Optional[str], int] = {}
    pieces = _innermost(spans, start, end)
    i = 0
    for a, b in idle:
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            p0, p1, name = pieces[j]
            ns = min(p1, b) - max(p0, a)
            if ns > 0:
                out[name] = out.get(name, 0) + ns
            j += 1
    return out
