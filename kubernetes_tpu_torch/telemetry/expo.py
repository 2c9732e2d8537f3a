"""Label-aware Prometheus text-exposition parsing, shared.

One parser for every consumer of /metrics text: the soak harness's
gate accounting (formerly a private copy in harness/procs.py), the
multi-process fleet scraper, and the telemetry collector — which
also feeds the IN-PROCESS registry through the same code path by
parsing ``registry.render()``, so HTTP and in-process scrapes cannot
drift apart. harness/procs.py re-exports these names for its old
callers.

Copy of kubernetes_tpu/telemetry/expo.py: only the import package differs.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

#: one parsed exposition sample: (metric name, labels, value)
Row = Tuple[str, Dict[str, str], float]


def parse_series(line: str) -> Optional[Row]:
    """'name{k="v",...} 12.0' -> (name, {k: v}, 12.0); None on junk."""
    try:
        series, value = line.rsplit(" ", 1)
        v = float(value)
    except ValueError:
        return None
    series = series.strip()
    if "{" in series:
        name, _, rest = series.partition("{")
        labels: Dict[str, str] = {}
        for pair in rest.rstrip("}").split(","):
            if "=" not in pair:
                continue
            k, _, val = pair.partition("=")
            labels[k.strip()] = val.strip().strip('"')
        return name, labels, v
    return series, {}, v


def parse_text(text: str) -> List[Row]:
    """Parse a whole exposition document (comments skipped) into rows.
    The collector runs registry.render() output through this, so the
    in-process scrape path exercises the same parser as HTTP."""
    rows: List[Row] = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        parsed = parse_series(line)
        if parsed is not None:
            rows.append(parsed)
    return rows


def scrape_raw(url: str, timeout: float = 5.0) -> List[Row]:
    """GET <url>/metrics -> [(name, labels, value)] exposition rows."""
    return parse_text(get_text(url, "/metrics", timeout=timeout))


def series_sum(rows, name: str, **labels: str) -> float:
    """Sum every exposition row of `name` whose labels include the
    given pairs (the label-filtered fold the soak's gate deltas use)."""
    total = 0.0
    for n, lbls, v in rows:
        if n != name:
            continue
        if all(lbls.get(k) == val for k, val in labels.items()):
            total += v
    return total


def scrape_metrics(url: str, timeout: float = 5.0) -> Dict[str, float]:
    """GET <url>/metrics and fold the exposition text into
    {metric_name: summed value across label sets} (enough for the
    soak's delta accounting; per-label detail via scrape_raw)."""
    out: Dict[str, float] = {}
    for name, _labels, v in scrape_raw(url, timeout):
        out[name] = out.get(name, 0.0) + v
    return out


def get_text(url: str, path: str, timeout: float = 5.0) -> str:
    """GET <url><path> -> body text (raises on transport errors)."""
    import http.client as _hc
    from urllib import parse as _up

    parts = _up.urlsplit(url)
    conn = _hc.HTTPConnection(parts.hostname, parts.port,
                              timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.read().decode(errors="replace")
    finally:
        conn.close()


def get_json(url: str, path: str,
             timeout: float = 3.0) -> Optional[dict]:
    """GET <url><path> -> parsed JSON dict, or None while unreachable
    or non-200 (the flight recorder's best-effort state probes)."""
    import http.client as _hc
    from urllib import parse as _up

    parts = _up.urlsplit(url)
    try:
        conn = _hc.HTTPConnection(parts.hostname, parts.port,
                                  timeout=timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                return None
            return json.loads(body)
        finally:
            conn.close()
    except (OSError, ValueError):
        return None


def healthz(url: str, timeout: float = 3.0) -> Optional[dict]:
    """GET <url>/healthz -> parsed dict, or None while unreachable."""
    return get_json(url, "/healthz", timeout=timeout)
