"""Human-readable table printers (pkg/kubectl/resource_printer.go).

Copy of kubernetes_tpu/kubectl/printers.py: only the import package differs."""

from __future__ import annotations

import time
from datetime import datetime, timezone
from typing import Any, Callable, Dict, List, Tuple


def age(ts) -> str:
    if not ts:
        return "<unknown>"
    try:
        created = datetime.strptime(ts, "%Y-%m-%dT%H:%M:%SZ").replace(
            tzinfo=timezone.utc
        )
    except ValueError:
        return "<unknown>"
    secs = int(time.time() - created.timestamp())
    if secs < 120:
        return f"{max(secs, 0)}s"
    if secs < 7200:
        return f"{secs // 60}m"
    if secs < 172800:
        return f"{secs // 3600}h"
    return f"{secs // 86400}d"


def _pod_row(p) -> List[str]:
    total = len(p.spec.containers)
    ready = sum(1 for c in p.status.container_statuses if c.ready)
    restarts = sum(c.restart_count for c in p.status.container_statuses)
    return [
        p.metadata.name,
        f"{ready}/{total}",
        p.status.phase or "Unknown",
        str(restarts),
        age(p.metadata.creation_timestamp),
    ]


def _node_row(n) -> List[str]:
    ready = "Unknown"
    for c in n.status.conditions:
        if c.type == "Ready":
            ready = "Ready" if c.status == "True" else "NotReady"
    if n.spec.unschedulable:
        ready += ",SchedulingDisabled"
    return [n.metadata.name, ready, age(n.metadata.creation_timestamp)]


def _svc_row(s) -> List[str]:
    ports = ",".join(
        f"{p.port}/{p.protocol}" for p in s.spec.ports
    ) or "<none>"
    return [
        s.metadata.name,
        s.spec.cluster_ip or "<none>",
        ports,
        age(s.metadata.creation_timestamp),
    ]


def _rc_row(rc) -> List[str]:
    return [
        rc.metadata.name,
        str(rc.spec.replicas),
        str(rc.status.replicas),
        age(rc.metadata.creation_timestamp),
    ]


def _deploy_row(d) -> List[str]:
    return [
        d.metadata.name,
        str(d.spec.replicas),
        str(d.status.replicas),
        str(d.status.updated_replicas),
        str(d.status.available_replicas),
        age(d.metadata.creation_timestamp),
    ]


def _job_row(j) -> List[str]:
    return [
        j.metadata.name,
        str(j.spec.completions if j.spec.completions is not None else "<none>"),
        str(j.status.succeeded),
        age(j.metadata.creation_timestamp),
    ]


def _event_row(e) -> List[str]:
    return [
        e.last_timestamp or "",
        str(e.count),
        f"{e.involved_object.kind}/{e.involved_object.name}",
        e.type,
        e.reason,
        e.source_component,
        e.message,
    ]


def _generic_row(o) -> List[str]:
    return [o.metadata.name, age(o.metadata.creation_timestamp)]


def _ingress_row(i) -> List[str]:
    hosts = ",".join(r.host or "*" for r in i.spec.rules) or "*"
    # resource_printer.go loadBalancerStatusStringer: ip, else hostname
    addrs = ",".join(
        ing.ip or ing.hostname
        for ing in i.status.load_balancer.ingress
        if ing.ip or ing.hostname
    )
    return [i.metadata.name, hosts, addrs,
            age(i.metadata.creation_timestamp)]


def _pdb_row(p) -> List[str]:
    return [
        p.metadata.name,
        str(p.spec.min_available),
        "true" if p.status.disruption_allowed else "false",
        age(p.metadata.creation_timestamp),
    ]


def _scheduledjob_row(sj) -> List[str]:
    return [
        sj.metadata.name,
        sj.spec.schedule,
        str(sj.spec.suspend),
        str(len(sj.status.active)),
        sj.status.last_schedule_time or "<none>",
        age(sj.metadata.creation_timestamp),
    ]


def _componentstatus_row(cs) -> List[str]:
    cond = cs.conditions[0] if cs.conditions else None
    healthy = "Healthy" if cond and cond.status == "True" else "Unhealthy"
    return [
        cs.metadata.name,
        healthy,
        (cond.message if cond else "") or "",
        (cond.error if cond else "") or "",
    ]


def _podgroup_row(pg) -> List[str]:
    return [
        pg.metadata.name,
        str(pg.spec.min_member),
        f"{pg.status.scheduled}/{max(pg.status.members, pg.status.scheduled)}",
        pg.status.phase or "Pending",
        str(pg.spec.priority),
        age(pg.metadata.creation_timestamp),
    ]


def _priorityclass_row(pc) -> List[str]:
    return [pc.metadata.name, str(pc.value),
            age(pc.metadata.creation_timestamp)]


TABLES: Dict[str, Tuple[List[str], Callable[[Any], List[str]]]] = {
    "pods": (["NAME", "READY", "STATUS", "RESTARTS", "AGE"], _pod_row),
    "nodes": (["NAME", "STATUS", "AGE"], _node_row),
    "services": (["NAME", "CLUSTER-IP", "PORT(S)", "AGE"], _svc_row),
    "replicationcontrollers": (["NAME", "DESIRED", "CURRENT", "AGE"], _rc_row),
    "replicasets": (["NAME", "DESIRED", "CURRENT", "AGE"], _rc_row),
    "deployments": (
        ["NAME", "DESIRED", "CURRENT", "UP-TO-DATE", "AVAILABLE", "AGE"],
        _deploy_row,
    ),
    "jobs": (["NAME", "COMPLETIONS", "SUCCESSFUL", "AGE"], _job_row),
    "events": (
        ["LASTSEEN", "COUNT", "OBJECT", "TYPE", "REASON", "SOURCE", "MESSAGE"],
        _event_row,
    ),
    "ingresses": (["NAME", "HOSTS", "ADDRESS", "AGE"], _ingress_row),
    "poddisruptionbudgets": (
        ["NAME", "MIN-AVAILABLE", "ALLOWED-DISRUPTIONS", "AGE"], _pdb_row,
    ),
    "scheduledjobs": (
        ["NAME", "SCHEDULE", "SUSPEND", "ACTIVE", "LAST-SCHEDULE", "AGE"],
        _scheduledjob_row,
    ),
    "componentstatuses": (
        ["NAME", "STATUS", "MESSAGE", "ERROR"], _componentstatus_row,
    ),
    "podgroups": (
        ["NAME", "MIN-MEMBER", "BOUND", "PHASE", "PRIORITY", "AGE"],
        _podgroup_row,
    ),
    "priorityclasses": (["NAME", "VALUE", "AGE"], _priorityclass_row),
}


def print_table(resource: str, objs: List[Any], namespace_col: bool = False) -> str:
    headers, row_fn = TABLES.get(resource, (["NAME", "AGE"], _generic_row))
    rows = [row_fn(o) for o in objs]
    if namespace_col:
        headers = ["NAMESPACE"] + headers
        rows = [[o.metadata.namespace] + r for o, r in zip(objs, rows)]
    widths = [
        max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
        for i, h in enumerate(headers)
    ]
    lines = ["   ".join(h.ljust(w) for h, w in zip(headers, widths)).rstrip()]
    for r in rows:
        lines.append("   ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
    return "\n".join(lines)
