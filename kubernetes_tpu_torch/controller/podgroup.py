"""PodGroup status reconciliation (the scheduler-down drift healer).

The gang scheduler updates PodGroup.status as it plans waves, and the
quota admission door computes usage live from non-terminal pods — but
nothing reconciled the RECORDED status against pod lifecycle drift:
members finish (Succeeded/Failed) or get deleted while the scheduler is
down, and `kubectl describe podgroup` keeps reporting a fully
Scheduled gang whose quota appears consumed. This controller closes
that loop, reference-controller style: a periodic pass recomputes each
group's membership from the live pod store (active members, bound
members, terminal transitions) and PATCHes the status subresource only
when it drifted.

Reconciled fields:
  * ``members``    — active (non-terminal) labeled pods,
  * ``scheduled``  — active members bound to a node,
  * ``phase``      — ``Scheduled`` when every active member is bound
    and minMember holds; a stale ``Scheduled``/``Scheduling`` whose
    membership fell below minMember (drift) downgrades to ``Pending``.
    Scheduler-owned parking phases (``Parked``/``Preempting``) are left
    alone unless the gang has actually re-bound — the scheduler's
    message explains the park, and this loop must not erase it.

Quota reclamation needs no ledger here: admission recounts live pods,
so a Succeeded/Failed transition frees budget the moment it lands in
the store; this controller makes the *recorded* status agree with that
truth while the scheduler is away.

Copy of kubernetes_tpu/controller/podgroup.py: only the import package differs.
"""

from __future__ import annotations

import logging

from kubernetes_tpu_torch.api.types import POD_GROUP_LABEL
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.controller.framework import (
    PeriodicRunner,
    SharedInformerFactory,
)

log = logging.getLogger(__name__)

_TERMINAL = ("Succeeded", "Failed")
#: phases this loop may overwrite; Parked/Preempting stay scheduler-owned
_RECONCILABLE = ("", "Pending", "Scheduling", "Scheduled")


class PodGroupStatusController(PeriodicRunner):
    SYNC_PERIOD = 10.0
    THREAD_NAME = "podgroup-status"

    def __init__(self, client: RESTClient,
                 informers: SharedInformerFactory, recorder=None):
        self.client = client
        self.pg_informer = informers.informer("podgroups")
        self.pod_informer = informers.pods()
        self.recorder = recorder

    def sync_once(self) -> int:
        """One reconciliation pass; returns the number of PodGroups
        patched."""
        pods_by_group = {}
        for p in self.pod_informer.store.list():
            name = (p.metadata.labels or {}).get(POD_GROUP_LABEL, "")
            if name:
                key = (p.metadata.namespace or "default", name)
                pods_by_group.setdefault(key, []).append(p)
        patched = 0
        for pg in self.pg_informer.store.list():
            ns = pg.metadata.namespace or "default"
            key = (ns, pg.metadata.name)
            members = pods_by_group.get(key, [])
            active = [p for p in members
                      if p.status.phase not in _TERMINAL]
            bound = sum(1 for p in active if p.spec.node_name)
            phase = pg.status.phase or "Pending"
            new_phase = phase
            if phase in _RECONCILABLE:
                if active and bound == len(active) \
                        and len(active) >= int(pg.spec.min_member):
                    new_phase = "Scheduled"
                elif phase == "Scheduled" and (
                        len(active) < int(pg.spec.min_member)):
                    # drift: members finished or vanished under a
                    # recorded full gang
                    new_phase = "Pending"
            elif bound and bound == len(active) \
                    and len(active) >= int(pg.spec.min_member):
                # a parked gang that is in fact fully bound (the
                # scheduler died between bind and status write)
                new_phase = "Scheduled"
            drifted = (
                int(pg.status.members) != len(active)
                or int(pg.status.scheduled) != bound
                or new_phase != phase
            )
            if not drifted:
                continue
            status = {
                "members": len(active),
                "scheduled": bound,
                "phase": new_phase,
            }
            if new_phase == "Scheduled":
                status["unschedulable"] = []
                status["message"] = ""
            try:
                self.client.resource("podgroups", ns).patch(
                    pg.metadata.name, {"status": status},
                    subresource="status")
                patched += 1
            except Exception:
                log.debug("podgroup status patch failed for %s/%s",
                          ns, pg.metadata.name, exc_info=True)
        return patched
