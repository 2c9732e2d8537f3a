"""Deployment controller (pkg/controller/deployment/deployment_controller.go).

A Deployment owns ReplicaSets keyed by pod-template hash
(deployment_util.go GetNewReplicaSet/GetOldReplicaSets): syncDeployment
finds-or-creates the RS for the current template (name
"<deployment>-<hash>", selector extended with the hash label) and
reconciles replica counts:

- Recreate (:rolloutRecreate): scale old RSes to 0, then new RS up.
- RollingUpdate (:rolloutRolling): scale new RS up by maxSurge over
  desired, scale old down so available stays >= desired - maxUnavailable.

Copy of kubernetes_tpu/controller/deployment.py: only the import package differs.
"""

from __future__ import annotations

import copy
import hashlib
import json
from typing import List, Optional, Tuple

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.informer import ResourceEventHandler
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient
from kubernetes_tpu_torch.controller.framework import (
    QueueWorker,
    SharedInformerFactory,
    filter_active_pods,
    label_selector_matches,
)
from kubernetes_tpu_torch.runtime.scheme import Scheme

POD_TEMPLATE_HASH = "pod-template-hash"  # deployment_util.go


def template_hash(template: t.PodTemplateSpec) -> str:
    """deployment_util.go GetPodTemplateSpecHash (fnv over the struct; a
    deterministic digest of the canonical wire form serves the same
    purpose: equal templates hash equal, changed templates differ)."""
    wire = Scheme().encode(template)
    # strip our own hash label so hashing is stable under adoption
    (wire.get("metadata") or {}).get("labels", {}).pop(POD_TEMPLATE_HASH, None)
    return hashlib.sha1(
        json.dumps(wire, sort_keys=True, default=str).encode()
    ).hexdigest()[:10]


class DeploymentController:
    def __init__(
        self, client: RESTClient, informers: SharedInformerFactory, recorder=None
    ):
        self.client = client
        self.recorder = recorder
        self.deploy_informer = informers.informer("deployments")
        self.rs_informer = informers.informer("replicasets")
        self.pod_informer = informers.pods()
        self.worker = QueueWorker("deployment-controller", self._sync)

        self.deploy_informer.add_event_handler(
            ResourceEventHandler(
                on_add=lambda d: self._enqueue(d),
                on_update=lambda old, new: self._enqueue(new),
            )
        )
        self.rs_informer.add_event_handler(
            ResourceEventHandler(
                on_add=self._on_rs_change,
                on_update=lambda old, new: self._on_rs_change(new),
                on_delete=self._on_rs_change,
            )
        )

    @staticmethod
    def _key(obj) -> str:
        return f"{obj.metadata.namespace}/{obj.metadata.name}"

    def _enqueue(self, d) -> None:
        self.worker.enqueue(self._key(d))

    def _on_rs_change(self, rs: t.ReplicaSet) -> None:
        for d in self.deploy_informer.store.list():
            if d.metadata.namespace == rs.metadata.namespace and self._rs_owned(
                d, rs
            ):
                self._enqueue(d)

    @staticmethod
    def _rs_owned(d: t.Deployment, rs: t.ReplicaSet) -> bool:
        from kubernetes_tpu_torch.oracle.predicates import label_selector_as_selector

        if d.spec.selector is None:
            return False
        return label_selector_as_selector(d.spec.selector).matches(
            rs.spec.template.metadata.labels if rs.spec.template else {}
        )

    # -- sync ----------------------------------------------------------------

    def _owned_replicasets(
        self, d: t.Deployment
    ) -> Tuple[Optional[t.ReplicaSet], List[t.ReplicaSet]]:
        """(new_rs, old_rses) split by template hash."""
        want_hash = template_hash(d.spec.template)
        new_rs, old = None, []
        for rs in self.rs_informer.store.list():
            if rs.metadata.namespace != d.metadata.namespace:
                continue
            if not self._rs_owned(d, rs):
                continue
            if rs.spec.template and rs.spec.template.metadata.labels.get(
                POD_TEMPLATE_HASH
            ) == want_hash:
                new_rs = rs
            else:
                old.append(rs)
        return new_rs, old

    def _create_new_rs(self, d: t.Deployment, replicas: int) -> t.ReplicaSet:
        h = template_hash(d.spec.template)
        template = copy.deepcopy(d.spec.template)
        template.metadata.labels = {
            **dict(template.metadata.labels),
            POD_TEMPLATE_HASH: h,
        }
        selector = t.LabelSelector(
            match_labels={
                **dict(
                    d.spec.selector.match_labels if d.spec.selector else {}
                ),
                POD_TEMPLATE_HASH: h,
            }
        )
        rs = t.ReplicaSet(
            metadata=t.ObjectMeta(
                name=f"{d.metadata.name}-{h}", namespace=d.metadata.namespace
            ),
            spec=t.ReplicaSetSpec(
                replicas=replicas, selector=selector, template=template
            ),
        )
        try:
            return self.client.resource("replicasets", d.metadata.namespace).create(
                rs
            )
        except APIStatusError as e:
            if e.code == 409:  # already exists: races with our informer
                return self.client.resource(
                    "replicasets", d.metadata.namespace
                ).get(rs.metadata.name)
            raise

    def _scale_rs(self, rs: t.ReplicaSet, replicas: int) -> None:
        if rs.spec.replicas == replicas:
            return
        # work on the live object: the informer copy may be stale and the
        # apiserver CAS would reject it (deployment_util.go scales through
        # a fresh GET + Update too)
        rsc = self.client.resource("replicasets", rs.metadata.namespace)
        live = rsc.get(rs.metadata.name)
        live.spec.replicas = replicas
        rsc.update(live)
        rs.spec.replicas = replicas

    def _rs_active_pods(self, rs: t.ReplicaSet) -> int:
        return len(
            filter_active_pods(
                p
                for p in self.pod_informer.store.list()
                if p.metadata.namespace == rs.metadata.namespace
                and label_selector_matches(rs.spec.selector, p)
            )
        )

    def _sync(self, key: str) -> None:
        d = self.deploy_informer.store.get_by_key(key)
        if d is None or d.spec.template is None:
            return
        new_rs, old = self._owned_replicasets(d)
        desired = d.spec.replicas
        if new_rs is None:
            new_rs = self._create_new_rs(d, 0 if old else desired)
            # freshly created: informer may lag; use the returned object

        if d.spec.strategy == "Recreate":
            # rolloutRecreate: old down to zero first, then new up
            if any(rs.spec.replicas > 0 for rs in old):
                for rs in old:
                    self._scale_rs(rs, 0)
            elif any(self._rs_active_pods(rs) > 0 for rs in old):
                pass  # wait for old pods to terminate
            else:
                self._scale_rs(new_rs, desired)
        else:
            # rolloutRolling: surge new, drain old keeping availability
            # (deployment_util.go NewRSNewReplicas: the new RS may grow to
            # whatever the surge budget leaves after the old RSes)
            total_old = sum(rs.spec.replicas for rs in old)
            max_total = desired + (d.spec.max_surge if total_old > 0 else 0)
            new_target = min(desired, max_total - total_old)
            if new_rs.spec.replicas < new_target:
                self._scale_rs(new_rs, new_target)
            # scale old down by however many new pods are actually active
            # beyond the unavailability budget
            new_active = self._rs_active_pods(new_rs)
            min_available = desired - d.spec.max_unavailable
            cleanup_budget = max(
                0, (total_old + new_active) - max(min_available, 0)
            )
            cleanup_budget = min(cleanup_budget, total_old)
            for rs in sorted(old, key=lambda r: r.metadata.name):
                if cleanup_budget <= 0:
                    break
                drop = min(rs.spec.replicas, cleanup_budget)
                if drop > 0:
                    self._scale_rs(rs, rs.spec.replicas - drop)
                    cleanup_budget -= drop
            if any(rs.spec.replicas > 0 for rs in old) or new_active < desired:
                # rollout still in progress; re-check shortly
                self.worker.enqueue_after(key, 0.1)

        # status (live fetch for the same staleness reason)
        total = sum(self._rs_active_pods(rs) for rs in old) + self._rs_active_pods(
            new_rs
        )
        dc = self.client.resource("deployments", d.metadata.namespace)
        try:
            live = dc.get(d.metadata.name)
        except APIStatusError:
            return
        live.status.replicas = total
        live.status.updated_replicas = self._rs_active_pods(new_rs)
        live.status.available_replicas = total
        live.status.observed_generation = live.metadata.generation
        dc.update_status(live)

    def run(self) -> "DeploymentController":
        self.worker.run()
        return self

    def stop(self) -> None:
        self.worker.stop()
