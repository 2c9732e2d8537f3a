"""Job controller (pkg/controller/job/jobcontroller.go).

syncJob (:355): count active/succeeded/failed pods matching the job
selector; create up to min(parallelism, completions-succeeded) active
pods; delete excess; mark the job Complete once succeeded >=
completions (or, with nil completions, when any pod succeeds and
active == 0).

Copy of kubernetes_tpu/controller/job.py: only the import package differs.
"""

from __future__ import annotations

from typing import List

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.informer import ResourceEventHandler
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.controller.framework import (
    ControllerExpectations,
    PodControl,
    QueueWorker,
    SharedInformerFactory,
    active_pods,
    label_selector_matches,
)


class JobController:
    def __init__(
        self, client: RESTClient, informers: SharedInformerFactory, recorder=None
    ):
        self.client = client
        self.pod_control = PodControl(client, recorder)
        self.expectations = ControllerExpectations()
        self.pod_informer = informers.pods()
        self.job_informer = informers.informer("jobs")
        self.worker = QueueWorker("job-controller", self._sync)

        self.job_informer.add_event_handler(
            ResourceEventHandler(
                on_add=lambda j: self._enqueue(j),
                on_update=lambda old, new: self._enqueue(new),
                on_delete=lambda j: self.expectations.delete_expectations(
                    self._key(j)
                ),
            )
        )
        self.pod_informer.add_event_handler(
            ResourceEventHandler(
                on_add=self._on_pod_add,
                on_update=lambda old, new: self._on_pod_change(new),
                on_delete=self._on_pod_delete,
            )
        )

    @staticmethod
    def _key(obj) -> str:
        return f"{obj.metadata.namespace}/{obj.metadata.name}"

    def _enqueue(self, job) -> None:
        self.worker.enqueue(self._key(job))

    def _jobs_for_pod(self, pod: t.Pod):
        return [
            j
            for j in self.job_informer.store.list()
            if j.metadata.namespace == pod.metadata.namespace
            and label_selector_matches(j.spec.selector, pod)
        ]

    def _on_pod_add(self, pod: t.Pod) -> None:
        for j in self._jobs_for_pod(pod):
            self.expectations.creation_observed(self._key(j))
            self._enqueue(j)

    def _on_pod_change(self, pod: t.Pod) -> None:
        for j in self._jobs_for_pod(pod):
            self._enqueue(j)

    def _on_pod_delete(self, pod: t.Pod) -> None:
        for j in self._jobs_for_pod(pod):
            self.expectations.deletion_observed(self._key(j))
            self._enqueue(j)

    def _sync(self, key: str) -> None:
        ns, _name = key.split("/", 1)
        job = self.job_informer.store.get_by_key(key)
        if job is None:
            self.expectations.delete_expectations(key)
            return
        if "Complete" in job.status.conditions:
            return
        pods = [
            p
            for p in self.pod_informer.store.list()
            if p.metadata.namespace == ns
            and label_selector_matches(job.spec.selector, p)
        ]
        active = [
            p
            for p in pods
            if p.status.phase not in ("Succeeded", "Failed")
            and p.metadata.deletion_timestamp is None
        ]
        succeeded = sum(1 for p in pods if p.status.phase == "Succeeded")
        failed = sum(1 for p in pods if p.status.phase == "Failed")

        if self.expectations.satisfied(key):
            self._manage(key, job, active, succeeded)

        complete = False
        if job.spec.completions is None:
            complete = succeeded > 0 and not active
        else:
            complete = succeeded >= job.spec.completions
        if complete and "Complete" not in job.status.conditions:
            job.status.conditions.append("Complete")
        job.status.active = len(active)
        job.status.succeeded = succeeded
        job.status.failed = failed
        self.client.resource("jobs", ns).update_status(job)

    def _manage(self, key: str, job, active: List[t.Pod], succeeded: int) -> None:
        """jobcontroller.go:472 manageJob."""
        parallelism = job.spec.parallelism or 1
        if job.spec.completions is None:
            want_active = parallelism if succeeded == 0 else len(active)
        else:
            want_active = min(parallelism, job.spec.completions - succeeded)
        want_active = max(want_active, 0)
        diff = want_active - len(active)
        if diff > 0:
            self.expectations.expect_creations(key, diff)
            for _ in range(diff):
                try:
                    self.pod_control.create_pods(
                        job.metadata.namespace, job.spec.template, job, "Job"
                    )
                except Exception:
                    self.expectations.creation_observed(key)
        elif diff < 0:
            victims = active_pods(active)[: -diff]
            self.expectations.expect_deletions(key, -diff)
            for pod in victims:
                try:
                    self.pod_control.delete_pod(
                        job.metadata.namespace, pod.metadata.name, job
                    )
                except Exception:
                    self.expectations.deletion_observed(key)

    def run(self) -> "JobController":
        self.worker.run()
        return self

    def stop(self) -> None:
        self.worker.stop()
