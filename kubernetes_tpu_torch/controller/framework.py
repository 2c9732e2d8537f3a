"""Shared controller machinery (pkg/controller/controller_utils.go).

- SharedInformerFactory: one informer per resource, shared by every loop
  (the reference's shared pod/node informers, controllermanager.go:198).
- ControllerExpectations: the create/delete accounting that keeps a
  controller from re-issuing a burst while its watch lags
  (controller_utils.go:61-207).
- PodControl: create/delete pods from a template on behalf of a
  controller (controller_utils.go:289-388), stamping the v1.3-era
  `created-by` annotation.
- active_pods ordering for scale-down victim selection
  (controller_utils.go:401-426 ActivePods sort).

Copy of kubernetes_tpu/controller/framework.py: only the import package differs.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.api import labels as labelpkg
from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.informer import Informer, ResourceEventHandler
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.utils.workqueue import RateLimitingQueue, ShutDown

CREATED_BY_ANNOTATION = "kubernetes.io/created-by"

# controller_utils.go:47 ExpectationsTimeout
EXPECTATIONS_TIMEOUT = 5 * 60.0


class SharedInformerFactory:
    """One Informer per resource name, started together."""

    def __init__(self, client: RESTClient):
        self.client = client
        self._informers: Dict[str, Informer] = {}
        self._started = False
        self._lock = threading.Lock()

    def informer(self, resource: str) -> Informer:
        with self._lock:
            inf = self._informers.get(resource)
            if inf is None:
                inf = Informer(
                    self.client.resource(resource), name=f"shared-{resource}"
                )
                self._informers[resource] = inf
                if self._started:
                    inf.run()
            return inf

    def pods(self) -> Informer:
        return self.informer("pods")

    def nodes(self) -> Informer:
        return self.informer("nodes")

    def namespaces(self) -> Informer:
        return self.informer("namespaces")

    def service_accounts(self) -> Informer:
        return self.informer("serviceaccounts")

    def secrets(self) -> Informer:
        return self.informer("secrets")

    def start(self) -> "SharedInformerFactory":
        with self._lock:
            self._started = True
            for inf in self._informers.values():
                inf.run()
        return self

    def wait_for_sync(self, timeout: float = 10.0) -> bool:
        return all(i.wait_for_sync(timeout) for i in self._informers.values())

    def stop(self) -> None:
        with self._lock:
            for inf in self._informers.values():
                inf.stop()
            self._started = False


class ControllerExpectations:
    """controller_utils.go:61 — per-key (adds, dels) the controller still
    expects to observe; SatisfiedExpectations gates a new sync burst."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._lock = threading.Lock()
        self._by_key: Dict[str, List[float]] = {}  # key -> [adds, dels, ts]
        self._clock = clock

    def satisfied(self, key: str) -> bool:
        with self._lock:
            e = self._by_key.get(key)
            if e is None:
                return True
            adds, dels, ts = e
            if adds <= 0 and dels <= 0:
                return True
            if self._clock() - ts > EXPECTATIONS_TIMEOUT:
                return True  # expired: sync anyway (controller_utils.go:124)
            return False

    def set_expectations(self, key: str, adds: int, dels: int) -> None:
        """controller_utils.go SetExpectations: adds and dels together —
        a sync that both creates and deletes must not overwrite one side
        with zero (that would allow a premature follow-up burst)."""
        with self._lock:
            self._by_key[key] = [adds, dels, self._clock()]

    def expect_creations(self, key: str, count: int) -> None:
        self.set_expectations(key, count, 0)

    def expect_deletions(self, key: str, count: int) -> None:
        self.set_expectations(key, 0, count)

    def creation_observed(self, key: str) -> None:
        self._lower(key, 0)

    def deletion_observed(self, key: str) -> None:
        self._lower(key, 1)

    def _lower(self, key: str, idx: int) -> None:
        with self._lock:
            e = self._by_key.get(key)
            if e is not None:
                e[idx] -= 1

    def delete_expectations(self, key: str) -> None:
        with self._lock:
            self._by_key.pop(key, None)


def filter_active_pods(pods) -> List[t.Pod]:
    """controller_utils.go:392 FilterActivePods: not Succeeded/Failed and
    not pending deletion."""
    return [
        p
        for p in pods
        if p.status.phase not in ("Succeeded", "Failed")
        and p.metadata.deletion_timestamp is None
    ]


def _pod_ready(pod: t.Pod) -> bool:
    return any(
        c.type == "Ready" and c.status == "True" for c in pod.status.conditions
    )


def active_pods(pods: List[t.Pod]) -> List[t.Pod]:
    """controller_utils.go:401 ActivePods sort: earlier entries are better
    scale-down victims — unassigned before assigned, Pending before
    Unknown before Running, not-ready before ready, newer before older."""
    phase_rank = {"Pending": 0, "Unknown": 1, "Running": 2}

    def rank(p: t.Pod):
        return (
            0 if not p.spec.node_name else 1,
            phase_rank.get(p.status.phase, 2),
            1 if _pod_ready(p) else 0,
            # newer (greater timestamp) first among equals
            tuple(-ord(c) for c in (p.metadata.creation_timestamp or "")),
        )

    return sorted(pods, key=rank)


class PodControl:
    """controller_utils.go:289 RealPodControl."""

    def __init__(self, client: RESTClient, recorder=None):
        self.client = client
        self.recorder = recorder

    def create_pods(
        self, namespace: str, template: t.PodTemplateSpec, controller, kind: str
    ) -> t.Pod:
        pod = t.Pod(
            metadata=t.ObjectMeta(
                generate_name=f"{controller.metadata.name}-",
                namespace=namespace,
                labels=dict(template.metadata.labels),
                annotations={
                    **dict(template.metadata.annotations),
                    CREATED_BY_ANNOTATION: (
                        f"{kind}/{controller.metadata.namespace}"
                        f"/{controller.metadata.name}"
                    ),
                },
            ),
            spec=copy.deepcopy(template.spec),
        )
        created = self.client.pods(namespace).create(pod)
        if self.recorder is not None:
            self.recorder.eventf(
                controller, "Normal", "SuccessfulCreate",
                f"Created pod: {created.metadata.name}",
            )
        return created

    def delete_pod(self, namespace: str, name: str, controller=None) -> None:
        self.client.pods(namespace).delete(name)
        if self.recorder is not None and controller is not None:
            self.recorder.eventf(
                controller, "Normal", "SuccessfulDelete", f"Deleted pod: {name}"
            )


class PeriodicRunner:
    """Shared periodic-loop harness (the wait.Until idiom): subclasses set
    SYNC_PERIOD or pass a period to run(); sync_once() does one pass and
    exceptions are contained per pass."""

    SYNC_PERIOD = 10.0
    THREAD_NAME = "periodic"

    def sync_once(self) -> object:
        raise NotImplementedError

    def run(self, period: Optional[float] = None):
        self._stop_event = threading.Event()
        period = self.SYNC_PERIOD if period is None else period

        def loop():
            while not self._stop_event.wait(period):
                try:
                    self.sync_once()
                except Exception:
                    pass

        self._thread = threading.Thread(
            target=loop, name=self.THREAD_NAME, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if hasattr(self, "_stop_event"):
            self._stop_event.set()


class QueueWorker:
    """The informer->workqueue->sync-worker skeleton every controller
    shares (replication_controller.go Run/worker/processNextWorkItem)."""

    def __init__(self, name: str, sync_fn: Callable[[str], None], workers: int = 1):
        self.name = name
        # the queue carries the controller's name so its depth/latency
        # shows up per-loop at /metrics (workqueue_* families) — the
        # "which control loop is falling behind" signal
        self.queue = RateLimitingQueue(name=name)
        self._sync = sync_fn
        self._workers = workers
        self._threads: List[threading.Thread] = []

    def enqueue(self, key: str) -> None:
        self.queue.add(key)

    def enqueue_after(self, key: str, delay: float) -> None:
        self.queue.add_after(key, delay)

    def run(self) -> "QueueWorker":
        for i in range(self._workers):
            th = threading.Thread(
                target=self._work, name=f"{self.name}-{i}", daemon=True
            )
            th.start()
            self._threads.append(th)
        return self

    def _work(self) -> None:
        while True:
            try:
                key = self.queue.get()
            except ShutDown:
                return
            try:
                self._sync(key)
                self.queue.forget(key)
            except Exception:
                # error -> rate-limited requeue (processNextWorkItem idiom)
                self.queue.add_rate_limited(key)
            finally:
                self.queue.done(key)

    def stop(self) -> None:
        self.queue.shut_down()


def selector_matches(selector: Dict[str, str], pod: t.Pod) -> bool:
    """Map selector as in listers.go (empty selector matches nothing for
    controllers — an RC with no selector manages nothing)."""
    if not selector:
        return False
    return labelpkg.selector_from_set(selector).matches(pod.metadata.labels)


def label_selector_matches(selector: Optional[t.LabelSelector], pod: t.Pod) -> bool:
    from kubernetes_tpu_torch.oracle.predicates import label_selector_as_selector

    if selector is None:
        return False
    return label_selector_as_selector(selector).matches(pod.metadata.labels)
