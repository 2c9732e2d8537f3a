"""ConfigFactory: watch wiring for the scheduler, and algorithm resolution.

PyTorch counterpart of kubernetes_tpu/scheduler/factory.py
(plugin/pkg/scheduler/factory/factory.go). Informers feed the
SchedulerCache (assigned pods :127-137, nodes :139-148); a reflector
feeds unassigned pods into the FIFO (:339 with the field selectors of
:431-448); auxiliary informers back the service/RC/RS/PV/PVC listers and
the gang director's PodGroup lister; failed pods re-queue through
exponential backoff (:371-377, :600-613); the binder POSTs /bindings
(:537-543), or one batch request a wave; multi-scheduler dispatch
honors the scheduler.alpha.kubernetes.io/name annotation (:404).

ConfigFactory takes `device` (the card unless the caller asks for the
CPU): a provider's algorithm factory and a device-expressible Policy
build TorchScheduleAlgorithm(device=..., cache=...) where the JAX
factory builds TPUScheduleAlgorithm, and the gang director scores its
victims there. Its methods that hold no device are verbatim copies of
the JAX factory's (tests/test_torch_isolation.py FUNCTION_COPIES);
__init__, create_from_config, create_from_keys and _make_config are
recorded deviations (DEVIATIONS).

The module-level create_from_provider and create_from_config resolve a
provider name or a Policy to the algorithm alone, with default plugin
arguments and no informers, for the scheduler-extender service
(scheduler/extender_server.py), which schedules the snapshots its
callers send and watches no apiserver.

A Policy that resolve_policy_tpu maps onto the device config runs on
TorchScheduleAlgorithm(config=...). A Policy that needs the host path
(custom names, no resource predicate, extenders, or `provider:
DefaultProvider`) runs on core.ExtendedGenericScheduler with
resolve_policy's predicates and priorities and an HTTPExtender for each
of the Policy's extenders, as the JAX factory does.

node_schedulable is a verbatim copy of the JAX factory's; the
incremental encoder (snapshot/incremental.py) imports it from here.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.client.cache.fifo import FIFO
from kubernetes_tpu_torch.client.cache.listers import (
    StoreToControllerLister,
    StoreToNodeLister,
    StoreToPodLister,
    StoreToReplicaSetLister,
    StoreToServiceLister,
)
from kubernetes_tpu_torch.client.cache.reflector import Reflector
from kubernetes_tpu_torch.client.informer import Informer, ResourceEventHandler
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.oracle.scheduler import GenericScheduler
from kubernetes_tpu_torch.scheduler import algorithmprovider, plugins
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm
from kubernetes_tpu_torch.scheduler.cache import SchedulerCache
from kubernetes_tpu_torch.scheduler.core import (
    ExtendedGenericScheduler,
    Scheduler,
    SchedulerConfig,
)
from kubernetes_tpu_torch.scheduler.extender import HTTPExtender
from kubernetes_tpu_torch.scheduler.policy import (
    Policy,
    resolve_policy,
    resolve_policy_tpu,
)
from kubernetes_tpu_torch.utils.flowcontrol import Backoff

log = logging.getLogger(__name__)

SCHEDULER_ANNOTATION_KEY = "scheduler.alpha.kubernetes.io/name"
DEFAULT_SCHEDULER_NAME = "default-scheduler"


def create_from_provider(provider_name: str, device="cuda"):
    """factory.go:255 CreateFromProvider: the registered provider's
    algorithm factory on `device` (TPUProvider, CUDAProvider), or the
    host scheduler from its keys (DefaultProvider). The plugin factory
    arguments are the defaults, with no scheduler cache and no listers:
    ConfigFactory.create_from_provider is the daemon's form."""
    args = plugins.PluginFactoryArgs()
    provider = plugins.get_algorithm_provider(provider_name)
    if provider.algorithm_factory is not None:
        return provider.algorithm_factory(args, device=device)
    # factory.go:301 CreateFromKeys without an algorithm factory
    predicates = plugins.get_fit_predicate_functions(
        list(provider.fit_predicate_keys), args)
    priorities = plugins.get_priority_function_configs(
        list(provider.priority_keys), args)
    return GenericScheduler(predicates=list(predicates.items()),
                            priorities=priorities)


def create_from_config(policy: Policy, device="cuda"):
    """factory.go:266 CreateFromConfig (Policy JSON): a device-expressible
    policy -> TorchScheduleAlgorithm(config=...) on `device`; host-only
    entries, extenders and the `provider: DefaultProvider` escape hatch
    -> the host ExtendedGenericScheduler with the Policy's extenders."""
    args = plugins.PluginFactoryArgs()
    if policy.provider and not (policy.predicates or policy.priorities):
        return create_from_provider(policy.provider, device=device)
    if policy.provider != algorithmprovider.DEFAULT_PROVIDER_NAME:
        device_cfg = resolve_policy_tpu(policy,
                                        args.hard_pod_affinity_weight)
        if device_cfg is not None:
            return TorchScheduleAlgorithm(device=device, config=device_cfg)
    predicates, priorities = resolve_policy(policy, args)
    return ExtendedGenericScheduler(
        list(predicates.items()), priorities,
        [HTTPExtender(e) for e in policy.extenders])


class ConfigFactory:
    """factory.go:55 ConfigFactory."""

    def __init__(
        self,
        client: RESTClient,
        scheduler_name: str = DEFAULT_SCHEDULER_NAME,
        hard_pod_affinity_weight: int = 1,
        failure_domains: Optional[List[str]] = None,
        cache_ttl: float = 30.0,
        throughput_matrix: Optional[dict] = None,
        accel_label_key: str = "accelerator",
        device="cuda",
    ):
        """throughput_matrix: the Gavel-style per-accelerator-type
        normalized-throughput table {workload_class: {accel_type:
        throughput}} feeding the gang director's placement score term;
        node types come from the ``accel_label_key`` node label.

        Deviation from kubernetes_tpu/scheduler/factory.py
        ConfigFactory.__init__: it takes `device` ("cuda" unless the
        caller asks for the CPU), the torch device of the algorithms and
        of the gang director's victim scorer that it builds."""
        self.device = device
        self.client = client
        self.scheduler_name = scheduler_name
        self.hard_pod_affinity_weight = hard_pod_affinity_weight
        self.failure_domains = failure_domains or []
        self.throughput_matrix = throughput_matrix
        self.accel_label_key = accel_label_key
        self.scheduler_cache = SchedulerCache(ttl=cache_ttl).run()
        # named: the pod backlog renders as workqueue_depth{name=
        # "scheduler-pods"} beside the controller queues at /metrics
        self.pod_queue = FIFO(name="scheduler-pods")
        self.pod_backoff = Backoff(initial=1.0, max_duration=60.0)
        self._stopped = False
        self._components: list = []

        # assigned (non-terminal) pods -> cache (factory.go:127-137).
        # direct mode: during a density burst this informer ingests one
        # confirmation per bound pod; the handlers (cache confirm, store
        # put) are quick and thread-safe, and the DeltaFIFO hop measured
        # ~2x their cost.
        self.assigned_informer = Informer(
            client.resource("pods", namespace=""),
            ResourceEventHandler(
                on_add=self._cache_add_pod,
                on_update=self._cache_update_pod,
                on_delete=self._cache_delete_pod,
            ),
            field_selector="spec.nodeName!=",
            name="assigned-pods",
            direct=True,
        )
        # nodes -> cache (factory.go:139-148)
        self.node_informer = Informer(
            client.nodes(),
            ResourceEventHandler(
                on_add=self.scheduler_cache.add_node,
                on_update=self.scheduler_cache.update_node,
                on_delete=self.scheduler_cache.remove_node,
            ),
            name="nodes",
            direct=True,
        )
        # unassigned pods -> FIFO (factory.go:339, selector :431-440)
        self.unassigned_reflector = Reflector(
            client.resource("pods", namespace=""),
            _ResponsibleFIFO(self.pod_queue, scheduler_name),
            field_selector="spec.nodeName==",
            name="unassigned-pods",
        )
        # auxiliary listers (factory.go:349-365)
        self.service_informer = Informer(
            client.resource("services", ""), name="services", direct=True
        )
        self.controller_informer = Informer(
            client.resource("replicationcontrollers", ""), name="rcs",
            direct=True,
        )
        self.replica_set_informer = Informer(
            client.resource("replicasets", ""), name="rss", direct=True
        )
        self.pv_informer = Informer(
            client.resource("persistentvolumes"), name="pvs", direct=True
        )
        self.pvc_informer = Informer(
            client.resource("persistentvolumeclaims", ""), name="pvcs",
            direct=True,
        )
        # PodGroups -> the gang director (all-or-nothing spans,
        # priority tiers, quota-scoped workloads)
        self.podgroup_informer = Informer(
            client.resource("podgroups", ""), name="podgroups",
            direct=True,
        )
        self._components = [
            self.assigned_informer,
            self.node_informer,
            self.service_informer,
            self.controller_informer,
            self.replica_set_informer,
            self.pv_informer,
            self.pvc_informer,
            self.podgroup_informer,
        ]

        self.node_lister = StoreToNodeLister(
            self.node_informer.store, predicate=node_schedulable
        )
        self.pod_lister = StoreToPodLister(self.assigned_informer.store)
        self.service_lister = StoreToServiceLister(self.service_informer.store)
        self.controller_lister = StoreToControllerLister(
            self.controller_informer.store
        )
        self.replica_set_lister = StoreToReplicaSetLister(
            self.replica_set_informer.store
        )

    # -- cache handlers (only pods of schedulable interest) ------------------

    def _cache_add_pod(self, pod: Pod) -> None:
        try:
            self.scheduler_cache.add_pod(pod)
        except Exception:
            log.debug("cache add_pod", exc_info=True)

    def _cache_update_pod(self, old: Pod, new: Pod) -> None:
        try:
            self.scheduler_cache.update_pod(old, new)
        except Exception:
            log.debug("cache update_pod", exc_info=True)

    def _cache_delete_pod(self, pod: Pod) -> None:
        try:
            self.scheduler_cache.remove_pod(pod)
        except Exception:
            log.debug("cache remove_pod", exc_info=True)

    # -- assembly ------------------------------------------------------------

    def run_components(self) -> None:
        for c in self._components:
            c.run()
        self.unassigned_reflector.run()
        for c in self._components:
            c.wait_for_sync()

    def stop(self) -> None:
        self._stopped = True
        self.pod_queue.close()
        for c in self._components:
            c.stop()
        self.unassigned_reflector.stop()
        self.scheduler_cache.stop()

    def plugin_args(self) -> plugins.PluginFactoryArgs:
        return plugins.PluginFactoryArgs(
            pod_lister=self.pod_lister,
            service_lister=self.service_lister,
            controller_lister=self.controller_lister,
            replica_set_lister=self.replica_set_lister,
            node_lister=self.node_lister,
            hard_pod_affinity_weight=self.hard_pod_affinity_weight,
            failure_domains=self.failure_domains,
            scheduler_cache=self.scheduler_cache,
        )

    def create_from_provider(self, provider_name: str) -> SchedulerConfig:
        """factory.go:255 CreateFromProvider."""
        provider = plugins.get_algorithm_provider(provider_name)
        return self.create_from_keys(
            provider.fit_predicate_keys,
            provider.priority_keys,
            algorithm_factory=provider.algorithm_factory,
        )

    def create_from_config(self, policy: Policy) -> SchedulerConfig:
        """factory.go:266 CreateFromConfig (Policy JSON).

        A fully device-expressible policy resolves onto the TPU program
        (resolve_policy_tpu) so --policy-config-file users keep the
        batched path; extender-bearing or custom entries — and an
        explicit provider: DefaultProvider escape hatch — run the host
        GenericScheduler.

        Deviation from kubernetes_tpu/scheduler/factory.py
        ConfigFactory.create_from_config: the device end is
        TorchScheduleAlgorithm on the factory's torch device, the
        port's algorithm, where the JAX factory builds
        TPUScheduleAlgorithm."""
        if policy.provider and not (policy.predicates or policy.priorities):
            return self.create_from_provider(policy.provider)
        args = self.plugin_args()
        if policy.provider != "DefaultProvider":
            device_cfg = resolve_policy_tpu(
                policy, args.hard_pod_affinity_weight
            )
            if device_cfg is not None:
                algorithm = TorchScheduleAlgorithm(
                    device=self.device,
                    cache=self.scheduler_cache,
                    service_lister=self.service_lister,
                    controller_lister=self.controller_lister,
                    replica_set_lister=self.replica_set_lister,
                    config=device_cfg,
                )
                return self._make_config(algorithm)
        predicates, priorities = resolve_policy(policy, args)
        extenders = [HTTPExtender(e) for e in policy.extenders]
        algorithm = ExtendedGenericScheduler(
            list(predicates.items()), priorities, extenders
        )
        return self._make_config(algorithm)

    def create_from_keys(
        self, predicate_keys, priority_keys, algorithm_factory=None
    ) -> SchedulerConfig:
        """factory.go:301 CreateFromKeys.

        Deviation from kubernetes_tpu/scheduler/factory.py
        ConfigFactory.create_from_keys: a provider's algorithm factory
        takes the factory's torch device, the registry's signature in
        the port (scheduler/algorithmprovider.py
        _tpu_algorithm_factory)."""
        args = self.plugin_args()
        if algorithm_factory is not None:
            algorithm = algorithm_factory(args, device=self.device)
        else:
            predicates = plugins.get_fit_predicate_functions(
                list(predicate_keys), args
            )
            priorities = plugins.get_priority_function_configs(
                list(priority_keys), args
            )
            algorithm = ExtendedGenericScheduler(
                list(predicates.items()), priorities
            )
        return self._make_config(algorithm)

    def _make_config(self, algorithm) -> SchedulerConfig:
        """Deviation from kubernetes_tpu/scheduler/factory.py
        ConfigFactory._make_config: the gang director takes the
        factory's torch device, since the port's director scores its
        victims on a torch device (scheduler/gang.py GangDirector)."""
        from kubernetes_tpu_torch.scheduler.gang import GangDirector

        director = GangDirector(
            pod_group_lister=self.podgroup_informer.store.list,
            status_updater=self._update_podgroup_status,
            preemptor=self._preempt_many,
            throughput=self.throughput_matrix,
            accel_label_key=self.accel_label_key,
            device=self.device,
        )
        return SchedulerConfig(
            scheduler_cache=self.scheduler_cache,
            algorithm=algorithm,
            binder=self._bind,
            binder_many=self._bind_many,
            pod_condition_updater=self._update_pod_condition,
            pod_condition_updater_many=self._update_pod_conditions_many,
            next_pod=self._next_pod,
            drain_waiting=self._drain_waiting,
            error=self._make_error_handler(),
            snapshot_extras=self._snapshot_extras,
            node_lister=self.node_lister,
            gang_director=director,
        )

    def create_scheduler(self, config: SchedulerConfig) -> Scheduler:
        return Scheduler(config)

    # -- config closures -----------------------------------------------------

    def _snapshot_extras(self) -> dict:
        return {
            "services": self.service_lister.list(),
            "controllers": self.controller_lister.list(),
            "replica_sets": self.replica_set_lister.list(),
            "pvs": self.pv_informer.store.list(),
            "pvcs": self.pvc_informer.store.list(),
        }

    def _next_pod(self) -> Optional[Pod]:
        """factory.go:394 getNextPod: blocking FIFO pop."""
        from kubernetes_tpu_torch.client.cache.fifo import ShutDown

        while True:
            try:
                pod = self.pod_queue.pop()
            except ShutDown:
                return None
            return pod

    def _drain_waiting(self, limit: int) -> List[Pod]:
        """Non-blocking drain for TPU wave scheduling."""
        out: List[Pod] = []
        while len(out) < limit:
            try:
                out.append(self.pod_queue.pop(timeout=0))
            except Exception:
                break
        return out

    def _bind(self, pod: Pod, host: str) -> None:
        """factory.go:532 binder — POST pods/<name>/binding."""
        self.client.pods(pod.metadata.namespace).bind(
            pod.metadata.name, host, pod.metadata.namespace
        )

    def _bind_many(self, pairs) -> list:
        """Bulk binder for wave commits: [(pod, host)] -> per-item
        results. One batch request — one store transaction — replaces a
        wave's worth of per-pod round-trips."""
        from kubernetes_tpu_torch.client.rest import batch_bind_item

        return self.client.commit_batch(
            batch_bind_item(p.metadata.name, host,
                            p.metadata.namespace or "default")
            for p, host in pairs
        )

    def _update_pod_conditions_many(self, updates) -> list:
        """Batch PodScheduled-condition updates: [(pod, status, reason)]
        in ONE batch request (a wave with many unschedulable pods used
        to issue one PATCH per pod — O(backlog) apiserver requests)."""
        from kubernetes_tpu_torch.client.rest import batch_status_item

        return self.client.commit_batch(
            batch_status_item(
                "pods", p.metadata.name,
                {"conditions": [{
                    "type": "PodScheduled",
                    "status": status,
                    "reason": reason,
                }]},
                p.metadata.namespace or "default",
            )
            for p, status, reason in updates
        )

    def _update_podgroup_status(self, namespace: str, name: str,
                                status: dict) -> None:
        """PATCH podgroups/{name}/status — why a gang is parked, how
        many members are bound (what kubectl describe surfaces)."""
        self.client.resource("podgroups", namespace).patch(
            name, {"status": status}, subresource="status",
        )

    def _preempt_many(self, victims) -> list:
        """Evict preemption victims through the batch door: one
        request, one store transaction, one watch burst — the same
        amortization path the wave binder rides."""
        from kubernetes_tpu_torch.client.rest import batch_delete_item

        return self.client.commit_batch(
            batch_delete_item("pods", v.metadata.name,
                              v.metadata.namespace or "default")
            for v in victims
        )

    def _update_pod_condition(self, pod: Pod, status: str, reason: str) -> None:
        """factory.go:545 podConditionUpdater — PodScheduled condition."""
        self.client.pods(pod.metadata.namespace).patch(
            pod.metadata.name,
            {
                "status": {
                    "conditions": [
                        {
                            "type": "PodScheduled",
                            "status": status,
                            "reason": reason,
                        }
                    ]
                }
            },
            subresource="status",
        )

    def _make_error_handler(self):
        """factory.go:476-512: async re-queue with per-pod backoff."""

        def handle(pod: Pod, err: Exception) -> None:
            if self._stopped:
                return

            def requeue() -> None:
                key = f"{pod.metadata.namespace}/{pod.metadata.name}"
                delay = self.pod_backoff.next_(key)
                threading.Event().wait(delay)
                if self._stopped:
                    return
                try:
                    fresh = self.client.pods(pod.metadata.namespace).get(
                        pod.metadata.name
                    )
                    if not fresh.spec.node_name:
                        self.pod_queue.add(fresh)
                except Exception:
                    pass  # deleted; drop

            threading.Thread(target=requeue, daemon=True).start()

        return handle


class _ResponsibleFIFO:
    """Store adapter filtering FIFO adds by the multi-scheduler
    annotation (factory.go:404 responsibleForPod)."""

    def __init__(self, fifo: FIFO, scheduler_name: str):
        self.fifo = fifo
        self.scheduler_name = scheduler_name

    def _responsible(self, pod: Pod) -> bool:
        want = pod.metadata.annotations.get(SCHEDULER_ANNOTATION_KEY, "")
        if self.scheduler_name == DEFAULT_SCHEDULER_NAME:
            return want in ("", DEFAULT_SCHEDULER_NAME)
        return want == self.scheduler_name

    def add(self, pod: Pod) -> None:
        if self._responsible(pod):
            self.fifo.add(pod)

    def update(self, pod: Pod) -> None:
        if self._responsible(pod):
            self.fifo.update(pod)

    def delete(self, pod: Pod) -> None:
        self.fifo.delete(pod)

    def replace(self, pods) -> None:
        self.fifo.replace([p for p in pods if self._responsible(p)])

    def list(self):
        return self.fifo.list()


def node_schedulable(node) -> bool:
    """factory.go:412 getNodeConditionPredicate: Ready and not OutOfDisk
    and not spec.unschedulable."""
    if node.spec and getattr(node.spec, "unschedulable", False):
        return False
    for cond in node.status.conditions:
        if cond.type == "Ready" and cond.status != "True":
            return False
        if cond.type == "OutOfDisk" and cond.status == "True":
            return False
    return True
