"""Algorithm resolution: a provider name or a Policy -> a ScheduleAlgorithm.

The two resolution paths of kubernetes_tpu/scheduler/factory.py
ConfigFactory (factory.go:255 CreateFromProvider, :266
CreateFromConfig), as functions of the port's own: create_from_provider
is the counterpart of ConfigFactory.create_from_provider (factory.py:212)
and create_from_config of ConfigFactory.create_from_config
(factory.py:221). They return the algorithm itself: the
scheduling loop that runs it (core.Scheduler over a core.SchedulerConfig)
is ported, but the informers, the FIFO, the binder and the gang
director's informer wiring that ConfigFactory wraps around it come with
a later slice (ROADMAP.md queue 1 item 2b); harness/scenarios.py builds
a SchedulerConfig from plain callables meanwhile.

A Policy that resolve_policy_tpu maps onto the device config runs on
TorchScheduleAlgorithm(config=...), on `device` (the card unless the
caller asks for the CPU). A Policy that needs the host path (custom
names, no resource predicate, extenders, or `provider: DefaultProvider`)
runs on core.ExtendedGenericScheduler with resolve_policy's predicates
and priorities and an HTTPExtender for each of the Policy's extenders,
as the JAX factory does.

node_schedulable is a verbatim copy of the JAX factory's
(tests/test_torch_isolation.py FUNCTION_COPIES); the incremental
encoder (snapshot/incremental.py) imports it from here.
"""

from __future__ import annotations

from kubernetes_tpu_torch.oracle.scheduler import GenericScheduler
from kubernetes_tpu_torch.scheduler import algorithmprovider, plugins
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm
from kubernetes_tpu_torch.scheduler.core import ExtendedGenericScheduler
from kubernetes_tpu_torch.scheduler.extender import HTTPExtender
from kubernetes_tpu_torch.scheduler.policy import (
    Policy,
    resolve_policy,
    resolve_policy_tpu,
)


def create_from_provider(provider_name: str, device="cuda"):
    """factory.go:255 CreateFromProvider: the registered provider's
    algorithm factory on `device` (TPUProvider, CUDAProvider), or the
    host scheduler from its keys (DefaultProvider). The plugin factory
    arguments are the defaults: the daemon's flags that set them come
    with the daemon slice."""
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
