"""Algorithm resolution: a provider name or a Policy -> a ScheduleAlgorithm.

The two resolution paths of kubernetes_tpu/scheduler/factory.py
ConfigFactory (factory.go:255 CreateFromProvider, :266
CreateFromConfig), as functions of the port's own: create_from_provider
is the counterpart of ConfigFactory.create_from_provider (factory.py:212)
and create_from_config of ConfigFactory.create_from_config
(factory.py:221). They return the algorithm itself:
the informers, the binder and the gang director that ConfigFactory
wraps around it come with the port's scheduler daemon, a later slice.

A Policy that resolve_policy_tpu maps onto the device config runs on
TorchScheduleAlgorithm(config=...), on `device` (the card unless the
caller asks for the CPU). A Policy that needs the host path (custom
names, no resource predicate, or `provider: DefaultProvider`) runs on
the port's oracle GenericScheduler with resolve_policy's predicates and
priorities, as the JAX factory runs ExtendedGenericScheduler. A Policy
with extenders raises: the outbound HTTPExtender and
ExtendedGenericScheduler come with the daemon slice.
"""

from __future__ import annotations

from kubernetes_tpu_torch.oracle.scheduler import GenericScheduler
from kubernetes_tpu_torch.scheduler import algorithmprovider, plugins
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm
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
    entries and the `provider: DefaultProvider` escape hatch -> the
    host GenericScheduler."""
    args = plugins.PluginFactoryArgs()
    if policy.provider and not (policy.predicates or policy.priorities):
        return create_from_provider(policy.provider, device=device)
    if policy.provider != algorithmprovider.DEFAULT_PROVIDER_NAME:
        device_cfg = resolve_policy_tpu(policy,
                                        args.hard_pod_affinity_weight)
        if device_cfg is not None:
            return TorchScheduleAlgorithm(device=device, config=device_cfg)
    if policy.extenders:
        raise NotImplementedError(
            "a Policy with extenders needs the outbound HTTPExtender and "
            "ExtendedGenericScheduler, which come with the port's "
            "scheduler daemon (a later slice)")
    predicates, priorities = resolve_policy(policy, args)
    return GenericScheduler(predicates=list(predicates.items()),
                            priorities=priorities)
