"""Plugin registries: fit predicates, priorities, algorithm providers.

Reference: plugin/pkg/scheduler/factory/plugins.go (global maps :64-66;
RegisterFitPredicate:80, RegisterCustomFitPredicate:96,
RegisterPriorityFunction:144, RegisterAlgorithmProvider:218). This is
the seam where the "tpu" provider plugs in alongside DefaultProvider.

Factories take a PluginFactoryArgs (listers + runtime knobs) and return
the closure, so policy-configured plugins (ServiceAffinity, LabelsPresence)
can bind their arguments at startup exactly like the reference.

Copy of kubernetes_tpu/scheduler/plugins.py: only the import package differs.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Set

from kubernetes_tpu_torch.oracle.scheduler import Predicate, Priority, PriorityConfig


@dataclass
class PluginFactoryArgs:
    """plugins.go:37 PluginFactoryArgs — what plugin factories may use."""

    pod_lister: object = None
    service_lister: object = None
    controller_lister: object = None
    replica_set_lister: object = None
    node_lister: object = None
    pv_lister: object = None
    pvc_lister: object = None
    hard_pod_affinity_weight: int = 1
    failure_domains: Sequence[str] = ()
    # the TPU algorithm factory subscribes its incremental snapshot
    # encoder to cache mutations (snapshot/incremental.py)
    scheduler_cache: object = None


PredicateFactory = Callable[[PluginFactoryArgs], Predicate]
PriorityFactory = Callable[[PluginFactoryArgs], PriorityConfig]


@dataclass
class AlgorithmProvider:
    """plugins.go AlgorithmProviderConfig."""

    fit_predicate_keys: Set[str] = field(default_factory=set)
    priority_keys: Set[str] = field(default_factory=set)
    # optional: a factory producing a full ScheduleAlgorithm (the TPU
    # provider replaces the per-pod loop wholesale; the reference's
    # extension point for that is CreateFromKeys' algorithm assembly)
    algorithm_factory: Optional[Callable] = None


_lock = threading.Lock()
_fit_predicates: Dict[str, PredicateFactory] = {}
_priorities: Dict[str, PriorityFactory] = {}
_providers: Dict[str, AlgorithmProvider] = {}


def register_fit_predicate(name: str, predicate: Predicate) -> str:
    """plugins.go:80 RegisterFitPredicate (fixed function form)."""
    return register_fit_predicate_factory(name, lambda args: predicate)


def register_fit_predicate_factory(name: str, factory: PredicateFactory) -> str:
    with _lock:
        _fit_predicates[name] = factory
    return name


def register_priority_function(
    name: str, function: Priority, weight: int = 1
) -> str:
    return register_priority_factory(
        name, lambda args: PriorityConfig(function, weight, name)
    )


def register_priority_factory(name: str, factory: PriorityFactory) -> str:
    with _lock:
        _priorities[name] = factory
    return name


def register_algorithm_provider(
    name: str,
    predicate_keys: Set[str],
    priority_keys: Set[str],
    algorithm_factory: Optional[Callable] = None,
) -> str:
    """plugins.go:218 RegisterAlgorithmProvider."""
    with _lock:
        _providers[name] = AlgorithmProvider(
            set(predicate_keys), set(priority_keys), algorithm_factory
        )
    return name


def get_algorithm_provider(name: str) -> AlgorithmProvider:
    with _lock:
        if name not in _providers:
            raise KeyError(
                f"plugin {name!r} has not been registered "
                f"(have: {sorted(_providers)})"
            )
        return _providers[name]


def is_fit_predicate_registered(name: str) -> bool:
    with _lock:
        return name in _fit_predicates


def is_priority_registered(name: str) -> bool:
    with _lock:
        return name in _priorities


def get_fit_predicate_functions(
    names: Sequence[str], args: PluginFactoryArgs
) -> Dict[str, Predicate]:
    """plugins.go getFitPredicateFunctions: resolve keys -> closures.
    Returned in registration-table order for deterministic failure
    reasons (documented deviation from Go's random map order)."""
    with _lock:
        out: Dict[str, Predicate] = {}
        for name in names:
            if name not in _fit_predicates:
                raise KeyError(f"invalid predicate name {name!r}")
        for name in _ORDER(names):
            out[name] = _fit_predicates[name](args)
        return out


def _ORDER(names: Sequence[str]) -> Sequence[str]:
    # canonical order = DefaultProvider registration order, then custom
    from kubernetes_tpu_torch.scheduler.algorithmprovider import CANONICAL_PREDICATE_ORDER

    known = [n for n in CANONICAL_PREDICATE_ORDER if n in names]
    rest = sorted(n for n in names if n not in CANONICAL_PREDICATE_ORDER)
    return known + rest


def get_priority_function_configs(
    names: Sequence[str], args: PluginFactoryArgs
) -> list:
    with _lock:
        out = []
        for name in sorted(names):
            if name not in _priorities:
                raise KeyError(f"invalid priority name {name!r}")
            out.append(_priorities[name](args))
        return out


def registered_predicate_names() -> Set[str]:
    with _lock:
        return set(_fit_predicates)


def registered_priority_names() -> Set[str]:
    with _lock:
        return set(_priorities)
