"""Scheduler Policy config API + validation.

Reference: plugin/pkg/scheduler/api/types.go (Policy:27,
PredicatePolicy:37 with ServiceAffinity/LabelsPresence args :60-94,
PriorityPolicy:46 with ServiceAntiAffinity/LabelPreference,
ExtenderConfig:114) and api/validation. Config is a declarative,
versioned JSON object loaded via --policy-config-file (server.go:163-177,
examples/scheduler-policy-config.json).

Copy of kubernetes_tpu/scheduler/policy.py: only the import package differs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubernetes_tpu_torch.oracle import predicates as preds
from kubernetes_tpu_torch.oracle import priorities as prios
from kubernetes_tpu_torch.oracle.scheduler import PriorityConfig
from kubernetes_tpu_torch.scheduler import plugins


@dataclass
class ExtenderConfig:
    """api/types.go:114 ExtenderConfig."""

    url_prefix: str = ""
    api_version: str = "v1beta1"
    filter_verb: str = ""
    prioritize_verb: str = ""
    weight: int = 1
    enable_https: bool = False
    http_timeout: float = 5.0  # extender.go:34 DefaultExtenderTimeout


@dataclass
class PredicatePolicy:
    name: str = ""
    # argument forms (api/types.go:60-94)
    service_affinity_labels: Optional[List[str]] = None
    labels_presence: Optional[List[str]] = None
    labels_presence_required: bool = True


@dataclass
class PriorityPolicy:
    name: str = ""
    weight: int = 1
    service_anti_affinity_label: str = ""
    label_preference: str = ""
    label_preference_presence: bool = True


@dataclass
class Policy:
    predicates: List[PredicatePolicy] = field(default_factory=list)
    priorities: List[PriorityPolicy] = field(default_factory=list)
    extenders: List[ExtenderConfig] = field(default_factory=list)
    # extension over the reference: which provider supplies the algorithm
    # (DefaultProvider | TPUProvider) when predicates/priorities are empty
    provider: str = ""


class PolicyValidationError(Exception):
    pass


def validate_policy(policy: Policy) -> None:
    """api/validation/validation.go ValidatePolicy: priority weights must
    be positive."""
    errs = []
    for p in policy.priorities:
        if p.weight <= 0:
            errs.append(f"Priority {p.name}: Weight={p.weight}, must be positive")
    for e in policy.extenders:
        if e.weight <= 0:
            errs.append(f"Extender {e.url_prefix}: Weight must be positive")
        if not e.url_prefix:
            errs.append("Extender: URLPrefix required")
    if errs:
        raise PolicyValidationError("; ".join(errs))


def load_policy(text_or_path: str) -> Policy:
    """Decode a Policy JSON document (the --policy-config-file content)."""
    if text_or_path.lstrip().startswith("{"):
        data = json.loads(text_or_path)
    else:
        with open(text_or_path) as f:
            data = json.load(f)
    policy = Policy(provider=data.get("provider", ""))
    for p in data.get("predicates", []):
        arg = p.get("argument", {}) or {}
        sa = arg.get("serviceAffinity", {}) or {}
        lp = arg.get("labelsPresence", {}) or {}
        policy.predicates.append(
            PredicatePolicy(
                name=p["name"],
                service_affinity_labels=sa.get("labels"),
                labels_presence=lp.get("labels"),
                labels_presence_required=lp.get("presence", True),
            )
        )
    for p in data.get("priorities", []):
        arg = p.get("argument", {}) or {}
        saa = arg.get("serviceAntiAffinity", {}) or {}
        lpref = arg.get("labelPreference", {}) or {}
        policy.priorities.append(
            PriorityPolicy(
                name=p["name"],
                weight=p.get("weight", 1),
                service_anti_affinity_label=saa.get("label", ""),
                label_preference=lpref.get("label", ""),
                label_preference_presence=lpref.get("presence", True),
            )
        )
    for e in data.get("extenders", []):
        policy.extenders.append(
            ExtenderConfig(
                url_prefix=e.get("urlPrefix", ""),
                api_version=e.get("apiVersion", "v1beta1"),
                filter_verb=e.get("filterVerb", ""),
                prioritize_verb=e.get("prioritizeVerb", ""),
                weight=e.get("weight", 1),
                enable_https=e.get("enableHttps", False),
                http_timeout=e.get("httpTimeout", 5.0),
            )
        )
    validate_policy(policy)
    return policy


# Policy names the device program can express directly. Anything else
# (custom-registered predicates, extenders) falls back to the host path.
_DEVICE_PREDICATES = frozenset({
    "GeneralPredicates", "PodFitsResources", "PodFitsHostPorts",
    "PodFitsPorts", "HostName", "MatchNodeSelector",
    "PodToleratesNodeTaints", "CheckNodeMemoryPressure",
    "MatchInterPodAffinity", "NoDiskConflict", "NoVolumeZoneConflict",
    "MaxEBSVolumeCount", "MaxGCEPDVolumeCount",
})
_DEVICE_PRIORITIES = frozenset({
    "LeastRequestedPriority", "BalancedResourceAllocation",
    "SelectorSpreadPriority", "ServiceSpreadingPriority",
    "NodeAffinityPriority", "TaintTolerationPriority",
    "InterPodAffinityPriority", "EqualPriority", "ImageLocalityPriority",
})


def resolve_policy_tpu(policy: Policy, hard_pod_affinity_weight: int = 1):
    """Map a Policy onto the device SchedulerConfig (the TPU end of
    factory.go:266 CreateFromConfig). Every argument form —
    ServiceAffinity, ServiceAntiAffinity, LabelsPresence/LabelPreference —
    compiles to a config-parameterized program entry. Returns None when
    any entry needs the host path (extenders, custom names); the caller
    then falls back to resolve_policy."""
    from kubernetes_tpu_torch.models.batch import (
        NODE_LABEL_PREDICATE,
        NODE_LABEL_PRIORITY,
        SELECTOR_SPREAD,
        SERVICE_AFFINITY,
        SERVICE_ANTI_AFFINITY,
        SchedulerConfig as DeviceConfig,
    )
    from kubernetes_tpu_torch.scheduler.algorithmprovider import _max_pd_vols

    if policy.extenders:
        return None
    # the device programs mask padding dummy nodes (and the incremental
    # encoder's freed slots) through zeroed allocatable, which only bites
    # when the resource predicate is active — a policy without one runs
    # on the host path
    names = {p.name for p in policy.predicates}
    if not names & {"GeneralPredicates", "PodFitsResources"}:
        return None
    pred_out = []
    for p in policy.predicates:
        if p.service_affinity_labels is not None:
            pred_out.append(
                (SERVICE_AFFINITY, tuple(p.service_affinity_labels))
            )
        elif p.labels_presence is not None:
            pred_out.append(
                (NODE_LABEL_PREDICATE, tuple(p.labels_presence),
                 p.labels_presence_required)
            )
        elif p.name in _DEVICE_PREDICATES:
            pred_out.append(p.name)
        else:
            return None
    prio_out = []
    for p in policy.priorities:
        if p.service_anti_affinity_label:
            prio_out.append(
                ((SERVICE_ANTI_AFFINITY, p.service_anti_affinity_label),
                 p.weight)
            )
        elif p.label_preference:
            prio_out.append(
                ((NODE_LABEL_PRIORITY, p.label_preference,
                  p.label_preference_presence), p.weight)
            )
        elif p.name == "ServiceSpreadingPriority":
            # legacy alias of the spreading scorer (defaults.go:66)
            prio_out.append((SELECTOR_SPREAD, p.weight))
        elif p.name in _DEVICE_PRIORITIES:
            prio_out.append((p.name, p.weight))
        else:
            return None
    from kubernetes_tpu_torch.oracle import predicates as opreds

    return DeviceConfig(
        predicates=tuple(pred_out),
        priorities=tuple(prio_out),
        hard_pod_affinity_weight=hard_pod_affinity_weight,
        max_ebs_volumes=_max_pd_vols(opreds.DEFAULT_MAX_EBS_VOLUMES),
        max_gce_pd_volumes=_max_pd_vols(opreds.DEFAULT_MAX_GCE_PD_VOLUMES),
    )


def resolve_policy(policy: Policy, args: plugins.PluginFactoryArgs):
    """CreateFromConfig (factory.go:266): register custom predicate/
    priority argument forms, then resolve keys -> closures.
    -> (predicates ordered dict, priority configs)."""
    pred_keys = []
    for p in policy.predicates:
        if p.service_affinity_labels is not None:
            plugins.register_fit_predicate(
                p.name,
                preds.service_affinity_predicate(p.service_affinity_labels),
            )
        elif p.labels_presence is not None:
            plugins.register_fit_predicate(
                p.name,
                preds.node_label_predicate(
                    p.labels_presence, p.labels_presence_required
                ),
            )
        elif not plugins.is_fit_predicate_registered(p.name):
            raise PolicyValidationError(f"unknown predicate {p.name!r}")
        pred_keys.append(p.name)

    prio_configs = []
    for p in policy.priorities:
        if p.service_anti_affinity_label:
            fn = prios.service_anti_affinity_priority(
                p.service_anti_affinity_label
            )
            prio_configs.append(PriorityConfig(fn, p.weight, p.name))
        elif p.label_preference:
            fn = prios.node_label_priority(
                p.label_preference, p.label_preference_presence
            )
            prio_configs.append(PriorityConfig(fn, p.weight, p.name))
        else:
            if not plugins.is_priority_registered(p.name):
                raise PolicyValidationError(f"unknown priority {p.name!r}")
            cfg = plugins.get_priority_function_configs([p.name], args)[0]
            cfg.weight = p.weight
            prio_configs.append(cfg)

    predicates = plugins.get_fit_predicate_functions(pred_keys, args)
    return predicates, prio_configs
