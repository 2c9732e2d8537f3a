"""Algorithm providers: DefaultProvider + the device providers.

PyTorch counterpart of kubernetes_tpu/scheduler/algorithmprovider.py
(defaults.go init:55; defaultPredicates:116; defaultPriorities:162;
legacy aliases :60-81). _register_all is the JAX package's, verbatim:
the same predicate and priority keys under DefaultProvider and
TPUProvider. The device provider's factory builds TorchScheduleAlgorithm
(see _tpu_algorithm_factory), and the same provider is also registered
as "CUDAProvider", so a policy file or options written for the JAX
daemon load unchanged and new ones can name the card. No mesh: the
multi-device driver is a later slice.

Env knob parity: KUBE_MAX_PD_VOLS (defaults.go:41-53).
"""

from __future__ import annotations

import functools
import os

from kubernetes_tpu_torch.oracle import predicates as preds
from kubernetes_tpu_torch.oracle import priorities as prios
from kubernetes_tpu_torch.oracle.scheduler import PriorityConfig
from kubernetes_tpu_torch.scheduler import plugins

DEFAULT_PROVIDER_NAME = "DefaultProvider"
TPU_PROVIDER_NAME = "TPUProvider"

# deterministic predicate evaluation order (= defaults.go:116 table
# order; the reference's map iteration is random — SURVEY §7 hard-part 4)
CANONICAL_PREDICATE_ORDER = (
    "NoDiskConflict",
    "NoVolumeZoneConflict",
    "MaxEBSVolumeCount",
    "MaxGCEPDVolumeCount",
    "GeneralPredicates",
    "PodToleratesNodeTaints",
    "CheckNodeMemoryPressure",
    "MatchInterPodAffinity",
    # legacy/optional keys:
    "PodFitsPorts",
    "PodFitsHostPorts",
    "PodFitsResources",
    "HostName",
    "MatchNodeSelector",
)


def _max_pd_vols(default: int) -> int:
    v = os.environ.get("KUBE_MAX_PD_VOLS", "")
    try:
        return int(v) if v else default
    except ValueError:
        return default


def _register_all() -> None:
    # --- predicates (defaults.go:116-160 + legacy aliases) ---
    plugins.register_fit_predicate("NoDiskConflict", preds.no_disk_conflict)
    plugins.register_fit_predicate("NoVolumeZoneConflict", preds.volume_zone)
    plugins.register_fit_predicate_factory(
        "MaxEBSVolumeCount",
        lambda args: preds.max_pd_volume_count(
            "ebs", _max_pd_vols(preds.DEFAULT_MAX_EBS_VOLUMES)
        ),
    )
    plugins.register_fit_predicate_factory(
        "MaxGCEPDVolumeCount",
        lambda args: preds.max_pd_volume_count(
            "gce-pd", _max_pd_vols(preds.DEFAULT_MAX_GCE_PD_VOLUMES)
        ),
    )
    plugins.register_fit_predicate("GeneralPredicates", preds.general_predicates)
    plugins.register_fit_predicate(
        "PodToleratesNodeTaints", preds.pod_tolerates_node_taints
    )
    plugins.register_fit_predicate(
        "CheckNodeMemoryPressure", preds.check_node_memory_pressure
    )
    plugins.register_fit_predicate(
        "MatchInterPodAffinity", preds.inter_pod_affinity_matches
    )
    # legacy aliases (defaults.go:77 PodFitsPorts, etc.)
    plugins.register_fit_predicate("PodFitsPorts", preds.pod_fits_host_ports)
    plugins.register_fit_predicate("PodFitsHostPorts", preds.pod_fits_host_ports)
    plugins.register_fit_predicate("PodFitsResources", preds.pod_fits_resources)
    plugins.register_fit_predicate("HostName", preds.pod_fits_host)
    plugins.register_fit_predicate("MatchNodeSelector", preds.pod_selector_matches)

    # --- priorities (defaults.go:162-196) ---
    plugins.register_priority_function(
        "LeastRequestedPriority", prios.least_requested_priority
    )
    plugins.register_priority_function(
        "BalancedResourceAllocation", prios.balanced_resource_allocation
    )
    plugins.register_priority_function(
        "SelectorSpreadPriority", prios.selector_spread_priority
    )
    plugins.register_priority_function(
        "NodeAffinityPriority", prios.node_affinity_priority
    )
    plugins.register_priority_function(
        "TaintTolerationPriority", prios.taint_toleration_priority
    )
    plugins.register_priority_factory(
        "InterPodAffinityPriority",
        lambda args: PriorityConfig(
            functools.partial(
                prios.inter_pod_affinity_priority,
                hard_pod_affinity_weight=args.hard_pod_affinity_weight,
                # --failure-domains (options.go:52): empty/unset keeps the
                # built-in defaults
                failure_domains=tuple(args.failure_domains) or None,
            ),
            1,
            "InterPodAffinityPriority",
        ),
    )
    # legacy (defaults.go:60-81)
    plugins.register_priority_function("EqualPriority", prios.equal_priority, 1)
    plugins.register_priority_function(
        "ServiceSpreadingPriority", prios.selector_spread_priority
    )
    plugins.register_priority_function(
        "ImageLocalityPriority", prios.image_locality_priority
    )

    default_predicates = {
        "NoDiskConflict",
        "NoVolumeZoneConflict",
        "MaxEBSVolumeCount",
        "MaxGCEPDVolumeCount",
        "GeneralPredicates",
        "PodToleratesNodeTaints",
        "CheckNodeMemoryPressure",
        "MatchInterPodAffinity",
    }
    default_priorities = {
        "LeastRequestedPriority",
        "BalancedResourceAllocation",
        "SelectorSpreadPriority",
        "NodeAffinityPriority",
        "TaintTolerationPriority",
        "InterPodAffinityPriority",
    }
    plugins.register_algorithm_provider(
        DEFAULT_PROVIDER_NAME, default_predicates, default_priorities
    )
    plugins.register_algorithm_provider(
        TPU_PROVIDER_NAME,
        default_predicates,
        default_priorities,
        algorithm_factory=_tpu_algorithm_factory,
    )


CUDA_PROVIDER_NAME = "CUDAProvider"


def _tpu_algorithm_factory(factory_args, device="cuda"):
    """Build the port's batched ScheduleAlgorithm on `device` (the card
    unless the caller asks for the CPU).

    Deviation from kubernetes_tpu/scheduler/algorithmprovider.py
    _tpu_algorithm_factory: it returns TorchScheduleAlgorithm with no
    mesh, no scheduler cache and no listers, since the port has neither
    the multi-device driver (parallel/mesh.py) nor the daemon's
    incremental encoder yet; factory_args is accepted for the registry's
    signature."""
    from kubernetes_tpu_torch.scheduler.algorithm import (
        TorchScheduleAlgorithm,
    )

    return TorchScheduleAlgorithm(device=device)


def _register_cuda() -> None:
    """The device provider under the port's own name: TPUProvider's keys
    and factory."""
    tpu = plugins.get_algorithm_provider(TPU_PROVIDER_NAME)
    plugins.register_algorithm_provider(
        CUDA_PROVIDER_NAME, tpu.fit_predicate_keys, tpu.priority_keys,
        algorithm_factory=tpu.algorithm_factory,
    )


_register_all()
_register_cuda()
