"""Versioned component configuration (pkg/apis/componentconfig).

Reference: pkg/apis/componentconfig/types.go — daemon flags are a
VERSIONED, DEFAULTED API object, not plain argv: each daemon embeds its
configuration struct (options.go:31 `SchedulerServer` embeds
`KubeSchedulerConfiguration`), files decode through the versioned codec
with scheme defaulting, and /configz serves the live object back.

Here the group is `componentconfig/v1alpha1` (the reference's version
for these kinds). Defaulting is the dataclass-default idiom the rest of
the framework uses: decoding fills absent fields from the declared
defaults — the scheme conversion role of SetDefaults_* funcs. Files may
be JSON or YAML; `apiVersion` is validated against the group the server
actually serves, exactly like a Policy file.

Copy of kubernetes_tpu/apis/componentconfig.py: only the import package differs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from kubernetes_tpu_torch.runtime.scheme import Scheme

GROUP_VERSION = "componentconfig/v1alpha1"

# a DEDICATED scheme: componentconfig kinds must not pollute the core
# v1 codec's kind registry (and their wire apiVersion is this group's)
scheme = Scheme(api_version=GROUP_VERSION)


class ComponentConfigError(Exception):
    pass


@dataclass
class LeaderElectionConfiguration:
    """componentconfig/types.go LeaderElectionConfiguration."""

    leader_elect: bool = False
    lease_duration_seconds: float = 15.0
    renew_deadline_seconds: float = 10.0
    retry_period_seconds: float = 2.0


@dataclass
class KubeSchedulerConfiguration:
    """componentconfig/types.go KubeSchedulerConfiguration (the fields
    this framework's daemon consumes; options.go:52 AddFlags)."""

    algorithm_provider: str = "TPUProvider"
    policy_config_file: str = ""
    scheduler_name: str = "default-scheduler"
    hard_pod_affinity_symmetric_weight: int = 1
    failure_domains: List[str] = field(
        default_factory=lambda: [
            "kubernetes.io/hostname",
            "failure-domain.beta.kubernetes.io/zone",
            "failure-domain.beta.kubernetes.io/region",
        ]
    )
    kube_api_qps: float = 50.0
    kube_api_burst: int = 100
    leader_election: LeaderElectionConfiguration = field(
        default_factory=LeaderElectionConfiguration
    )
    lock_object_namespace: str = "kube-system"
    lock_object_name: str = "kube-scheduler"


@dataclass
class KubeletConfiguration:
    """componentconfig/types.go KubeletConfiguration (consumed subset)."""

    node_name: str = ""
    sync_frequency_seconds: float = 10.0  # kubelet.go default
    node_status_update_frequency_seconds: float = 10.0
    serve_api: bool = False
    api_tls_cert: str = ""
    api_tls_key: str = ""
    api_auth_token: str = ""
    eviction_memory_threshold: int = 0
    max_pods: int = 110


@dataclass
class KubeProxyConfiguration:
    """componentconfig/types.go KubeProxyConfiguration (consumed
    subset)."""

    bind_address: str = "127.0.0.1"
    mode: str = "userspace"  # the dataplane this framework ships
    udp_idle_timeout_seconds: float = 10.0


@dataclass
class KubeControllerManagerConfiguration:
    """componentconfig/types.go KubeControllerManagerConfiguration
    (consumed subset)."""

    concurrent_rc_syncs: int = 5
    node_monitor_grace_period_seconds: float = 40.0
    pod_eviction_timeout_seconds: float = 300.0
    cloud_provider: str = ""
    leader_election: LeaderElectionConfiguration = field(
        default_factory=LeaderElectionConfiguration
    )


for _cls in (
    LeaderElectionConfiguration,
    KubeSchedulerConfiguration,
    KubeletConfiguration,
    KubeProxyConfiguration,
    KubeControllerManagerConfiguration,
):
    scheme.register(_cls.__name__, _cls)


def _validate(obj) -> None:
    if isinstance(obj, KubeSchedulerConfiguration):
        if obj.kube_api_qps <= 0:
            raise ComponentConfigError("kubeApiQps (QPS) must be positive")
        if obj.kube_api_burst <= 0:
            raise ComponentConfigError("kubeApiBurst must be positive")
        if not (0 <= obj.hard_pod_affinity_symmetric_weight <= 100):
            # server.go validation: the weight is non-negative
            raise ComponentConfigError(
                "hardPodAffinitySymmetricWeight must be in [0, 100]"
            )
    if isinstance(obj, KubeletConfiguration):
        if obj.max_pods <= 0:
            raise ComponentConfigError("maxPods must be positive")
    if isinstance(obj, KubeProxyConfiguration):
        if obj.mode not in ("userspace",):
            raise ComponentConfigError(
                f"unsupported proxy mode {obj.mode!r}"
            )


def load_component_config(path: str, expected_kind: str):
    """Decode a versioned component config file (JSON or YAML) with
    defaulting + validation — the server.go:163-177 Policy-file idiom
    applied to componentconfig."""
    with open(path) as f:
        raw = f.read()
    if raw.lstrip().startswith("{"):
        import json

        data = json.loads(raw)
    else:
        import yaml

        data = yaml.safe_load(raw)
    if not isinstance(data, dict):
        raise ComponentConfigError("component config must be an object")
    api_version = data.get("apiVersion", GROUP_VERSION)
    if api_version != GROUP_VERSION:
        raise ComponentConfigError(
            f"unsupported apiVersion {api_version!r}; this build serves "
            f"{GROUP_VERSION}"
        )
    kind = data.get("kind", "")
    if kind != expected_kind:
        raise ComponentConfigError(
            f"expected kind {expected_kind!r}, got {kind!r}"
        )
    obj = scheme.decode(data)  # decode() strips kind/apiVersion itself
    _validate(obj)
    return obj
