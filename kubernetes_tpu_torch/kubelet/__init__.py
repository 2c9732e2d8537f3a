"""The node agent (pkg/kubelet analogue).

Architecture mirrors the reference (kubelet.go:2491 syncLoop):

    apiserver watch (spec.nodeName==me) ──┐
    PLEG relist events ───────────────────┼─> syncLoopIteration ─> per-pod
    housekeeping tick ────────────────────┘                        workers
                                                                     │
    container runtime (Fake for hollow nodes) <── syncPod ───────────┘
    status manager ──> PATCH/PUT pod status ──> apiserver
    node status heartbeats ──> node conditions

The container runtime is an interface; the FakeRuntime (the reference's
dockertools.FakeDockerClient, used by kubemark's hollow nodes,
hollow-node.go:102-120) "runs" pods instantly in memory, which makes a
5k-node cluster simulable in one process.

Copy of kubernetes_tpu/kubelet/__init__.py: only the import package differs.
"""

from kubernetes_tpu_torch.kubelet.kubelet import Kubelet, KubeletConfig
from kubernetes_tpu_torch.kubelet.runtime import FakeRuntime, ContainerRuntime
from kubernetes_tpu_torch.kubelet.process_runtime import ProcessRuntime

__all__ = [
    "Kubelet",
    "KubeletConfig",
    "FakeRuntime",
    "ContainerRuntime",
    "ProcessRuntime",
]
