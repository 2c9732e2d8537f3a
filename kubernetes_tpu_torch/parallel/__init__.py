"""Device-level parallelism and placement for the scheduling program.

PyTorch counterpart of kubernetes_tpu/parallel/__init__.py. Only the
quantized table placement (parallel/quant) is ported: the mesh drivers
and the resident sharded state come with the multi-device slice
(ROADMAP.md queue 1 item 2).

Deviation from kubernetes_tpu/parallel/__init__.py <module>, which
exports MeshBatchScheduler, MeshWaveScheduler and ResidentClusterState:
those come with queue 1 item 2 (parallel/mesh.py, parallel/resident.py
and torch.distributed), so this package exports quant alone.
"""

from kubernetes_tpu_torch.parallel import quant

__all__ = ["quant"]
