"""Device-mesh parallelism and placement for the scheduling program.

PyTorch counterpart of kubernetes_tpu/parallel/__init__.py. The node
axis is sharded over a DeviceMesh (parallel/shard: an ordered list of
torch devices driven by one process) and the per-step reductions run as
collectives over the shards' tensors:

- masks/scores: computed shard-locally, O(N/shards) each step
- filtered-set normalizations (spread/affinity/taint): pmax/psum scalars
- host selection: all_gather of the int64 score vector, then one
  deterministic selectHost a distinct device: every shard picks the same
  node
- commit: the owning shard folds the pod into its slice of the carry

The cluster state is device-resident across waves (parallel/resident):
node tables placed once per shard, folds in place, scatter-form commits,
host mirrors proving freshness, changed rows through the row scatter K8,
so steady waves ship O(pending pods), not O(nodes). parallel/quant is
the quantized table placement both drivers use.

The drivers are exported lazily (a module __getattr__): ops/priorities
imports parallel/quant, and parallel/mesh imports ops/priorities, so an
eager import here would close a cycle through models/batch.
"""

from kubernetes_tpu_torch.parallel import quant

__all__ = ["MeshBatchScheduler", "MeshWaveScheduler",
           "ResidentClusterState", "quant"]


def __getattr__(name):
    if name in ("MeshBatchScheduler", "MeshWaveScheduler"):
        from kubernetes_tpu_torch.parallel import mesh

        return getattr(mesh, name)
    if name == "ResidentClusterState":
        from kubernetes_tpu_torch.parallel import resident

        return resident.ResidentClusterState
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
