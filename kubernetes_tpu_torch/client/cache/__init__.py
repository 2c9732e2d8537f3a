"""List+watch cache toolkit (pkg/client/cache).

Copy of kubernetes_tpu/client/cache/__init__.py: only the import package differs."""

from kubernetes_tpu_torch.client.cache.fifo import FIFO, DeltaFIFO, Delta, ProcessError
from kubernetes_tpu_torch.client.cache.reflector import Reflector
from kubernetes_tpu_torch.client.cache.store import (
    Indexer,
    Store,
    meta_namespace_index_func,
    meta_namespace_key_func,
)

__all__ = [
    "FIFO",
    "DeltaFIFO",
    "Delta",
    "ProcessError",
    "Reflector",
    "Store",
    "Indexer",
    "meta_namespace_key_func",
    "meta_namespace_index_func",
]
