"""Thread-safe keyed stores and indexers.

Reference: pkg/client/cache/{store.go, index.go, thread_safe_store.go}.
Store is the flat map; Indexer adds secondary indices (index name →
index func → set of keys), used e.g. by the namespace pod index.

Copy of kubernetes_tpu/client/cache/store.py: only the import package differs.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

KeyFunc = Callable[[Any], str]
IndexFunc = Callable[[Any], Sequence[str]]


def meta_namespace_key_func(obj: Any) -> str:
    """'<namespace>/<name>' for namespaced, '<name>' otherwise
    (store.go MetaNamespaceKeyFunc)."""
    meta = obj.metadata
    if getattr(meta, "namespace", ""):
        return f"{meta.namespace}/{meta.name}"
    return meta.name


def meta_namespace_index_func(obj: Any) -> Sequence[str]:
    return [getattr(obj.metadata, "namespace", "") or ""]


class Store:
    """Thread-safe map keyed by key_func; Replace() swaps the world
    (the reflector's list step)."""

    def __init__(self, key_func: KeyFunc = meta_namespace_key_func):
        self.key_func = key_func
        self._lock = threading.RLock()
        self._items: Dict[str, Any] = {}

    def add(self, obj: Any) -> None:
        self.update(obj)

    def update(self, obj: Any) -> None:
        key = self.key_func(obj)
        with self._lock:
            self._items[key] = obj
            self._update_indices(key, obj)

    def delete(self, obj: Any) -> None:
        key = self.key_func(obj)
        self.delete_by_key(key)

    def delete_by_key(self, key: str) -> None:
        with self._lock:
            old = self._items.pop(key, None)
            if old is not None:
                self._delete_from_indices(key, old)

    def get(self, obj: Any) -> Optional[Any]:
        return self.get_by_key(self.key_func(obj))

    def get_by_key(self, key: str) -> Optional[Any]:
        with self._lock:
            return self._items.get(key)

    def list(self) -> List[Any]:
        with self._lock:
            return list(self._items.values())

    def list_keys(self) -> List[str]:
        with self._lock:
            return list(self._items.keys())

    def replace(self, objs: Sequence[Any]) -> None:
        with self._lock:
            self._items = {self.key_func(o): o for o in objs}
            self._rebuild_indices()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    # index hooks (no-ops in the flat store)
    def _update_indices(self, key: str, obj: Any) -> None:
        pass

    def _delete_from_indices(self, key: str, obj: Any) -> None:
        pass

    def _rebuild_indices(self) -> None:
        pass


class Indexer(Store):
    def __init__(
        self,
        key_func: KeyFunc = meta_namespace_key_func,
        indexers: Optional[Dict[str, IndexFunc]] = None,
    ):
        self.indexers: Dict[str, IndexFunc] = dict(indexers or {})
        # index name -> index value -> set of object keys
        self._indices: Dict[str, Dict[str, set]] = {
            name: {} for name in self.indexers
        }
        super().__init__(key_func)

    def index(self, index_name: str, obj: Any) -> List[Any]:
        """Objects whose index values intersect obj's (index.go Index)."""
        fn = self.indexers[index_name]
        values = set(fn(obj))
        with self._lock:
            idx = self._indices.get(index_name, {})
            keys = set()
            for v in values:
                keys |= idx.get(v, set())
            return [self._items[k] for k in keys if k in self._items]

    def by_index(self, index_name: str, value: str) -> List[Any]:
        with self._lock:
            keys = self._indices.get(index_name, {}).get(value, set())
            return [self._items[k] for k in keys if k in self._items]

    def index_values(self, index_name: str) -> List[str]:
        with self._lock:
            return list(self._indices.get(index_name, {}).keys())

    def _update_indices(self, key: str, obj: Any) -> None:
        self._delete_key_from_indices(key)
        for name, fn in self.indexers.items():
            for v in fn(obj):
                self._indices[name].setdefault(v, set()).add(key)

    def _delete_from_indices(self, key: str, obj: Any) -> None:
        self._delete_key_from_indices(key)

    def _delete_key_from_indices(self, key: str) -> None:
        for idx in self._indices.values():
            for bucket in idx.values():
                bucket.discard(key)

    def _rebuild_indices(self) -> None:
        self._indices = {name: {} for name in self.indexers}
        for key, obj in self._items.items():
            for name, fn in self.indexers.items():
                for v in fn(obj):
                    self._indices[name].setdefault(v, set()).add(key)
