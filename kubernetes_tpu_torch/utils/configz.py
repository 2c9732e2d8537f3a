"""Config introspection (pkg/util/configz): components install their live
configuration under a name; /configz serves the merged view (the
scheduler registers its KubeSchedulerConfiguration there,
cmd/kube-scheduler/app/server.go:72-76,100).

Copy of kubernetes_tpu/utils/configz.py: only the import package differs."""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict

_lock = threading.Lock()
_registry: Dict[str, Any] = {}


def install(name: str, config: Any) -> None:
    with _lock:
        _registry[name] = config


def delete(name: str) -> None:
    with _lock:
        _registry.pop(name, None)


def _jsonable(v: Any) -> Any:
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {
            f.name: _jsonable(getattr(v, f.name))
            for f in dataclasses.fields(v)
        }
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def snapshot() -> Dict[str, Any]:
    with _lock:
        return {name: _jsonable(cfg) for name, cfg in _registry.items()}
