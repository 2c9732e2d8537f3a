"""Generic dataclass <-> JSON codec with a kind registry.

The reference generates thousands of lines of conversion/deepcopy/codec
code per type (pkg/api/ vN/ zz_generated*); here the schema IS the
dataclass, and one reflective codec covers every kind. Field names are
converted snake_case <-> camelCase at the wire boundary so payloads look
like the reference's JSON (e.g. "nodeName", "resourceVersion").

Copy of kubernetes_tpu/runtime/scheme.py: only the import package differs.
"""

from __future__ import annotations

import copy
import dataclasses
import typing
from typing import Any, Dict, Optional, Type

__all__ = ["Scheme", "scheme", "to_camel", "to_snake"]


import functools


@functools.lru_cache(maxsize=4096)
def to_camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


@functools.lru_cache(maxsize=4096)
def to_snake(name: str) -> str:
    """Memoized: the reflective codec and field selectors convert the
    same few hundred names millions of times under watch storms."""
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


def _is_dataclass_type(t: Any) -> bool:
    return isinstance(t, type) and dataclasses.is_dataclass(t)


# Per-class reflection plans. Resolving type hints reflectively on every
# call made the codec the daemon's single hottest path (typing.get_type_hints
# walks ForwardRefs each time); one plan per class restores generated-code
# speed while keeping the schema = the dataclass.
_ENCODE_PLAN: Dict[type, list] = {}
_DECODE_PLAN: Dict[type, Dict[str, tuple]] = {}


def _encode_plan(cls: type) -> list:
    plan = _ENCODE_PLAN.get(cls)
    if plan is None:
        plan = [(f.name, to_camel(f.name)) for f in dataclasses.fields(cls)]
        _ENCODE_PLAN[cls] = plan
    return plan


def encode_value(v: Any) -> Any:
    """Recursively encode a value into JSON-compatible data."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        cls = type(v)
        is_meta = cls.__name__ == "ObjectMeta"
        out: Dict[str, Any] = {}
        for fname, camel in _encode_plan(cls):
            fv = getattr(v, fname)
            if fv is None:
                continue
            # metadata.namespace is NEVER omitted: cluster-scoped objects
            # carry an explicit "" (the dataclass default is "default", so
            # omitempty would resurrect a namespace on decode)
            if is_meta and fname == "namespace":
                out[camel] = fv
                continue
            # omitempty: skip empty containers and default-empty strings
            if fv == {} or fv == [] or fv == () or fv == "":
                continue
            out[camel] = encode_value(fv)
        return out
    if isinstance(v, dict):
        return {k: encode_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [encode_value(x) for x in v]
    return v


def _strip_optional(t: Any) -> Any:
    if typing.get_origin(t) is typing.Union:
        args = [a for a in typing.get_args(t) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return t


# container-type plans: t -> ("list"|"tuple"|"dict"|"scalar", elem type)
_CONTAINER_PLAN: Dict[Any, tuple] = {}


def _container_plan(t: Any) -> tuple:
    try:
        plan = _CONTAINER_PLAN.get(t)
    except TypeError:  # unhashable typing construct: no caching
        plan = None
    if plan is None:
        origin = typing.get_origin(t)
        if origin in (list, typing.List):
            (elem,) = typing.get_args(t) or (Any,)
            plan = ("list", _strip_optional(elem))
        elif origin in (tuple, typing.Tuple):
            args = typing.get_args(t)
            plan = ("tuple", _strip_optional(args[0]) if args else Any)
        elif origin in (dict, typing.Dict):
            args = typing.get_args(t)
            vt = args[1] if len(args) == 2 else Any
            plan = ("dict", vt if vt in (object, Any) else _strip_optional(vt))
        else:
            plan = ("scalar", None)
        try:
            _CONTAINER_PLAN[t] = plan
        except TypeError:
            pass
    return plan


# Compiled decoders: type construct -> closure (or None for scalar
# passthrough). decode_value used to re-resolve typing constructs —
# get_origin/get_args/Optional-stripping — for EVERY value of every
# field; under a 30k-pod create storm that resolution was ~40% of the
# whole decode (the single hottest slice of the apiserver's bulk-create
# path). Each type construct now compiles once into a closure chain
# that does only data work. Self-referencing dataclasses terminate
# because the dataclass closure looks its field plan up lazily.
_DECODERS: Dict[Any, Any] = {}


def _field_decoders(cls: type) -> Dict[str, tuple]:
    """camel name -> (snake field name, compiled decoder|None)."""
    plan = _DECODE_PLAN.get(cls)
    if plan is None:
        hints = typing.get_type_hints(cls)
        plan = {
            to_camel(f.name): (f.name, _decoder_for(hints[f.name]))
            for f in dataclasses.fields(cls)
        }
        _DECODE_PLAN[cls] = plan
    return plan


def _decode_dataclass(cls: type, v: Any) -> Any:
    if not isinstance(v, dict):
        raise ValueError(f"expected object for {cls.__name__}, got {type(v)}")
    plan = _field_decoders(cls)
    kwargs = {}
    for k, fv in v.items():
        ent = plan.get(k)
        if ent is None:
            continue  # unknown fields are dropped, like strict-less json
        dec = ent[1]
        kwargs[ent[0]] = fv if dec is None or fv is None else dec(fv)
    return cls(**kwargs)


def _compile_decoder(t: Any):
    t = _strip_optional(t)
    if _is_dataclass_type(t):
        return lambda v, _c=t: _decode_dataclass(_c, v)
    kind, elem = _container_plan(t)
    if kind == "list":
        ed = _decoder_for(elem)
        if ed is None:
            return list
        return lambda v, _d=ed: [
            x if x is None else _d(x) for x in v
        ]
    if kind == "tuple":
        ed = _decoder_for(elem)
        if ed is None:
            return tuple
        return lambda v, _d=ed: tuple(
            x if x is None else _d(x) for x in v
        )
    if kind == "dict":
        if elem is object or elem is Any:
            return dict
        ed = _decoder_for(elem)
        if ed is None:
            return dict
        return lambda v, _d=ed: {
            k: x if x is None else _d(x) for k, x in v.items()
        }
    return None  # scalar passthrough


def _decoder_for(t: Any):
    try:
        dec = _DECODERS.get(t, _MISSING_DEC)
    except TypeError:  # unhashable typing construct: compile uncached
        return _compile_decoder(t)
    if dec is _MISSING_DEC:
        dec = _compile_decoder(t)
        _DECODERS[t] = dec
    return dec


_MISSING_DEC = object()


def decode_value(t: Any, v: Any) -> Any:
    """Recursively decode JSON data into the typed form `t`."""
    if v is None:
        return None
    dec = _decoder_for(t)
    return v if dec is None else dec(v)


class Scheme:
    """Kind registry + codec (pkg/runtime/scheme.go analogue)."""

    def __init__(self, api_version: str = "v1"):
        self.api_version = api_version
        self._kind_to_type: Dict[str, type] = {}
        self._type_to_kind: Dict[type, str] = {}

    def register(self, kind: str, cls: type) -> None:
        self._kind_to_type[kind] = cls
        self._type_to_kind[cls] = kind

    def kind_for(self, obj: Any) -> Optional[str]:
        return self._type_to_kind.get(type(obj))

    def type_for(self, kind: str) -> Optional[type]:
        return self._kind_to_type.get(kind)

    def encode(self, obj: Any) -> Dict[str, Any]:
        """Object -> JSON dict with kind/apiVersion tags."""
        d = encode_value(obj)
        kind = self.kind_for(obj)
        if kind:
            d["kind"] = kind
            d["apiVersion"] = self.api_version
        return d

    def decode(self, data: Dict[str, Any], cls: Optional[type] = None) -> Any:
        """JSON dict -> object. Type comes from `cls` or the kind tag."""
        if cls is None:
            kind = data.get("kind")
            cls = self._kind_to_type.get(kind or "")
            if cls is None:
                raise ValueError(f"no kind registered for {kind!r}")
        data = {k: v for k, v in data.items() if k not in ("kind", "apiVersion")}
        return decode_value(cls, data)

    def deep_copy(self, obj: Any) -> Any:
        return copy.deepcopy(obj)


def _default_scheme() -> Scheme:
    from kubernetes_tpu_torch.api import types as t

    s = Scheme()
    for kind, cls in [
        ("Pod", t.Pod),
        ("Node", t.Node),
        ("Service", t.Service),
        ("ReplicationController", t.ReplicationController),
        ("ReplicaSet", t.ReplicaSet),
        ("PersistentVolume", t.PersistentVolume),
        ("PersistentVolumeClaim", t.PersistentVolumeClaim),
        ("Namespace", t.Namespace),
        ("Endpoints", t.Endpoints),
        ("Event", t.Event),
        ("Job", t.Job),
        ("Deployment", t.Deployment),
        ("DaemonSet", t.DaemonSet),
        ("Binding", t.Binding),
        ("HorizontalPodAutoscaler", t.HorizontalPodAutoscaler),
        ("PetSet", t.PetSet),
        ("ResourceQuota", t.ResourceQuota),
        ("LimitRange", t.LimitRange),
        ("ServiceAccount", t.ServiceAccount),
        ("Secret", t.Secret),
        ("ConfigMap", t.ConfigMap),
        ("ThirdPartyResource", t.ThirdPartyResource),
        ("Ingress", t.Ingress),
        ("NetworkPolicy", t.NetworkPolicy),
        ("PodDisruptionBudget", t.PodDisruptionBudget),
        ("PodSecurityPolicy", t.PodSecurityPolicy),
        ("ScheduledJob", t.ScheduledJob),
        ("PodTemplate", t.PodTemplate),
        ("ComponentStatus", t.ComponentStatus),
        ("Role", t.Role),
        ("RoleBinding", t.RoleBinding),
        ("ClusterRole", t.ClusterRole),
        ("ClusterRoleBinding", t.ClusterRoleBinding),
        ("Scale", t.Scale),
        ("PodGroup", t.PodGroup),
        ("PriorityClass", t.PriorityClass),
    ]:
        s.register(kind, cls)
    return s


#: The framework-wide scheme (api.Scheme analogue).
scheme = _default_scheme()
