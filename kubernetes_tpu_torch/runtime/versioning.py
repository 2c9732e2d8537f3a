"""Versioned API machinery: explicit wire versions with defaulting and
conversion onto the internal schema.

The reference keeps one INTERNAL type universe (pkg/api/types.go) and
serves versioned wire forms of it; every request body decodes through
the versioned codec — apply the version's defaults
(pkg/api/v1/defaults.go), convert to internal
(pkg/api/v1/conversion.go) — and every response encodes back through
the version's conversion (pkg/runtime/scheme.go ConvertToVersion).
Here the internal universe is the dataclasses and a GroupVersion is a
pair of wire-dict transforms + a defaulting pass, composed onto the
base reflective codec by VersionedScheme. Versions of one group are
served simultaneously: the same stored object round-trips through
whichever wire form the request path names.

Shipped versions:

- core "v1": field-alias conversion (the deprecated `serviceAccount`
  podSpec field decodes into serviceAccountName — v1/conversion.go);
  v1's defaults.go values coincide with the internal dataclass defaults
  here, so the defaulting seam ships empty for v1.
- "extensions/v1beta1": the original wire, PLUS the historical
  looseness that a workload `spec.selector` may be a bare label map,
  which decodes as matchLabels.
- "extensions/v1beta2": the tightened second version — selector must
  be the LabelSelector object form; bare maps are a 400.

Copy of kubernetes_tpu/runtime/versioning.py: only the import package differs.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

from kubernetes_tpu_torch.runtime.scheme import Scheme


class ConversionError(ValueError):
    """Body does not satisfy the named wire version."""


class GroupVersion:
    """One wire version of one API group."""

    def __init__(self, group: str, version: str):
        self.group = group
        self.version = version
        # kind -> fn(wire dict) -> wire dict (decode direction)
        self.to_internal: Dict[str, Callable] = {}
        # kind -> fn(wire dict) -> wire dict (encode direction)
        self.to_wire: Dict[str, Callable] = {}
        # kind -> fn(wire dict) -> wire dict (decode-side defaulting,
        # runs BEFORE conversion, like defaults.go on versioned types)
        self.defaults: Dict[str, Callable] = {}

    @property
    def name(self) -> str:
        return f"{self.group}/{self.version}" if self.group else self.version


class VersionedScheme:
    """The base reflective codec composed with a GroupVersion's
    transforms (scheme.go ConvertToVersion + DecodeToVersion)."""

    def __init__(self, base: Scheme, gv: GroupVersion):
        self.base = base
        self.gv = gv

    def kind_for(self, obj: Any) -> Optional[str]:
        return self.base.kind_for(obj)

    def type_for(self, kind: str):
        return self.base.type_for(kind)

    def encode(self, obj: Any) -> Dict[str, Any]:
        d = self.base.encode(obj)
        kind = d.get("kind")
        fn = self.gv.to_wire.get(kind or "")
        if fn is not None:
            d = fn(d)
        if kind:
            d["apiVersion"] = self.gv.name
        return d

    def decode(self, data: Dict[str, Any], cls: Optional[type] = None):
        kind = data.get("kind") or (
            self.base.kind_for(cls()) if cls is not None else None
        )
        # defaulting then conversion, both on the versioned wire form.
        # Transform contract: mutate only the top level and the top
        # level of data["spec"] — then a two-level shallow copy keeps
        # the caller's dict pristine without deep-copying whole bodies
        # on the decode hot path.
        dfn = self.gv.defaults.get(kind or "")
        cfn = self.gv.to_internal.get(kind or "")
        if dfn is not None or cfn is not None:
            data = dict(data)
            if isinstance(data.get("spec"), dict):
                data["spec"] = dict(data["spec"])
            if dfn is not None:
                data = dfn(data)
            if cfn is not None:
                data = cfn(data)
        return self.base.decode(data, cls)

    def deep_copy(self, obj: Any) -> Any:
        return self.base.deep_copy(obj)


# -- the shipped versions -----------------------------------------------------


def _v1() -> GroupVersion:
    gv = GroupVersion("", "v1")

    def pod_convert(d):
        spec = d.get("spec")
        if spec and "serviceAccount" in spec:
            # v1/conversion.go: the deprecated field feeds the new one
            spec.setdefault("serviceAccountName", spec.pop("serviceAccount"))
        return d

    gv.to_internal["Pod"] = pod_convert
    # NOTE on defaults: the reference defaults versioned objects at
    # decode (defaults.go); here the internal dataclass defaults ARE
    # the v1 defaults (protocol=TCP, sessionAffinity=None, type=
    # ClusterIP, restartPolicy=Always, ...), so registering them again
    # would only tax the hot path. gv.defaults stays the seam for any
    # future version whose defaults diverge from the internal schema.
    return gv


_EXT_KINDS = ("ReplicaSet", "Deployment", "DaemonSet", "Job",
              "HorizontalPodAutoscaler")


def _selector_loose(d):
    """v1beta1: a bare label map in spec.selector means matchLabels
    (the historical extensions wire accepted both forms)."""
    spec = d.get("spec") or {}
    sel = spec.get("selector")
    if isinstance(sel, dict) and sel and "matchLabels" not in sel and (
        "matchExpressions" not in sel
    ):
        spec["selector"] = {"matchLabels": sel}
    return d


def _selector_strict(d):
    spec = d.get("spec") or {}
    sel = spec.get("selector")
    if isinstance(sel, dict) and sel and "matchLabels" not in sel and (
        "matchExpressions" not in sel
    ):
        raise ConversionError(
            "spec.selector must be a LabelSelector object "
            "({matchLabels/matchExpressions}) in extensions/v1beta2; "
            "the bare label-map form is only served at v1beta1"
        )
    return d


def _extensions_v1beta1() -> GroupVersion:
    gv = GroupVersion("extensions", "v1beta1")
    for kind in _EXT_KINDS:
        gv.to_internal[kind] = _selector_loose
    return gv


def _extensions_v1beta2() -> GroupVersion:
    gv = GroupVersion("extensions", "v1beta2")
    for kind in _EXT_KINDS:
        gv.to_internal[kind] = _selector_strict
    return gv


_REGISTRY: Dict[Tuple[str, str], GroupVersion] = {}
for _gv in (_v1(), _extensions_v1beta1(), _extensions_v1beta2()):
    _REGISTRY[(_gv.group, _gv.version)] = _gv

# other group prefixes clients may use serve the plain wire at their
# canonical version
for _g, _v in (("batch", "v1"), ("batch", "v2alpha1"),
               ("autoscaling", "v1"),
               ("apps", "v1alpha1"), ("componentconfig", "v1alpha1"),
               ("federation", "v1beta1"), ("policy", "v1alpha1"),
               ("rbac", "v1alpha1"), ("scheduling", "v1alpha1"),
               ("authentication.k8s.io", "v1beta1"),
               ("authorization.k8s.io", "v1beta1")):
    _REGISTRY[(_g, _v)] = GroupVersion(_g, _v)


def group_versions() -> Dict[str, list]:
    out: Dict[str, list] = {}
    for (g, v) in _REGISTRY:
        out.setdefault(g or "core", []).append(v)
    return {g: sorted(vs) for g, vs in out.items()}


@functools.lru_cache(maxsize=64)
def codec_for(base: Scheme, group: str,
              version: str) -> Optional[VersionedScheme]:
    """The codec serving /apis/{group}/{version} (or /api/{version} for
    the core group). None = unknown group or unknown version (a 404,
    like the real apiserver's discovery-gated routing). Cached: the
    wrapper is stateless per (scheme, group, version)."""
    gv = _REGISTRY.get((group, version))
    if gv is None:
        return None
    return VersionedScheme(base, gv)
