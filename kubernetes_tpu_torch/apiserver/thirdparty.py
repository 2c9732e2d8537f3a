"""ThirdParty dynamic API resources (pkg/master/master.go:610-766).

Creating a ThirdPartyResource object named `<kebab-kind>.<domain>`
(e.g. "cron-tab.example.com") dynamically installs a new REST resource
at /apis/<domain>/<version>/namespaces/{ns}/<plural> serving free-form
objects: a per-kind dataclass is synthesized and registered with the
codec, and the group/version's wire transforms flatten the object's
`data` bag to top-level JSON keys (the TPR wire carries arbitrary
fields beside kind/apiVersion/metadata). Deleting the
ThirdPartyResource uninstalls the resource and its codec entries,
exactly the install/remove lifecycle of master.go
InstallThirdPartyResource / RemoveThirdPartyResource.

Copy of kubernetes_tpu/apiserver/thirdparty.py: only the import package differs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from kubernetes_tpu_torch.api.types import ObjectMeta
from kubernetes_tpu_torch.runtime import versioning
from kubernetes_tpu_torch.runtime.scheme import Scheme

_STANDARD_WIRE_KEYS = {"kind", "apiVersion", "metadata"}


def parse_tpr_name(name: str):
    """'cron-tab.example.com' -> (kind 'CronTab', plural 'crontabs',
    group 'example.com'). master.go:637 thirdpartyresourcedata
    ExtractApiGroupAndKind."""
    kebab, _, group = name.partition(".")
    if not kebab or not group:
        raise ValueError(
            f"third-party resource name {name!r} must be "
            "<kind-in-kebab-case>.<domain>"
        )
    kind = "".join(part.title() for part in kebab.split("-"))
    if not kind.isidentifier():
        raise ValueError(f"invalid third-party kind {kind!r}")
    plural = kind.lower() + "s"
    return kind, plural, group


def normalize_versions(versions) -> tuple:
    """The reference wire carries versions:[{name:"v1"}]; accept both
    that and plain strings, defaulting to ("v1",)."""
    out = []
    for v in versions or ():
        if isinstance(v, dict):
            v = v.get("name", "")
        if not isinstance(v, str) or not v:
            raise ValueError(f"invalid third-party version {v!r}")
        out.append(v)
    return tuple(out) or ("v1",)


_DYNAMIC_CLASSES: Dict[str, type] = {}


def make_tpr_class(kind: str):
    """A synthesized per-kind dataclass: metadata + a free-form data
    bag. Each TPR kind gets ONE class per process (cached) so the
    type-keyed codec and the TLV registry route it like any first-class
    kind."""
    cls = _DYNAMIC_CLASSES.get(kind)
    if cls is not None:
        return cls
    cls = dataclasses.make_dataclass(
        kind,
        [
            ("metadata", ObjectMeta,
             dataclasses.field(default_factory=ObjectMeta)),
            ("data", Dict[str, Any], dataclasses.field(default_factory=dict)),
        ],
    )
    cls.__doc__ = f"Third-party kind {kind} (dynamic, master.go:610)"
    _DYNAMIC_CLASSES[kind] = cls
    return cls


def _dynamic_wire_class(name: str, nfields: int):
    """TLV unknown-class factory: a fresh process recovering a durable
    store (or decoding the binary wire) meets dynamic kinds whose
    classes only exist after install. Synthesize them on sight, but
    ONLY for the exact TPR shape — two fields and a CamelCase
    identifier — so schema drift on real classes still errors."""
    if nfields != 2 or not name.isidentifier() or not name[:1].isupper():
        return None
    from kubernetes_tpu_torch.runtime import tlv

    cls = make_tpr_class(name)
    tlv.register(cls, replace=True)
    return cls


# active from apiserver import: FileStore recovery runs before any
# ThirdPartyResource install can re-register the classes
from kubernetes_tpu_torch.runtime import tlv as _tlv

_tlv.set_dynamic_factory(_dynamic_wire_class)


def _flatten(d: Dict[str, Any]) -> Dict[str, Any]:
    """internal wire {metadata, data:{...}} -> TPR wire {metadata, ...}."""
    out = {k: v for k, v in d.items() if k != "data"}
    for k, v in (d.get("data") or {}).items():
        if k not in _STANDARD_WIRE_KEYS:
            out[k] = v
    return out


def _gather(d: Dict[str, Any]) -> Dict[str, Any]:
    """TPR wire -> internal wire: unknown top-level keys become data."""
    out = {k: v for k, v in d.items() if k in _STANDARD_WIRE_KEYS}
    data = dict(d.get("data") or {})
    for k, v in d.items():
        if k not in _STANDARD_WIRE_KEYS and k != "data":
            data[k] = v
    out["data"] = data
    return out


class ThirdPartyInstaller:
    """Installs/uninstalls dynamic resources on an APIServer."""

    def __init__(self, server):
        self.server = server
        # tpr object name -> (plural, kind, group, versions)
        self._installed: Dict[str, tuple] = {}

    def precheck(self, tpr) -> None:
        """Everything that can reject a ThirdPartyResource, runnable
        BEFORE the object is persisted (an invalid TPR must never land
        in the store just to 400 afterwards)."""
        name = tpr.metadata.name
        kind, plural, group = parse_tpr_name(name)
        normalize_versions(tpr.versions)
        if plural in self.server.resources and name not in self._installed:
            raise ValueError(f"resource {plural!r} already installed")

    def install(self, tpr) -> None:
        from kubernetes_tpu_torch.apiserver.registry import ResourceInfo

        name = tpr.metadata.name
        if name in self._installed:
            return
        kind, plural, group = parse_tpr_name(name)
        if plural in self.server.resources:
            raise ValueError(
                f"resource {plural!r} already installed"
            )
        versions = normalize_versions(tpr.versions)
        cls = make_tpr_class(kind)
        scheme: Scheme = self.server.scheme
        scheme.register(kind, cls)
        from kubernetes_tpu_torch.runtime import tlv

        tlv.register(cls, replace=True)
        created_gvs = []
        for version in versions:
            # MERGE into an existing group/version (a shipped group or a
            # sibling TPR kind must keep its own transforms)
            gv = versioning._REGISTRY.get((group, version))
            if gv is None:
                gv = versioning.GroupVersion(group, version)
                versioning._REGISTRY[(group, version)] = gv
                created_gvs.append((group, version))
            gv.to_wire[kind] = _flatten
            gv.to_internal[kind] = _gather
        versioning.codec_for.cache_clear()  # a cached None must not linger
        self.server.resources[plural] = ResourceInfo(
            plural, kind, cls, f"/{plural}", namespaced=True, group=group,
        )
        self._installed[name] = (plural, kind, group, versions, created_gvs)

    def uninstall(self, tpr_name: str) -> None:
        ent = self._installed.pop(tpr_name, None)
        if ent is None:
            return
        plural, kind, group, versions, created_gvs = ent
        self.server.resources.pop(plural, None)
        scheme: Scheme = self.server.scheme
        cls = scheme.type_for(kind)
        scheme._kind_to_type.pop(kind, None)
        if cls is not None:
            scheme._type_to_kind.pop(cls, None)
        for version in versions:
            gv = versioning._REGISTRY.get((group, version))
            if gv is None:
                continue
            gv.to_wire.pop(kind, None)
            gv.to_internal.pop(kind, None)
            # only remove group/versions THIS install created, and only
            # once no other kind uses them
            if (group, version) in created_gvs and not gv.to_wire and (
                not gv.to_internal
            ) and not gv.defaults:
                versioning._REGISTRY.pop((group, version), None)
        versioning.codec_for.cache_clear()
        # RemoveThirdPartyResource deletes the resource data too: a
        # later same-plural install must not resurrect old objects
        store = self.server.store
        for obj in store.list(f"/{plural}/")[0]:
            try:
                store.delete(
                    f"/{plural}/{obj.metadata.namespace}/{obj.metadata.name}"
                )
            except Exception:
                pass

    def installed(self) -> Dict[str, tuple]:
        return dict(self._installed)
