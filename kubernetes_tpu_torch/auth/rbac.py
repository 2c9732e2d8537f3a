"""RBAC authorizer (pkg/apis/rbac + the rbac authorizer plugin).

Evaluation mirrors the upstream authorizer: collect the RoleBindings of
the request namespace plus every ClusterRoleBinding, keep those whose
subjects match the user (User by name, Group by membership,
ServiceAccount as the system:serviceaccount:<ns>:<name> identity),
resolve each binding's roleRef (Role in the binding's namespace, or
ClusterRole), and allow when ANY rule covers the request: verb, API
group, resource, and — when the rule carries resourceNames — the
instance name. '*' is the universal match everywhere
(rbac/types.go:31-34). RBAC is deny-by-default and purely additive:
there are no negative rules.

Attributes carry the HTTP verb; rules speak API verbs — the standard
REST mapping (GET on a collection is list, on a name is get, ...)
happens here, like the reference's attribute builder.

Objects are read live from the APIServer's store, so a policy change is
effective on the next request with no cache-invalidation machinery (the
reference trades the same simplicity via informers + re-list).

Copy of kubernetes_tpu/auth/rbac.py: only the import package differs.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.auth.authz import Attributes, Authorizer

_HTTP_TO_VERB = {
    "POST": "create",
    "PUT": "update",
    "PATCH": "patch",
    "DELETE": "delete",
}


def api_verb(attrs: Attributes) -> str:
    if not attrs.verb.isupper():
        # already an API verb (a SubjectAccessReview asks "get"/"watch"
        # directly); only UPPERCASE HTTP methods get the REST mapping
        return attrs.verb
    m = attrs.verb.upper()
    if not attrs.resource:
        # non-resource requests keep the lowercased HTTP method as the
        # verb (upstream's nonResourceURL attributes: "get /healthz")
        return m.lower()
    if getattr(attrs, "query_watch", False):
        return "watch"
    if m == "GET":
        return "get" if attrs.name else "list"
    return _HTTP_TO_VERB.get(m, m.lower())


def _url_matches(patterns: Iterable[str], path: str) -> bool:
    """nonResourceURLs: exact, '*', or a trailing-'*' prefix
    (the upstream authorizer's rule)."""
    for p in patterns:
        if p == "*" or p == path:
            return True
        if p.endswith("*") and path.startswith(p[:-1]):
            return True
    return False


def _match(values: Iterable[str], want: str) -> bool:
    return any(v == "*" or v == want for v in values)


def rule_allows(rule: t.PolicyRule, verb: str, api_group: str,
                resource: str, name: str, path: str = "") -> bool:
    if not _match(rule.verbs, verb):
        return False
    if not resource:
        # non-resource path (/healthz, /metrics, ...): only
        # nonResourceURLs grants apply
        return bool(path) and _url_matches(rule.non_resource_urls, path)
    # apiGroups defaulting: an empty list means the core group only
    if rule.api_groups and not _match(rule.api_groups, api_group):
        return False
    if not rule.api_groups and api_group:
        return False
    if not _match(rule.resources, resource):
        return False
    if rule.resource_names and not _match(rule.resource_names, name):
        return False
    return True


def subject_matches(sub: t.RBACSubject, user) -> bool:
    if user is None:
        return False
    kind = sub.kind or "User"
    if kind == "User":
        return sub.name == "*" or sub.name == user.name
    if kind == "Group":
        return sub.name in (user.groups or ())
    if kind == "ServiceAccount":
        return user.name == (
            f"system:serviceaccount:{sub.namespace}:{sub.name}"
        )
    return False


class RBACAuthorizer(Authorizer):
    def __init__(self, api_server):
        self.api = api_server

    # -- store reads ----------------------------------------------------------

    def _list(self, prefix: str) -> List:
        objs, _rv = self.api.store.list(prefix)
        return objs

    def _rules_for(self, ref: t.RoleRef, binding_ns: str) -> List[t.PolicyRule]:
        if ref.kind == "ClusterRole":
            for r in self._list("/clusterroles/"):
                if r.metadata.name == ref.name:
                    return r.rules
            return []
        for r in self._list(f"/roles/{binding_ns}/"):
            if r.metadata.name == ref.name:
                return r.rules
        return []

    # -- the verdict ----------------------------------------------------------

    def authorize(self, attrs: Attributes) -> bool:
        verb = api_verb(attrs)
        bindings = []
        if attrs.namespace:
            bindings += [
                (b, attrs.namespace)
                for b in self._list(f"/rolebindings/{attrs.namespace}/")
            ]
        bindings += [(b, "") for b in self._list("/clusterrolebindings/")]
        # subresources need their own grant: "pods/status", not "pods"
        # (the upstream resource attribute form)
        resource = attrs.resource
        sub = getattr(attrs, "subresource", "")
        if resource and sub:
            resource = f"{resource}/{sub}"
        path = getattr(attrs, "path", "")
        for binding, ns in bindings:
            if not any(
                subject_matches(s, attrs.user) for s in binding.subjects
            ):
                continue
            for rule in self._rules_for(binding.role_ref, ns):
                if rule_allows(rule, verb, attrs.api_group,
                               resource, attrs.name, path=path):
                    return True
        return False
