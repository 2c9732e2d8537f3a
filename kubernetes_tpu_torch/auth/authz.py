"""Authorizers (pkg/auth/authorizer + pkg/auth/authorizer/abac).

ABAC: a policy list where a request is allowed if ANY line matches the
(user|group, resource, namespace, readonly) attributes — abac.go
Authorize. Per the v0 policy format, an UNSET property matches any value
('*' is the explicit spelling of the same); the only mandatory part of a
line is binding to a user or group.

Copy of kubernetes_tpu/auth/authz.py: only the import package differs."""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional, Sequence

from kubernetes_tpu_torch.auth.authn import UserInfo

READ_VERBS = {"GET", "HEAD", "OPTIONS", "WATCH"}


class Forbidden(Exception):
    pass


@dataclass(frozen=True)
class Attributes:
    user: Optional[UserInfo]
    verb: str  # HTTP method
    resource: str
    namespace: str
    # resource instance name ("" for collection requests) and API group
    # ("" = core) — what RBAC resourceNames/apiGroups match against
    name: str = ""
    api_group: str = ""
    # subresource ("status", "binding", ...): RBAC requires an explicit
    # resource/subresource grant; the raw path backs nonResourceURLs
    # (/healthz, /metrics, ...); query_watch marks ?watch=true requests
    # (the API verb is watch, not list)
    subresource: str = ""
    path: str = ""
    query_watch: bool = False

    @property
    def readonly(self) -> bool:
        # verbs arrive as HTTP methods from the frontend and as API
        # verbs from SubjectAccessReviews; LIST is the one API read
        # verb with no HTTP-method twin in READ_VERBS
        return self.verb.upper() in READ_VERBS or self.verb == "list"


class Authorizer:
    def authorize(self, attrs: Attributes) -> bool:
        raise NotImplementedError


class AlwaysAllow(Authorizer):
    def authorize(self, attrs) -> bool:
        return True


class AlwaysDeny(Authorizer):
    def authorize(self, attrs) -> bool:
        return False


@dataclass(frozen=True)
class ABACPolicy:
    """One policy line (abac/types.go Policy)."""

    user: str = ""  # username or '*'
    group: str = ""  # group name or '*'
    resource: str = ""  # plural resource or '*'
    namespace: str = ""  # namespace or '*'
    readonly: bool = False  # True restricts the line to read verbs

    def matches(self, attrs: Attributes) -> bool:
        name = attrs.user.name if attrs.user else ""
        groups = attrs.user.groups if attrs.user else ()
        if self.user and self.user != "*" and self.user != name:
            return False
        if self.group and self.group != "*" and self.group not in groups:
            return False
        if not self.user and not self.group:
            return False  # a line must bind to someone
        if self.resource and self.resource != "*" and self.resource != attrs.resource:
            return False
        if (
            self.namespace
            and self.namespace != "*"
            and self.namespace != attrs.namespace
        ):
            return False
        if self.readonly and not attrs.readonly:
            return False
        return True


class ABACAuthorizer(Authorizer):
    def __init__(self, policies: Sequence[ABACPolicy]):
        self.policies = list(policies)

    @classmethod
    def from_jsonl(cls, text: str) -> "ABACAuthorizer":
        """One JSON policy per line (the 1.x policy file format)."""
        policies = []
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            d = json.loads(line)
            policies.append(
                ABACPolicy(
                    user=d.get("user", ""),
                    group=d.get("group", ""),
                    resource=d.get("resource", ""),
                    namespace=d.get("namespace", ""),
                    readonly=bool(d.get("readonly", False)),
                )
            )
        return cls(policies)

    def authorize(self, attrs: Attributes) -> bool:
        return any(p.matches(attrs) for p in self.policies)


class UnionAuthorizer(Authorizer):
    """authorizer/union: allowed if any member allows."""

    def __init__(self, authorizers: Sequence[Authorizer]):
        self.authorizers = list(authorizers)

    def authorize(self, attrs) -> bool:
        return any(a.authorize(attrs) for a in self.authorizers)
