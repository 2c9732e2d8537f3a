"""Webhook authn/authz (plugin/pkg/auth/{authenticator/token,authorizer}/webhook).

The reference delegates token review and subject access review to an
external HTTP service speaking the authentication.k8s.io TokenReview /
authorization.k8s.io SubjectAccessReview shapes, with a TTL cache over
verdicts. Same protocol here: POST the review object, read
status.authenticated / status.allowed from the response. Failure
posture matches the reference: a webhook error is "no opinion" for
authn (the union moves on) and DENY for authz (fail closed —
webhook.go Authorize returns err -> not allowed).

Copy of kubernetes_tpu/auth/webhook.py: only the import package differs.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Dict, Optional, Tuple

from kubernetes_tpu_torch.auth.authn import Authenticator, UserInfo
from kubernetes_tpu_torch.auth.authz import Attributes, Authorizer


class _TTLCache:
    def __init__(self, ttl: float):
        self.ttl = ttl
        self._lock = threading.Lock()
        self._data: Dict = {}

    def get(self, key):
        if self.ttl <= 0:
            return None
        with self._lock:
            ent = self._data.get(key)
            if ent is None:
                return None
            value, expiry = ent
            if time.monotonic() > expiry:
                del self._data[key]
                return None
            return value

    def put(self, key, value) -> None:
        if self.ttl <= 0:
            return
        with self._lock:
            if len(self._data) > 4096:  # bound memory under token churn
                self._data.clear()
            self._data[key] = (value, time.monotonic() + self.ttl)


def _post_json(url: str, payload: dict, timeout: float,
               bearer_token: str = "") -> dict:
    headers = {"Content-Type": "application/json"}
    if bearer_token:
        # the webhook kubeconfig's user credential: the CALLER of a
        # review endpoint authenticates like any other client
        headers["Authorization"] = f"Bearer {bearer_token}"
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers=headers,
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


class WebhookTokenAuthenticator(Authenticator):
    """TokenReview over HTTP (webhook.go AuthenticateToken)."""

    def __init__(self, url: str, cache_ttl: float = 120.0,
                 timeout: float = 5.0, bearer_token: str = ""):
        self.url = url
        self.timeout = timeout
        self.bearer_token = bearer_token
        self._cache = _TTLCache(cache_ttl)

    def authenticate(self, headers: Dict[str, str]) -> Optional[UserInfo]:
        auth = headers.get("Authorization", "") or headers.get(
            "authorization", ""
        )
        if not auth.startswith("Bearer "):
            return None
        token = auth[len("Bearer "):].strip()
        cached = self._cache.get(token)
        if cached is not None:
            return cached or None  # False caches a definite reject
        review = {
            "apiVersion": "authentication.k8s.io/v1beta1",
            "kind": "TokenReview",
            "spec": {"token": token},
        }
        try:
            resp = _post_json(self.url, review, self.timeout,
                              self.bearer_token)
        except Exception:
            return None  # webhook down: no opinion, union continues
        status = resp.get("status", {})
        if not status.get("authenticated"):
            self._cache.put(token, False)
            return None
        u = status.get("user", {})
        user = UserInfo(
            name=u.get("username", ""),
            uid=u.get("uid", ""),
            groups=tuple(u.get("groups", ())),
        )
        self._cache.put(token, user)
        return user


class WebhookAuthorizer(Authorizer):
    """SubjectAccessReview over HTTP (webhook.go Authorize). Errors
    DENY: an unreachable authorizer must not open the cluster."""

    def __init__(self, url: str, cache_ttl: float = 30.0,
                 timeout: float = 5.0, bearer_token: str = ""):
        self.bearer_token = bearer_token
        self.url = url
        self.timeout = timeout
        self._cache = _TTLCache(cache_ttl)

    @staticmethod
    def _key(attrs: Attributes) -> Tuple:
        """EVERY field the review decision depends on must key the
        cache — a named get and a collection list are different
        questions with different answers."""
        from kubernetes_tpu_torch.auth.rbac import api_verb

        user = attrs.user
        return (
            user.name if user else "",
            tuple(user.groups) if user else (),
            api_verb(attrs),
            attrs.resource,
            attrs.namespace,
            attrs.name,
            attrs.api_group,
            attrs.subresource,
            attrs.path,
        )

    def authorize(self, attrs: Attributes) -> bool:
        key = self._key(attrs)
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        user = attrs.user
        # ship the FULL request shape, with the verb already mapped to
        # the API form — the server side evaluates exactly the request
        # being made (subresource grants, named gets, nonResourceURLs)
        from kubernetes_tpu_torch.auth.rbac import api_verb

        verb = api_verb(attrs)
        spec = {
            "user": user.name if user else "",
            "groups": list(user.groups) if user else [],
        }
        if attrs.resource:
            spec["resourceAttributes"] = {
                "verb": verb,
                "resource": attrs.resource,
                "namespace": attrs.namespace,
                "name": attrs.name,
                "group": attrs.api_group,
                "subresource": attrs.subresource,
            }
        else:
            spec["nonResourceAttributes"] = {
                "verb": verb,
                "path": attrs.path,
            }
        review = {
            "apiVersion": "authorization.k8s.io/v1beta1",
            "kind": "SubjectAccessReview",
            "spec": spec,
        }
        try:
            resp = _post_json(self.url, review, self.timeout,
                              self.bearer_token)
        except Exception:
            return False  # fail closed
        allowed = bool(resp.get("status", {}).get("allowed"))
        self._cache.put(key, allowed)
        return allowed
