"""ServiceAccounts + Tokens controllers
(pkg/serviceaccount/serviceaccounts_controller.go, tokens_controller.go).

Two reconciling loops:

- ServiceAccountsController ensures every active namespace has the
  "default" ServiceAccount (the object the serviceaccount admission
  plugin assigns to pods).
- TokensController ensures every ServiceAccount references a live
  kubernetes.io/service-account-token Secret carrying a signed JWT
  (auth/serviceaccount.TokenGenerator) plus the namespace, mirroring
  tokens_controller.go's secret shape. A deleted secret is re-minted on
  the next pass; the JWT authenticator's lookup hook then rejects the
  orphaned token.

The reference gates the token controller on
--service-account-private-key-file (controllermanager.go); here the
ControllerManager option is an in-memory private key.

Copy of kubernetes_tpu/controller/serviceaccount.py: only the import package differs.
"""

from __future__ import annotations

import base64
import uuid

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.auth.serviceaccount import TokenGenerator
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient
from kubernetes_tpu_torch.controller.framework import PeriodicRunner

TOKEN_SECRET_TYPE = "kubernetes.io/service-account-token"
SA_ANNOTATION = "kubernetes.io/service-account.name"
DEFAULT_SA = "default"


class ServiceAccountsController(PeriodicRunner):
    """serviceaccounts_controller.go: default SA per namespace."""

    SYNC_PERIOD = 1.0
    THREAD_NAME = "serviceaccount"

    def __init__(self, client: RESTClient, informers):
        self.client = client
        self.ns_informer = informers.namespaces()
        self.sa_informer = informers.service_accounts()

    def sync_once(self) -> int:
        created = 0
        have = {
            (sa.metadata.namespace, sa.metadata.name)
            for sa in self.sa_informer.store.list()
        }
        for ns in self.ns_informer.store.list():
            if ns.status.phase == "Terminating":
                continue
            if (ns.metadata.name, DEFAULT_SA) in have:
                continue
            try:
                self.client.resource(
                    "serviceaccounts", ns.metadata.name
                ).create(
                    t.ServiceAccount(
                        metadata=t.ObjectMeta(
                            name=DEFAULT_SA, namespace=ns.metadata.name
                        )
                    )
                )
                created += 1
            except APIStatusError as e:
                if e.code != 409:
                    raise
        return created


class TokensController(PeriodicRunner):
    """tokens_controller.go: a signed token secret per ServiceAccount."""

    SYNC_PERIOD = 1.0
    THREAD_NAME = "sa-tokens"

    def __init__(self, client: RESTClient, informers, private_key):
        self.client = client
        self.generator = TokenGenerator(private_key)
        self.sa_informer = informers.service_accounts()
        self.secret_informer = informers.secrets()

    def sync_once(self) -> int:
        minted = 0
        secrets = {
            (s.metadata.namespace, s.metadata.name): s
            for s in self.secret_informer.store.list()
            if s.type == TOKEN_SECRET_TYPE
        }
        for sa in self.sa_informer.store.list():
            ns = sa.metadata.namespace
            live = [
                name for name in sa.secrets if (ns, name) in secrets
            ]
            if live:
                continue
            # UNIQUE name per mint (the reference's GenerateName idiom):
            # rotation must issue a token whose secret.name claim the old
            # token can never satisfy, and a recreated same-name SA must
            # never adopt a stale secret
            secret_name = f"{sa.metadata.name}-token-{uuid.uuid4().hex[:5]}"
            token = self.generator.generate(
                ns, sa.metadata.name, sa.metadata.uid, secret_name
            )
            secret = t.Secret(
                metadata=t.ObjectMeta(
                    name=secret_name,
                    namespace=ns,
                    annotations={SA_ANNOTATION: sa.metadata.name},
                ),
                type=TOKEN_SECRET_TYPE,
                data={
                    "token": base64.b64encode(token.encode()).decode(),
                    "namespace": base64.b64encode(ns.encode()).decode(),
                },
            )
            try:
                self.client.resource("secrets", ns).create(secret)
            except APIStatusError:
                continue  # next pass retries with a fresh name
            try:
                fresh = self.client.resource(
                    "serviceaccounts", ns
                ).get(sa.metadata.name)
                if secret_name not in fresh.secrets:
                    fresh.secrets.append(secret_name)
                    self.client.resource(
                        "serviceaccounts", ns
                    ).update(fresh)
            except APIStatusError:
                continue  # SA deleted mid-pass; cleanup reaps the secret
            minted += 1
        self._cleanup(secrets)
        return minted

    def _cleanup(self, secrets) -> None:
        """tokens_controller.go secret deletion: reap token secrets whose
        ServiceAccount is gone or no longer references them (rotation
        leftovers). The reference check is against a LIVE read of the SA
        so informer lag can't reap a just-minted secret."""
        for (ns, name), secret in secrets.items():
            owner = secret.metadata.annotations.get(SA_ANNOTATION, "")
            if not owner:
                continue  # not a controller-managed secret
            try:
                sa = self.client.resource("serviceaccounts", ns).get(owner)
                if name in sa.secrets:
                    continue
            except APIStatusError as e:
                if e.code != 404:
                    continue
            try:
                self.client.resource("secrets", ns).delete(name)
            except APIStatusError:
                pass


def make_token_lookup(client: RESTClient):
    """The JWTTokenAuthenticator TokenGetter: token valid only while its
    ServiceAccount exists and still references the secret."""

    def lookup(namespace: str, sa_name: str, secret_name: str) -> bool:
        try:
            sa = client.resource("serviceaccounts", namespace).get(sa_name)
        except APIStatusError:
            return False
        if secret_name and secret_name not in sa.secrets:
            return False
        if secret_name:
            try:
                client.resource("secrets", namespace).get(secret_name)
            except APIStatusError:
                return False
        return True

    return lookup
