"""ServiceAccount JWT tokens (pkg/serviceaccount/jwt.go).

The reference mints RS256 JWTs for service accounts (claims
Iss/Sub/kubernetes.io/serviceaccount/* — jwt.go:59-86) and
authenticates requests bearing them (jwt.go:97-170). Same here, built
on the cryptography package: TokenGenerator signs, JWTTokenAuthenticator
verifies signature + claims and (optionally) that the account and
secret still exist, slotting into the standard authenticator union.

Copy of kubernetes_tpu/auth/serviceaccount.py: only the import package differs.
"""

from __future__ import annotations

import base64
import json
from typing import Callable, Dict, Optional

# gated: cryptography is an optional dependency. Importing this module
# (and everything above it: controller manager, hyperkube) must work
# without it; only actually minting/verifying service-account JWTs
# requires the library.
try:
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding, rsa

    HAVE_CRYPTOGRAPHY = True
except ImportError:  # pragma: no cover - exercised only on slim images
    hashes = serialization = padding = rsa = None  # type: ignore
    HAVE_CRYPTOGRAPHY = False


def _require_crypto() -> None:
    if not HAVE_CRYPTOGRAPHY:
        raise ImportError(
            "No module named 'cryptography' — service-account JWT "
            "signing/verification requires it"
        )

from kubernetes_tpu_torch.auth.authn import (
    AuthenticationError,
    Authenticator,
    UserInfo,
)

ISSUER = "kubernetes/serviceaccount"
_NS_CLAIM = "kubernetes.io/serviceaccount/namespace"
_NAME_CLAIM = "kubernetes.io/serviceaccount/service-account.name"
_UID_CLAIM = "kubernetes.io/serviceaccount/service-account.uid"
_SECRET_CLAIM = "kubernetes.io/serviceaccount/secret.name"

SERVICE_ACCOUNT_USERNAME_PREFIX = "system:serviceaccount:"
ALL_GROUP = "system:serviceaccounts"


def generate_key() -> rsa.RSAPrivateKey:
    """A fresh signing key (the --service-account-private-key-file
    stand-in for tests/local-up)."""
    _require_crypto()
    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def load_private_key_pem(data: bytes) -> rsa.RSAPrivateKey:
    _require_crypto()
    return serialization.load_pem_private_key(data, password=None)


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(text: str) -> bytes:
    pad = -len(text) % 4
    return base64.urlsafe_b64decode(text + "=" * pad)


def username(namespace: str, name: str) -> str:
    return f"{SERVICE_ACCOUNT_USERNAME_PREFIX}{namespace}:{name}"


def namespace_group(namespace: str) -> str:
    return f"{ALL_GROUP}:{namespace}"


class TokenGenerator:
    """jwt.go JWTTokenGenerator: mints RS256 service-account JWTs."""

    def __init__(self, private_key: rsa.RSAPrivateKey):
        _require_crypto()
        self.private_key = private_key

    def generate(self, namespace: str, sa_name: str, sa_uid: str,
                 secret_name: str) -> str:
        header = {"alg": "RS256", "typ": "JWT"}
        claims = {
            "iss": ISSUER,
            "sub": username(namespace, sa_name),
            _NS_CLAIM: namespace,
            _NAME_CLAIM: sa_name,
            _UID_CLAIM: sa_uid,
            _SECRET_CLAIM: secret_name,
        }
        signing_input = (
            _b64(json.dumps(header, separators=(",", ":")).encode())
            + "."
            + _b64(json.dumps(claims, separators=(",", ":")).encode())
        ).encode()
        sig = self.private_key.sign(
            signing_input, padding.PKCS1v15(), hashes.SHA256()
        )
        return signing_input.decode() + "." + _b64(sig)


class JWTTokenAuthenticator(Authenticator):
    """jwt.go JWTTokenAuthenticator: verifies Bearer service-account
    JWTs. `lookup(namespace, sa_name, secret_name) -> bool` optionally
    rejects tokens whose account or secret is gone (TokenGetter)."""

    def __init__(self, public_key, lookup: Optional[Callable] = None):
        _require_crypto()
        self.public_key = public_key
        self.lookup = lookup

    def _verify(self, token: str) -> Optional[Dict]:
        parts = token.split(".")
        if len(parts) != 3:
            return None
        signing_input = f"{parts[0]}.{parts[1]}".encode()
        try:
            header = json.loads(_unb64(parts[0]))
            if header.get("alg") != "RS256":
                return None
            self.public_key.verify(
                _unb64(parts[2]), signing_input,
                padding.PKCS1v15(), hashes.SHA256(),
            )
            claims = json.loads(_unb64(parts[1]))
        except Exception:
            return None
        if claims.get("iss") != ISSUER:
            return None
        return claims

    def authenticate(self, headers: Dict[str, str]) -> Optional[UserInfo]:
        auth = headers.get("Authorization", "") or headers.get(
            "authorization", ""
        )
        if not auth.startswith("Bearer "):
            return None
        claims = self._verify(auth[len("Bearer "):].strip())
        if claims is None:
            return None  # not an SA token (or bad): next authenticator
        ns = claims.get(_NS_CLAIM, "")
        name = claims.get(_NAME_CLAIM, "")
        secret = claims.get(_SECRET_CLAIM, "")
        if not ns or not name:
            raise AuthenticationError("malformed service account claims")
        if self.lookup is not None and not self.lookup(ns, name, secret):
            raise AuthenticationError(
                f"service account {ns}/{name} (secret {secret}) has been "
                "deleted or rotated"
            )
        return UserInfo(
            name=username(ns, name),
            uid=claims.get(_UID_CLAIM, ""),
            groups=(ALL_GROUP, namespace_group(ns)),
        )
