"""Authenticators (pkg/auth/authenticator + plugin/pkg/auth/authenticator).

Bearer-token (tokenfile.go: csv token,user,uid[,groups]) and HTTP basic
(passwordfile.go) request authenticators, unioned like
pkg/auth/authenticator/request/union.

Copy of kubernetes_tpu/auth/authn.py: only the import package differs."""

from __future__ import annotations

import base64
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class UserInfo:
    name: str
    uid: str = ""
    groups: Tuple[str, ...] = ()


class AuthenticationError(Exception):
    pass


class Authenticator:
    def authenticate(self, headers: Dict[str, str]) -> Optional[UserInfo]:
        """UserInfo, None (no opinion: try the next authenticator), or
        raise AuthenticationError (credentials present but invalid)."""
        raise NotImplementedError


class TokenAuthenticator(Authenticator):
    """bearertoken + tokenfile: 'Authorization: Bearer <token>'."""

    def __init__(self, tokens: Dict[str, UserInfo]):
        self.tokens = dict(tokens)

    @classmethod
    def from_csv(cls, text: str) -> "TokenAuthenticator":
        """token,user,uid[,\"group1,group2\"] per line (tokenfile.go)."""
        import csv
        import io

        tokens = {}
        for row in csv.reader(io.StringIO(text)):
            if not row or row[0].startswith("#"):
                continue
            token, user = row[0].strip(), row[1].strip()
            uid = row[2].strip() if len(row) > 2 else ""
            groups = tuple(
                g.strip() for g in row[3].split(",")
            ) if len(row) > 3 else ()
            tokens[token] = UserInfo(user, uid, groups)
        return cls(tokens)

    def authenticate(self, headers) -> Optional[UserInfo]:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Bearer "):
            return None
        token = auth[len("Bearer "):].strip()
        user = self.tokens.get(token)
        if user is None:
            raise AuthenticationError("invalid bearer token")
        return user


class BasicAuthAuthenticator(Authenticator):
    """basicauth + passwordfile: 'Authorization: Basic <b64 user:pass>'."""

    def __init__(self, passwords: Dict[str, Tuple[str, UserInfo]]):
        # user -> (password, info)
        self.passwords = dict(passwords)

    def authenticate(self, headers) -> Optional[UserInfo]:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Basic "):
            return None
        try:
            decoded = base64.b64decode(auth[len("Basic "):]).decode()
            user, _, password = decoded.partition(":")
        except Exception:
            raise AuthenticationError("malformed basic auth")
        entry = self.passwords.get(user)
        if entry is None or entry[0] != password:
            raise AuthenticationError("invalid username/password")
        return entry[1]


class UnionAuthenticator(Authenticator):
    """request/union: first authenticator with an opinion wins."""

    def __init__(self, authenticators: List[Authenticator]):
        self.authenticators = list(authenticators)

    def authenticate(self, headers) -> Optional[UserInfo]:
        for a in self.authenticators:
            user = a.authenticate(headers)
            if user is not None:
                return user
        return None
