"""Authentication + authorization (pkg/auth + plugin/pkg/auth).

Authenticators turn request credentials into a UserInfo; authorizers
decide whether that user may perform an action. The apiserver's HTTP
frontend consults them when configured (anonymous/in-process requests
bypass auth, the integration-test posture).

Copy of kubernetes_tpu/auth/__init__.py: only the import package differs."""

from kubernetes_tpu_torch.auth.authn import (
    AuthenticationError,
    Authenticator,
    BasicAuthAuthenticator,
    TokenAuthenticator,
    UnionAuthenticator,
    UserInfo,
)
from kubernetes_tpu_torch.auth.rbac import RBACAuthorizer
from kubernetes_tpu_torch.auth.authz import (
    ABACAuthorizer,
    ABACPolicy,
    AlwaysAllow,
    AlwaysDeny,
    Authorizer,
    Forbidden,
    UnionAuthorizer,
)

__all__ = [
    "ABACAuthorizer",
    "ABACPolicy",
    "AlwaysAllow",
    "AlwaysDeny",
    "AuthenticationError",
    "Authenticator",
    "Authorizer",
    "BasicAuthAuthenticator",
    "Forbidden",
    "TokenAuthenticator",
    "UnionAuthenticator",
    "UserInfo",
]
