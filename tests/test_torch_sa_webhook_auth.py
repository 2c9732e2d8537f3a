"""ServiceAccount JWT tokens + webhook authn/authz (VERDICT r2 #10).

Reference: pkg/serviceaccount/jwt.go (RS256 token mint/verify),
pkg/serviceaccount/{serviceaccounts,tokens}_controller.go (default SA +
token secrets), plugin/pkg/auth/authenticator/token/webhook +
plugin/pkg/auth/authorizer/webhook (TokenReview / SubjectAccessReview
over HTTP, cached, authz failing closed).

The cases of tests/test_sa_webhook_auth.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there.
"""

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.auth.authn import (
    AuthenticationError,
    TokenAuthenticator,
    UnionAuthenticator,
    UserInfo,
)
from kubernetes_tpu_torch.auth.authz import ABACAuthorizer, Attributes
from kubernetes_tpu_torch.auth.serviceaccount import (
    JWTTokenAuthenticator,
    TokenGenerator,
    generate_key,
)
from kubernetes_tpu_torch.auth.webhook import (
    WebhookAuthorizer,
    WebhookTokenAuthenticator,
)
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient
from kubernetes_tpu_torch.client.transport import HTTPTransport, LocalTransport
from kubernetes_tpu_torch.controller.manager import (
    ControllerManager,
    ControllerManagerOptions,
)
from kubernetes_tpu_torch.controller.serviceaccount import make_token_lookup


from conftest import wait_until  # noqa: E402


KEY = generate_key()  # RSA keygen is slow; share across tests


class TestJWT:
    def test_mint_and_verify(self):
        gen = TokenGenerator(KEY)
        token = gen.generate("team-a", "deployer", "uid-1", "deployer-token")
        authn = JWTTokenAuthenticator(KEY.public_key())
        user = authn.authenticate({"Authorization": f"Bearer {token}"})
        assert user.name == "system:serviceaccount:team-a:deployer"
        assert user.uid == "uid-1"
        assert set(user.groups) == {
            "system:serviceaccounts", "system:serviceaccounts:team-a"
        }

    def test_tampered_and_foreign_tokens_rejected(self):
        gen = TokenGenerator(KEY)
        token = gen.generate("ns", "sa", "u", "s")
        authn = JWTTokenAuthenticator(KEY.public_key())
        head, payload, sig = token.split(".")
        # swap the namespace claim: signature check must fail -> no
        # opinion (falls through the union, ends 401 with nothing else)
        claims = json.loads(
            base64.urlsafe_b64decode(payload + "=" * (-len(payload) % 4))
        )
        claims["kubernetes.io/serviceaccount/namespace"] = "kube-system"
        forged = base64.urlsafe_b64encode(
            json.dumps(claims).encode()
        ).rstrip(b"=").decode()
        assert authn.authenticate(
            {"Authorization": f"Bearer {head}.{forged}.{sig}"}
        ) is None
        # token signed by a different key
        other = TokenGenerator(generate_key()).generate("ns", "sa", "u", "s")
        assert authn.authenticate(
            {"Authorization": f"Bearer {other}"}
        ) is None
        # non-JWT bearer tokens are not our business
        assert authn.authenticate(
            {"Authorization": "Bearer plain-old-token"}
        ) is None

    def test_lookup_rejects_deleted_account(self):
        gen = TokenGenerator(KEY)
        token = gen.generate("ns", "gone", "u", "gone-token")
        authn = JWTTokenAuthenticator(
            KEY.public_key(), lookup=lambda ns, name, secret: False
        )
        with pytest.raises(AuthenticationError):
            authn.authenticate({"Authorization": f"Bearer {token}"})


class TestControllersEndToEnd:
    def test_default_sa_token_and_tls_frontend_auth(self, tmp_path):
        """The controllers mint default/default's token; a client using
        it against the HTTPS frontend authenticates as the SA and ABAC
        authorizes it; deleting the SA kills the token (lookup)."""
        server = APIServer()
        local = RESTClient(LocalTransport(server))
        cm = ControllerManager(
            local,
            ControllerManagerOptions(service_account_private_key=KEY),
        ).start()
        try:
            # namespace exists (auto-provisioned on first write)
            local.pods().create(t.Pod(
                metadata=t.ObjectMeta(name="seed"),
                spec=t.PodSpec(containers=[t.Container(name="c")]),
            ))
            assert wait_until(lambda: _token(local) is not None)
            token = _token(local)

            # lock the frontend down: SA JWTs + ABAC for the SA user
            server.authenticator = UnionAuthenticator([
                JWTTokenAuthenticator(
                    KEY.public_key(), lookup=make_token_lookup(local)
                ),
            ])
            server.authorizer = ABACAuthorizer.from_jsonl(json.dumps({
                "user": "system:serviceaccount:default:default",
                "resource": "pods", "namespace": "default",
                "readonly": True,
            }))
            host, port = server.serve_http(port=0)
            authed = RESTClient(HTTPTransport(
                f"http://{host}:{port}",
                bearer_token=token,
            ))
            pods, _rv = authed.pods().list()
            assert [p.metadata.name for p in pods] == ["seed"]
            # ABAC: readonly only — a write is 403
            with pytest.raises(APIStatusError) as ei:
                authed.pods().create(t.Pod(
                    metadata=t.ObjectMeta(name="nope"),
                    spec=t.PodSpec(containers=[t.Container(name="c")]),
                ))
            assert ei.value.code == 403
            # no token at all: 401
            anon = RESTClient(HTTPTransport(f"http://{host}:{port}"))
            with pytest.raises(APIStatusError) as ei:
                anon.pods().list()
            assert ei.value.code == 401
            # rotation: deleting the token secret revokes the OLD token
            # (unique secret names — the re-mint can never resurrect it)
            sa = local.resource("serviceaccounts", "default").get("default")
            old_secret = sa.secrets[0]
            local.resource("secrets", "default").delete(old_secret)
            sa.secrets = []
            local.resource("serviceaccounts", "default").update(sa)
            assert wait_until(
                lambda: (_token(local) or "") not in ("", token)
            )
            with pytest.raises(APIStatusError) as ei:
                authed.pods().list()  # old token: dead
            assert ei.value.code == 401
            rotated = RESTClient(HTTPTransport(
                f"http://{host}:{port}", bearer_token=_token(local)
            ))
            assert rotated.pods().list()[0]  # new token: live
            # delete the SA: its token dies with it and the orphaned
            # secret is reaped
            local.resource("serviceaccounts", "default").delete("default")
            with pytest.raises(APIStatusError) as ei:
                rotated.pods().list()
            assert ei.value.code == 401
            def _reaped():
                names = [
                    s.metadata.name
                    for s in local.resource("secrets", "default").list()[0]
                    if s.type == "kubernetes.io/service-account-token"
                ]
                return not names
            # (the SA controller recreates default/default, which mints
            # a fresh secret; the ORPHANED one must be gone)
            assert wait_until(lambda: (_token(local) is not None) or _reaped())
        finally:
            server.shutdown_http()
            cm.stop()


def _token(client):
    try:
        sa = client.resource("serviceaccounts", "default").get("default")
    except APIStatusError:
        return None
    for name in sa.secrets:
        try:
            sec = client.resource("secrets", "default").get(name)
        except APIStatusError:
            continue
        if sec.type == "kubernetes.io/service-account-token":
            return base64.b64decode(sec.data["token"]).decode()
    return None


class _Webhook(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


def _webhook(respond):
    """A fake TokenReview/SubjectAccessReview endpoint."""
    calls = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n))
            calls.append(body)
            data = json.dumps(respond(body)).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    srv = _Webhook(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}", calls


class TestWebhooks:
    def test_token_review(self):
        def respond(body):
            ok = body["spec"]["token"] == "good"
            status = {"authenticated": ok}
            if ok:
                status["user"] = {"username": "alice", "uid": "a1",
                                  "groups": ["dev"]}
            return {"kind": "TokenReview", "status": status}

        srv, url, calls = _webhook(respond)
        try:
            authn = WebhookTokenAuthenticator(url, cache_ttl=60)
            user = authn.authenticate({"Authorization": "Bearer good"})
            assert user == UserInfo(name="alice", uid="a1", groups=("dev",))
            assert authn.authenticate(
                {"Authorization": "Bearer bad"}
            ) is None
            # verdicts (accept AND reject) are cached
            n = len(calls)
            authn.authenticate({"Authorization": "Bearer good"})
            authn.authenticate({"Authorization": "Bearer bad"})
            assert len(calls) == n
        finally:
            srv.shutdown()
            srv.server_close()

    def test_token_review_webhook_down_is_no_opinion(self):
        authn = WebhookTokenAuthenticator(
            "http://127.0.0.1:1", timeout=0.2
        )
        union = UnionAuthenticator([
            authn,
            TokenAuthenticator({"fallback": UserInfo(name="bob")}),
        ])
        # webhook unreachable: union continues to the static tokens
        assert union.authenticate(
            {"Authorization": "Bearer fallback"}
        ).name == "bob"

    def test_subject_access_review_and_fail_closed(self):
        def respond(body):
            spec = body["spec"]
            # the client ships mapped API verbs (a GET on a
            # collection reviews as "list"), like upstream
            allowed = (
                spec["user"] == "alice"
                and spec["resourceAttributes"]["verb"] == "list"
            )
            return {"kind": "SubjectAccessReview",
                    "status": {"allowed": allowed}}

        srv, url, calls = _webhook(respond)
        alice = UserInfo(name="alice")
        attrs_get = Attributes(user=alice, verb="GET", resource="pods",
                               namespace="default")
        attrs_post = Attributes(user=alice, verb="POST", resource="pods",
                                namespace="default")
        try:
            authz = WebhookAuthorizer(url, cache_ttl=60)
            assert authz.authorize(attrs_get) is True
            assert authz.authorize(attrs_post) is False
            n = len(calls)
            assert authz.authorize(attrs_get) is True  # cached
            assert len(calls) == n
        finally:
            srv.shutdown()
            srv.server_close()
        # unreachable authorizer must DENY, not allow
        dead = WebhookAuthorizer("http://127.0.0.1:1", timeout=0.2)
        assert dead.authorize(attrs_get) is False


# -- RBAC (pkg/apis/rbac + the rbac authorizer) ------------------------------


class TestRBAC:
    def _plane(self):
        import subprocess

        from kubernetes_tpu_torch.api import types as t
        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.auth.authn import (
            TokenAuthenticator,
            UserInfo,
        )
        from kubernetes_tpu_torch.auth.rbac import RBACAuthorizer
        from kubernetes_tpu_torch.client.rest import RESTClient
        from kubernetes_tpu_torch.client.transport import LocalTransport

        api = APIServer(
            authenticator=TokenAuthenticator({
                "alice-token": UserInfo(name="alice", groups=("devs",)),
                "bob-token": UserInfo(name="bob", groups=("ops",)),
            }),
        )
        api.authorizer = RBACAuthorizer(api)
        admin = RESTClient(LocalTransport(api))  # bypasses HTTP auth
        return api, admin, t

    @staticmethod
    def _grant(admin, t, name, ns, rules, subjects, cluster=False):
        if cluster:
            admin.resource("clusterroles").create(
                t.ClusterRole(metadata=t.ObjectMeta(name=name, namespace=""),
                              rules=rules))
            admin.resource("clusterrolebindings").create(
                t.ClusterRoleBinding(
                    metadata=t.ObjectMeta(name=f"{name}-b", namespace=""),
                    subjects=subjects,
                    role_ref=t.RoleRef(kind="ClusterRole", name=name)))
        else:
            admin.resource("roles", ns).create(
                t.Role(metadata=t.ObjectMeta(name=name, namespace=ns),
                       rules=rules))
            admin.resource("rolebindings", ns).create(
                t.RoleBinding(
                    metadata=t.ObjectMeta(name=f"{name}-b", namespace=ns),
                    subjects=subjects,
                    role_ref=t.RoleRef(kind="Role", name=name)))

    def test_namespace_scoping_and_verbs(self):
        import urllib.request
        import urllib.error

        api, admin, t = self._plane()
        self._grant(
            admin, t, "pod-reader", "default",
            rules=[t.PolicyRule(verbs=["get", "list"],
                                resources=["pods"])],
            subjects=[t.RBACSubject(kind="User", name="alice")],
        )
        host, port = api.serve_http()
        base = f"http://{host}:{port}"

        def req(path, token, method="GET", data=None):
            r = urllib.request.Request(
                f"{base}{path}", method=method, data=data,
                headers={"Authorization": f"Bearer {token}",
                         **({"Content-Type": "application/json"}
                            if data else {})},
            )
            return urllib.request.urlopen(r, timeout=10).status

        # alice reads pods in default
        assert req("/api/v1/namespaces/default/pods", "alice-token") == 200
        # ...but cannot write them (verb not granted)
        with pytest.raises(urllib.error.HTTPError) as ei:
            req("/api/v1/namespaces/default/pods", "alice-token",
                method="POST",
                data=b'{"kind":"Pod","metadata":{"name":"x"},'
                     b'"spec":{"containers":[{"name":"c"}]}}')
        assert ei.value.code == 403
        # ...and not in another namespace (RoleBinding is namespaced)
        with pytest.raises(urllib.error.HTTPError) as ei:
            req("/api/v1/namespaces/other/pods", "alice-token")
        assert ei.value.code == 403
        # bob has no grants at all: deny-by-default
        with pytest.raises(urllib.error.HTTPError) as ei:
            req("/api/v1/namespaces/default/pods", "bob-token")
        assert ei.value.code == 403

    def test_group_subject_and_cluster_wildcards(self):
        import urllib.request
        import urllib.error

        api, admin, t = self._plane()
        # ops group gets cluster-admin-ish wildcard rules
        self._grant(
            admin, t, "admin",  "",
            rules=[t.PolicyRule(verbs=["*"], api_groups=["*"],
                                resources=["*"])],
            subjects=[t.RBACSubject(kind="Group", name="ops")],
            cluster=True,
        )
        host, port = api.serve_http()
        base = f"http://{host}:{port}"

        def req(path, token, method="GET"):
            r = urllib.request.Request(
                f"{base}{path}", method=method,
                headers={"Authorization": f"Bearer {token}"})
            return urllib.request.urlopen(r, timeout=10).status

        # bob (group ops) can read anything, any namespace, any group
        assert req("/api/v1/namespaces/x/pods", "bob-token") == 200
        assert req("/apis/extensions/v1beta1/namespaces/x/replicasets",
                   "bob-token") == 200
        assert req("/api/v1/nodes", "bob-token") == 200
        # alice is not in ops
        with pytest.raises(urllib.error.HTTPError) as ei:
            req("/api/v1/nodes", "alice-token")
        assert ei.value.code == 403

    def test_resource_names_and_api_groups(self):
        from kubernetes_tpu_torch.auth.authz import Attributes
        from kubernetes_tpu_torch.auth.authn import UserInfo
        from kubernetes_tpu_torch.auth.rbac import RBACAuthorizer

        api, admin, t = self._plane()
        self._grant(
            admin, t, "one-cm", "default",
            rules=[t.PolicyRule(verbs=["get"], resources=["configmaps"],
                                resource_names=["the-one"])],
            subjects=[t.RBACSubject(kind="User", name="alice")],
        )
        rbac = api.authorizer
        alice = UserInfo(name="alice", groups=("devs",))

        def attrs(**kw):
            return Attributes(user=alice, verb="GET",
                              resource="configmaps",
                              namespace="default", **kw)

        assert rbac.authorize(attrs(name="the-one"))
        assert not rbac.authorize(attrs(name="another"))
        assert not rbac.authorize(attrs())  # list needs no-name grant
        # core-group rule does not bleed into named groups
        ext = Attributes(user=alice, verb="GET", resource="configmaps",
                         namespace="default", name="the-one",
                         api_group="extensions")
        assert not rbac.authorize(ext)

    def test_subresource_watch_and_nonresource_semantics(self):
        from kubernetes_tpu_torch.auth.authn import UserInfo
        from kubernetes_tpu_torch.auth.authz import Attributes

        api, admin, t = self._plane()
        self._grant(
            admin, t, "narrow", "default",
            rules=[
                t.PolicyRule(verbs=["update"], resources=["pods/status"]),
                t.PolicyRule(verbs=["watch"], resources=["pods"]),
                t.PolicyRule(verbs=["get"],
                             non_resource_urls=["/healthz", "/debug/*"]),
            ],
            subjects=[t.RBACSubject(kind="User", name="alice")],
        )
        rbac = api.authorizer
        alice = UserInfo(name="alice", groups=())

        def attrs(**kw):
            base = dict(user=alice, verb="GET", resource="pods",
                        namespace="default")
            base.update(kw)
            return Attributes(**base)

        # pods/status grant covers ONLY the status subresource
        assert rbac.authorize(attrs(verb="PUT", name="p",
                                    subresource="status"))
        assert not rbac.authorize(attrs(verb="PUT", name="p"))
        # watch is its own verb: granted explicitly, not via list
        assert rbac.authorize(attrs(query_watch=True))
        assert not rbac.authorize(attrs())  # plain list not granted
        # nonResourceURLs: exact + trailing-star prefix
        assert rbac.authorize(attrs(resource="", path="/healthz"))
        assert rbac.authorize(attrs(resource="",
                                    path="/debug/pprof/goroutine"))
        assert not rbac.authorize(attrs(resource="", path="/metrics"))

    def test_rbac_objects_ride_the_json_wire(self):
        """Role round-trips through the plain-JSON HTTP transport (the
        kind registry regression: object-protocol tests can't catch a
        missing scheme registration)."""
        from kubernetes_tpu_torch.api import types as t
        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.client.rest import RESTClient
        from kubernetes_tpu_torch.client.transport import HTTPTransport

        api = APIServer()
        host, port = api.serve_http()
        client = RESTClient(HTTPTransport(f"http://{host}:{port}"))
        role = t.Role(
            metadata=t.ObjectMeta(name="reader"),
            rules=[t.PolicyRule(verbs=["get"], resources=["pods"])],
        )
        created = client.resource("roles", "default").create(role)
        assert type(created) is t.Role
        got = client.resource("roles", "default").get("reader")
        assert got.rules[0].verbs == ["get"]
        crb = t.ClusterRoleBinding(
            metadata=t.ObjectMeta(name="b", namespace=""),
            subjects=[t.RBACSubject(kind="Group", name="ops")],
            role_ref=t.RoleRef(kind="ClusterRole", name="admin"),
        )
        client.resource("clusterrolebindings").create(crb)
        items, _ = client.resource("clusterrolebindings").list()
        assert items[0].subjects[0].name == "ops"


class TestReviewEndpoints:
    """The SERVER side of the webhook wire: this apiserver answers
    TokenReview and SubjectAccessReview, so the existing webhook
    CLIENTS can point one apiserver's authn/authz at another's."""

    def _api(self):
        from kubernetes_tpu_torch.api import types as t
        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.auth.authn import TokenAuthenticator, UserInfo
        from kubernetes_tpu_torch.auth.rbac import RBACAuthorizer
        from kubernetes_tpu_torch.client.rest import RESTClient
        from kubernetes_tpu_torch.client.transport import LocalTransport

        api = APIServer(authenticator=TokenAuthenticator({
            "good-token": UserInfo(name="carol", uid="u1",
                                   groups=("qa",)),
        }))
        api.authorizer = RBACAuthorizer(api)
        admin = RESTClient(LocalTransport(api))
        admin.resource("clusterroles").create(t.ClusterRole(
            metadata=t.ObjectMeta(name="viewer", namespace=""),
            rules=[t.PolicyRule(verbs=["get", "list"],
                                resources=["pods"])]))
        admin.resource("clusterrolebindings").create(t.ClusterRoleBinding(
            metadata=t.ObjectMeta(name="viewer-b", namespace=""),
            subjects=[t.RBACSubject(kind="Group", name="qa")],
            role_ref=t.RoleRef(kind="ClusterRole", name="viewer")))
        return api

    def test_tokenreview_round_trip(self):
        api = self._api()
        code, out = api.handle(
            "POST",
            "/apis/authentication.k8s.io/v1beta1/tokenreviews",
            body={"kind": "TokenReview",
                  "spec": {"token": "good-token"}},
        )
        assert code == 201
        assert out["status"]["authenticated"] is True
        assert out["status"]["user"]["username"] == "carol"
        assert out["status"]["user"]["groups"] == ["qa"]
        code, out = api.handle(
            "POST",
            "/apis/authentication.k8s.io/v1beta1/tokenreviews",
            body={"kind": "TokenReview", "spec": {"token": "bogus"}},
        )
        assert out["status"]["authenticated"] is False

    def test_subjectaccessreview_round_trip(self):
        api = self._api()

        def sar(spec):
            code, out = api.handle(
                "POST",
                "/apis/authorization.k8s.io/v1beta1/subjectaccessreviews",
                body={"kind": "SubjectAccessReview", "spec": spec},
            )
            assert code == 201
            return out["status"]["allowed"]

        assert sar({"user": "carol", "groups": ["qa"],
                    "resourceAttributes": {"verb": "get",
                                           "resource": "pods",
                                           "name": "p1",
                                           "namespace": "x"}})
        assert not sar({"user": "carol", "groups": ["qa"],
                        "resourceAttributes": {"verb": "create",
                                               "resource": "pods",
                                               "namespace": "x"}})
        assert not sar({"user": "mallory", "groups": [],
                        "resourceAttributes": {"verb": "get",
                                               "resource": "pods"}})

    def test_webhook_clients_point_at_this_server(self):
        """The loop closes: WebhookTokenAuthenticator /
        WebhookAuthorizer against OUR endpoints."""
        from kubernetes_tpu_torch.auth.authn import UserInfo
        from kubernetes_tpu_torch.auth.authz import Attributes
        from kubernetes_tpu_torch.auth.webhook import (
            WebhookAuthorizer,
            WebhookTokenAuthenticator,
        )

        from kubernetes_tpu_torch.api import types as t
        from kubernetes_tpu_torch.client.rest import RESTClient
        from kubernetes_tpu_torch.client.transport import LocalTransport

        api = self._api()
        # the caller of a review endpoint authenticates and needs the
        # auth-delegator grants (create tokenreviews/SARs)
        admin = RESTClient(LocalTransport(api))
        admin.resource("clusterroles").create(t.ClusterRole(
            metadata=t.ObjectMeta(name="auth-delegator", namespace=""),
            rules=[t.PolicyRule(
                verbs=["create"],
                api_groups=["*"],
                resources=["tokenreviews", "subjectaccessreviews"])]))
        admin.resource("clusterrolebindings").create(t.ClusterRoleBinding(
            metadata=t.ObjectMeta(name="auth-delegator-b", namespace=""),
            subjects=[t.RBACSubject(kind="User", name="carol")],
            role_ref=t.RoleRef(kind="ClusterRole",
                               name="auth-delegator")))
        host, port = api.serve_http()
        base = f"http://{host}:{port}"
        wa = WebhookTokenAuthenticator(
            f"{base}/apis/authentication.k8s.io/v1beta1/tokenreviews",
            bearer_token="good-token")
        user = wa.authenticate(
            {"Authorization": "Bearer good-token"})
        assert user is not None and user.name == "carol"
        assert wa.authenticate({"Authorization": "Bearer nope"}) is None
        wz = WebhookAuthorizer(
            f"{base}/apis/authorization.k8s.io/v1beta1/"
            "subjectaccessreviews", bearer_token="good-token")
        carol = UserInfo(name="carol", groups=("qa",))
        assert wz.authorize(Attributes(
            user=carol, verb="get", resource="pods", namespace="x",
            name="p1"))
        assert not wz.authorize(Attributes(
            user=carol, verb="create", resource="pods", namespace="x"))

    def test_sar_cache_keys_on_the_full_request(self):
        """A cached named-get verdict must not answer a collection
        list (the cache-key collision would be privilege escalation
        under resourceNames grants)."""
        from kubernetes_tpu_torch.auth.authn import UserInfo
        from kubernetes_tpu_torch.auth.authz import Attributes
        from kubernetes_tpu_torch.auth.webhook import WebhookAuthorizer

        api = self._api()
        admin_calls = []
        # grant carol get on pod p1 ONLY (resourceNames)
        from kubernetes_tpu_torch.api import types as t
        from kubernetes_tpu_torch.client.rest import RESTClient
        from kubernetes_tpu_torch.client.transport import LocalTransport

        admin = RESTClient(LocalTransport(api))
        admin.resource("clusterroles").create(t.ClusterRole(
            metadata=t.ObjectMeta(name="p1-only", namespace=""),
            rules=[t.PolicyRule(verbs=["get"], resources=["secrets"],
                                resource_names=["p1"])]))
        admin.resource("clusterrolebindings").create(t.ClusterRoleBinding(
            metadata=t.ObjectMeta(name="p1-only-b", namespace=""),
            subjects=[t.RBACSubject(kind="User", name="carol")],
            role_ref=t.RoleRef(kind="ClusterRole", name="p1-only")))
        admin.resource("clusterroles").create(t.ClusterRole(
            metadata=t.ObjectMeta(name="delegate", namespace=""),
            rules=[t.PolicyRule(verbs=["create"], api_groups=["*"],
                                resources=["subjectaccessreviews"])]))
        admin.resource("clusterrolebindings").create(t.ClusterRoleBinding(
            metadata=t.ObjectMeta(name="delegate-b", namespace=""),
            subjects=[t.RBACSubject(kind="User", name="carol")],
            role_ref=t.RoleRef(kind="ClusterRole", name="delegate")))
        host, port = api.serve_http()
        wz = WebhookAuthorizer(
            f"http://{host}:{port}/apis/authorization.k8s.io/v1beta1/"
            "subjectaccessreviews", bearer_token="good-token",
            cache_ttl=60)
        carol = UserInfo(name="carol", groups=("qa",))
        named = Attributes(user=carol, verb="GET", resource="secrets",
                           namespace="x", name="p1")
        listing = Attributes(user=carol, verb="GET", resource="secrets",
                             namespace="x")
        assert wz.authorize(named) is True
        # the cached named-get verdict must NOT leak onto the list
        assert wz.authorize(listing) is False
