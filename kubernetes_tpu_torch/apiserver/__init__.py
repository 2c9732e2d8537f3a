"""API surface layer (pkg/apiserver + pkg/registry + pkg/master).

APIServer is the hub of the hub-and-spoke design: the only writer to
the store, serving REST verbs + resumable watches for every registered
resource. It is transport-agnostic — `handle()` takes (method, path,
query, body) and returns a status + JSON payload or a WatchResponse —
with two frontends:

- serve_http(): a real HTTP server (the production shape), and
- the client layer's LocalTransport, which calls handle() in-process
  (the httptest in-process master idiom, master_utils.go:320).

Copy of kubernetes_tpu/apiserver/__init__.py: only the import package differs.
"""

# Lazy re-exports (PEP 562): the storage cacher imports
# apiserver.fields (a leaf module) for server-side field-selector
# evaluation, and an eager `from .server import ...` here would close
# the cycle storage -> cacher -> apiserver -> server -> storage.
__all__ = ["APIServer", "APIError", "WatchResponse"]


def __getattr__(name):
    if name in __all__:
        from kubernetes_tpu_torch.apiserver import server as _server

        return getattr(_server, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
