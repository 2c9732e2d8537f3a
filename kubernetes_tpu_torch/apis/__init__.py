"""Non-core API groups whose types live outside api/types.py
(pkg/apis/* in the reference).

Copy of kubernetes_tpu/apis/__init__.py: only the import package differs."""
