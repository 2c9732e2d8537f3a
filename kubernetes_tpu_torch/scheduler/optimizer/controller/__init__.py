"""Controllers of the optimizing profile (defragmentation).

Copy of kubernetes_tpu/scheduler/optimizer/controller/__init__.py: only the import package differs."""
