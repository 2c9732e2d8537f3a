"""Device programs of the optimizing profile (joint assignment).

Copy of kubernetes_tpu/scheduler/optimizer/ops/__init__.py: only the import package differs."""
