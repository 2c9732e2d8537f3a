"""Serialization / schema layer (pkg/runtime analogue).

One Scheme maps kind names <-> dataclasses and round-trips every API
object through camelCase JSON — the equivalent of the reference's
Scheme + codec factory (pkg/runtime/scheme.go, serializer/json). The
wire format is JSON only; the columnar device encodings live in
kubernetes_tpu_torch.snapshot and never pass through here.

Copy of kubernetes_tpu/runtime/__init__.py: only the import package differs.
"""

from kubernetes_tpu_torch.runtime.scheme import Scheme, scheme

__all__ = ["Scheme", "scheme"]
