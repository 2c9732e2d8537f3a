"""Apiserver audit subsystem (apiserver/pkg/audit analogue).

Structured who-did-what events per REST request, policy-leveled
(None/Metadata/Request), buffered in a bounded ring served at
/debug/audit and optionally appended as JSON lines to a file sink.

Copy of kubernetes_tpu/audit/__init__.py: only the import package differs.
"""

from kubernetes_tpu_torch.audit.audit import (
    LEVEL_METADATA,
    LEVEL_NONE,
    LEVEL_REQUEST,
    LOG,
    AuditLog,
    AuditPolicy,
    make_event,
    new_request_id,
    record,
    render_audit,
    summarize_object,
    verb_for,
)

__all__ = [
    "LEVEL_NONE",
    "LEVEL_METADATA",
    "LEVEL_REQUEST",
    "LOG",
    "AuditLog",
    "AuditPolicy",
    "make_event",
    "new_request_id",
    "record",
    "render_audit",
    "summarize_object",
    "verb_for",
]
