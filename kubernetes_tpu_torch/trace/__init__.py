"""End-to-end scheduling trace & device-phase profiling.

The reference ships scheduler latency histograms plus /metrics and
/healthz on every daemon (plugin/pkg/scheduler/metrics/metrics.go,
server.go:92-108). This package grows that into per-phase attribution
for the TPU wire path:

  * spans.py   — lightweight span API: ``span(name, **attrs)`` context
    manager, thread-safe in-memory ring buffer, JSON-lines export,
    parent/child propagation via a context var, and a trace-id pod
    annotation that rides the TLV wire, so one pod's journey
    apiserver -> scheduler -> bind is a single trace across processes.
  * profile.py — per-phase histograms (encode / probe / score / replay
    / transfer / wire / bind) and XLA compile-vs-execute attribution
    via jax.monitoring (scheduler_xla_compile_seconds).
  * httpd.py   — the component observability mux (/healthz, /metrics,
    /configz, /debug/traces) the scheduler daemon serves, the
    reference's own-:10251-mux idiom.
  * slo.py     — a watchdog sampling e2e scheduling latency against a
    configurable objective, emitting API Events on breach.

Everything span-shaped is gated on one process-global switch
(KUBERNETES_TPU_TRACE, default on; ``span.set_enabled`` flips it at
runtime): disabled, every hook is a no-op costing one attribute read.

Copy of kubernetes_tpu/trace/__init__.py: only the import package differs.
"""

from kubernetes_tpu_torch.trace.spans import (
    BUFFER,
    TRACE_ID_ANNOTATION,
    TraceBuffer,
    current_trace_id,
    enabled,
    event_span,
    extract,
    inject,
    new_trace_id,
    record_span,
    set_enabled,
    span,
    trace_context,
)

__all__ = [
    "BUFFER",
    "TRACE_ID_ANNOTATION",
    "TraceBuffer",
    "current_trace_id",
    "enabled",
    "event_span",
    "extract",
    "inject",
    "new_trace_id",
    "record_span",
    "set_enabled",
    "span",
    "trace_context",
]
