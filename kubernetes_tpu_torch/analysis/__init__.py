"""The port's analysis package: the runtime sanitizers its host copies
call.

Counterpart of kubernetes_tpu/analysis/__init__.py. The port carries the
lock-order sanitizer (locks.py) and the data-race detector (races.py),
verbatim copies, because the scheduler cache (scheduler/cache.py) and
the work queues (utils/workqueue.py) register their shared state with
the race tracker. Finding and render_report are verbatim copies of the
JAX package's, the rows and report both sanitizers emit.

Left out: run_static_passes, the CLI body that lints the tree, audits
the device programs and model-checks the consensus store. It reaches
modules the port does not have (lint, jaxpr_audit, sim); the audit of
the port's own programs is ROADMAP.md queue 1 item 6.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass
class Finding:
    """One violation (or suppressed would-be violation) from any pass."""

    pass_name: str  # "jaxpr" | "lint" | "locks" | "races"
    rule: str  # stable rule id, the token a suppression names
    where: str  # "module.py:123" or a program name
    message: str
    suppressed: bool = False


def render_report(findings: List[Finding], title: str = "") -> str:
    """Human-readable findings report (the CLI output, also embedded in
    assertion messages by the tests)."""
    lines: List[str] = []
    if title:
        lines.append(title)
    active = [f for f in findings if not f.suppressed]
    muted = [f for f in findings if f.suppressed]
    for f in active:
        lines.append(f"  [{f.pass_name}/{f.rule}] {f.where}: {f.message}")
    for f in muted:
        # suppressed rows stay listed (marked) so allowance drift is
        # auditable from the report, not just countable
        lines.append(
            f"  [suppressed {f.pass_name}/{f.rule}] {f.where}: "
            f"{f.message}"
        )
    lines.append(
        f"{len(active)} finding(s), {len(muted)} suppressed"
    )
    return "\n".join(lines)


__all__ = ["Finding", "render_report"]
