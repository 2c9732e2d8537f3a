"""The port's static analysis and sanitizer suite: machine-checked
contracts for the tensor-program scheduler.

Counterpart of kubernetes_tpu/analysis/__init__.py. Five pass families,
runnable standalone (``python -m kubernetes_tpu_torch.analysis``,
``--json`` for the machine-readable CI artifact) and as tier-1 tests
(tests/test_torch_analysis.py, tests/test_torch_sim.py):

  1. **Program auditor** (program_audit / programs): traces every
     registered device program (scan, probe, group probe, apply / group
     apply, zreplay dispatch / dispatch_group, the victim scorer, the
     assignment solvers, the mesh programs, the resident row scatter) on
     fake CUDA tensors, counting device-to-host copies per dispatch and
     holding each program to its host-sync, dynamic-shape, f64, integer
     matmul, donation, placement, scatter and dtype contracts.

  2. **AST lint** (lint): the package-wide, scoped and concurrency rules
     of the JAX lint, and its traced-scope rules as program-scope rules
     over the registered programs' device functions. Suppression:
     ``# lint: allow[rule]``.

  3. **Runtime sanitizers** (locks / compile_guard): the lock-order
     graph, and a sentinel that fails when a steady-state wave builds or
     loads a kernel library (native/build.py's listener seam).

  4. **Data-race detector** (races), as in the JAX package.

  5. **Deterministic simulation** (sim/): the model checker of
     ``storage/quorum``, verbatim copies; the clean tree must check
     quiet AND the seeded historical-bug corpus must be re-found.

Each pass emits ``Finding`` rows; the CLI exits non-zero when any
unsuppressed finding survives, which is the CI gate. Finding and
render_report are verbatim copies of the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


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


def run_static_passes(root: Optional[str] = None,
                      include_programs: bool = True,
                      include_lint: bool = True,
                      include_mesh: bool = True,
                      include_sim: bool = True) -> List[Finding]:
    """The CLI/CI body: lint the tree, audit the device programs on fake
    CUDA tensors, and model-check the consensus layer at the quick
    budget. (The lock-order and rebuild sanitizers are runtime passes;
    they arm under the tests and chip_smoke.py instead.)

    Deviation from kubernetes_tpu/analysis/__init__.py run_static_passes:
    include_jaxpr becomes include_programs, and the audit needs no
    device setup: its fake tensors name CUDA devices cuda:0..cuda:3
    without a card, so the mesh programs always build."""
    findings: List[Finding] = []
    if include_lint:
        from kubernetes_tpu_torch.analysis import lint

        findings.extend(lint.lint_tree(root))
    if include_programs:
        from kubernetes_tpu_torch.analysis import program_audit

        try:
            findings.extend(
                program_audit.audit_all(include_mesh=include_mesh))
        except Exception as e:  # a program failing to TRACE is itself red
            findings.append(Finding(
                "programs", "trace-failure", "audit_all",
                f"registered program failed to trace: {e!r}",
            ))
    if include_sim:
        # quick-budget deterministic simulation of storage/quorum:
        # the clean tree must model-check quiet, AND the checker must
        # still find every seeded historical bug (a blind checker is
        # a gate failure, not a pass)
        from kubernetes_tpu_torch.analysis.sim import corpus

        for v in corpus.check_clean():
            findings.append(Finding(
                "sim", "invariant-violation", "model-check", v))
        for name, sched in sorted(corpus.find_seeded_bugs().items()):
            if sched is None:
                findings.append(Finding(
                    "sim", "corpus-blind", name,
                    "seeded historical bug not re-found within the "
                    "quick model-check budget",
                ))
    return findings


__all__ = ["Finding", "render_report", "run_static_passes"]
