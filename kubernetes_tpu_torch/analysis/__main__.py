"""CLI entry: ``python -m kubernetes_tpu_torch.analysis``.

Runs the static passes (AST lint + program audit + the quick-budget
model check of storage/quorum) over the installed tree and exits
non-zero when any unsuppressed finding survives — the CI gate. It runs
on the CPU: the program audit traces on fake CUDA tensors and needs no
card. The runtime sanitizers (lock-order graph, rebuild sentinel, data
races) arm under the test suites instead; an armed run's race findings
land in a JSONL artifact (``races.dump_jsonl`` /
``KUBERNETES_TPU_RACE_REPORT``) that ``--race-report`` merges back into
this gate so one invocation carries the whole verdict.

Flags:
    --lint-only     skip the program audit (no program tracing)
    --programs-only skip the AST lint
    --no-mesh       audit single-device programs only (without it, an
                    unbuilt mesh is a `mesh-unavailable` finding,
                    never a silent coverage shrink)
    --no-sim        skip the quick-budget deterministic simulation of
                    storage/quorum (model check of the clean tree +
                    the seeded-bug corpus gate); --lint-only and
                    --programs-only also skip it
    --json          machine-readable report: one JSON object per
                    finding on stdout (fields: pass, rule, where,
                    message, suppressed) — lint, program audit, and
                    merged race-witness rows uniformly; the CI
                    artifact-upload format
    --race-report PATH
                    merge a race-witness JSONL artifact (written by an
                    armed suite run) into the report; its unsuppressed
                    rows fail the gate like any other finding.
                    Repeatable.

Deviation from kubernetes_tpu/analysis/__main__.py <module>: --jaxpr-only
becomes --programs-only (there is no jaxpr; the pass is the program
audit), and the report's title names this package.
"""

from __future__ import annotations

import json
import sys

from kubernetes_tpu_torch.analysis import Finding


def _load_race_report(path: str):
    """JSONL rows (races.dump_jsonl format) -> Findings. A row that
    does not parse is itself a finding: a corrupt artifact must never
    silently pass the gate."""
    findings = []
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
                findings.append(Finding(
                    row["pass"], row["rule"], row["where"],
                    row["message"], suppressed=bool(row["suppressed"]),
                ))
            except (ValueError, KeyError, TypeError) as e:
                findings.append(Finding(
                    "races", "malformed-report", f"{path}:{lineno}",
                    f"unparseable race-report row: {e!r}",
                ))
    return findings


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from kubernetes_tpu_torch.analysis import render_report, run_static_passes

    race_reports = []
    while "--race-report" in argv:
        i = argv.index("--race-report")
        if i + 1 >= len(argv):
            print("--race-report needs a PATH", file=sys.stderr)
            return 2
        race_reports.append(argv[i + 1])
        del argv[i:i + 2]

    findings = run_static_passes(
        include_programs="--lint-only" not in argv,
        include_lint="--programs-only" not in argv,
        include_mesh="--no-mesh" not in argv,
        include_sim=not ({"--no-sim", "--lint-only", "--programs-only"}
                         & set(argv)),
    )
    for path in race_reports:
        try:
            findings.extend(_load_race_report(path))
        except OSError as e:
            findings.append(Finding(
                "races", "malformed-report", path,
                f"race report unreadable: {e!r}",
            ))

    if "--json" in argv:
        for f in findings:
            print(json.dumps({
                "pass": f.pass_name, "rule": f.rule, "where": f.where,
                "message": f.message, "suppressed": f.suppressed,
            }))
    else:
        print(render_report(findings,
                            "kubernetes_tpu_torch static analysis:"))
    return 1 if any(not f.suppressed for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
