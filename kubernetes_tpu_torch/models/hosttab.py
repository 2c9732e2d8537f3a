"""Host reconstruction of the probe's resource j-axis.

The grouped multi-run probe (models/probe._group_probe_fn) ships only
the HEADER rows per run — no [J, N] j-table — because the j-axis is a
pure function of per-node resource usage, and the host knows the usage
exactly: the probe ships the carry's resource block once per group, and
every subsequent commit inside the group is a host-visible
(commit-vector x counts) outer product.  Rebuilding the j-axis here is
what lets ONE device dispatch serve K distinct templates: run k's table
is evaluated against usage that already includes runs 1..k-1's commits,
so the tables stay exact without a per-run re-probe.

Every function is an operation-for-operation numpy mirror of the device
kernel it replaces (ops/predicates.pod_fits_resources,
ops/priorities.least_requested / balanced_resource_allocation) — the
same discipline models/replay.py uses for the normalizers: int64
truncating division and float64 IEEE arithmetic agree bit-for-bit
between numpy and XLA, and tests/test_wave.py's differential fuzz is
the enforcement.

Copy of kubernetes_tpu/models/hosttab.py: only the import package differs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from kubernetes_tpu_torch.models.batch import (
    BALANCED_ALLOCATION,
    LEAST_REQUESTED,
    SchedulerConfig,
    wants_ports,
    wants_resources,
)

#: row order of the carry's resource block (BatchScheduler.initial_carry)
RES_ROWS = ("req_mcpu", "req_mem", "req_gpu", "nz_mcpu", "nz_mem",
            "pod_count")


def commit_vector(pod: dict) -> np.ndarray:
    """The per-commit delta of the resource block — the host mirror of
    the `commit` stack in wave._apply_fn."""
    return np.array(
        [int(pod["commit_mcpu"]), int(pod["commit_mem"]),
         int(pod["commit_gpu"]), int(pod["nz_mcpu"]), int(pod["nz_mem"]),
         1],
        np.int64,
    )


def _calculate_score(requested: np.ndarray, capacity: np.ndarray):
    """ops/priorities._calculate_score (priorities.go:33), numpy."""
    safe_cap = np.where(capacity == 0, 1, capacity)
    score = ((capacity - requested) * 10) // safe_cap
    return np.where((capacity == 0) | (requested > capacity), 0, score)


def least_requested(pod_nz_mcpu, pod_nz_mem, nz_mcpu, nz_mem,
                    alloc_mcpu, alloc_mem):
    """ops/priorities.least_requested (priorities.go:81), numpy."""
    cpu_score = _calculate_score(nz_mcpu + pod_nz_mcpu, alloc_mcpu)
    mem_score = _calculate_score(nz_mem + pod_nz_mem, alloc_mem)
    return (cpu_score + mem_score) // 2


def balanced_resource_allocation(pod_nz_mcpu, pod_nz_mem, nz_mcpu, nz_mem,
                                 alloc_mcpu, alloc_mem):
    """ops/priorities.balanced_resource_allocation (priorities.go:215),
    numpy: the same float64 expression shapes, truncated to int64."""
    total_cpu = (nz_mcpu + pod_nz_mcpu).astype(np.float64)
    total_mem = (nz_mem + pod_nz_mem).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        cpu_frac = np.where(
            alloc_mcpu == 0, 1.0,
            total_cpu / alloc_mcpu.astype(np.float64)
        )
        mem_frac = np.where(
            alloc_mem == 0, 1.0,
            total_mem / alloc_mem.astype(np.float64)
        )
        diff = np.abs(cpu_frac - mem_frac)
        score = (10.0 - diff * 10.0).astype(np.int64)
    return np.where((cpu_frac >= 1.0) | (mem_frac >= 1.0), 0, score)


def pod_fits_resources(pod, alloc: dict, usage: np.ndarray,
                       j: np.ndarray) -> np.ndarray:
    """ops/predicates.pod_fits_resources over the j-axis, numpy.
    usage is the live resource block i64[6, N]; j is i64[rows, 1]."""
    req_mcpu = usage[0][None, :] + j * int(pod["commit_mcpu"])
    req_mem = usage[1][None, :] + j * int(pod["commit_mem"])
    req_gpu = usage[2][None, :] + j * int(pod["commit_gpu"])
    pod_count = usage[5][None, :] + j
    count_ok = pod_count + 1 <= alloc["alloc_pods"]
    cpu_ok = alloc["alloc_mcpu"] >= int(pod["req_mcpu"]) + req_mcpu
    mem_ok = alloc["alloc_mem"] >= int(pod["req_mem"]) + req_mem
    gpu_ok = alloc["alloc_gpu"] >= int(pod["req_gpu"]) + req_gpu
    resources_ok = np.where(
        bool(pod["zero_req"]), True, cpu_ok & mem_ok & gpu_ok
    )
    return count_ok & resources_ok


def resource_tables(config: SchedulerConfig, pod: dict, alloc: dict,
                    usage: np.ndarray, rows: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (res_fit bool[rows, N], tab i64[rows, N]): the j-axis of
    models/probe._probe_rows evaluated at the CURRENT usage — commits
    of earlier runs in the group are already folded into `usage`, which
    is exactly what a fresh per-run probe would have seen.

    pod: the run representative's host batch row (scalars + arrays);
    alloc: {"alloc_mcpu","alloc_mem","alloc_gpu","alloc_pods"} i64[N]."""
    N = usage.shape[1]
    j = np.arange(rows, dtype=np.int64)[:, None]
    if wants_resources(config):
        res_fit = pod_fits_resources(pod, alloc, usage, j)
    else:
        res_fit = np.ones((rows, N), bool)
    if wants_ports(config) and bool(np.any(np.asarray(pod["port_mask"]))):
        # host-port self-conflict (predicates.go:574): one copy holds
        # the ports, every further copy fails — j > 0 rows die
        res_fit[1:] = False
    tab = np.zeros((rows, N), np.int64)
    nzj_cpu = usage[3][None, :] + j * int(pod["nz_mcpu"])
    nzj_mem = usage[4][None, :] + j * int(pod["nz_mem"])
    for name, weight in config.priorities:
        if name == LEAST_REQUESTED:
            tab = tab + np.int64(weight) * least_requested(
                int(pod["nz_mcpu"]), int(pod["nz_mem"]), nzj_cpu, nzj_mem,
                alloc["alloc_mcpu"], alloc["alloc_mem"],
            )
        elif name == BALANCED_ALLOCATION:
            tab = tab + np.int64(weight) * balanced_resource_allocation(
                int(pod["nz_mcpu"]), int(pod["nz_mem"]), nzj_cpu, nzj_mem,
                alloc["alloc_mcpu"], alloc["alloc_mem"],
            )
    return res_fit, tab
