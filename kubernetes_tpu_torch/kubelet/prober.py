"""Liveness/readiness probing (pkg/kubelet/prober).

One worker per (pod, container, probe kind) — prober/worker.go: wait out
initialDelaySeconds, probe every periodSeconds, and flip state only after
failureThreshold consecutive failures / successThreshold consecutive
successes (worker.go doProbe). Results feed two places:

  * readiness: the kubelet's generated ContainerStatus.ready AND the pod
    Ready condition consult the manager (status_manager +
    results_manager) — an unready container keeps phase Running but drops
    the pod from service endpoints;
  * liveness: a failure kills the container (worker.go -> syncPod kill);
    the pod worker's next sync restarts it under restartPolicy Always /
    OnFailure, bumping restartCount.

Probing itself goes through an injected ProbeRunner — the reference execs
into the container via the runtime; hollow nodes inject results the same
way FakeRuntime injects container exits.

Copy of kubernetes_tpu/kubelet/prober.py: only the import package differs.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

from kubernetes_tpu_torch.api import types as t

# ProbeRunner(pod, container_name, probe) -> bool success
ProbeRunner = Callable[[t.Pod, str, t.Probe], bool]


def always_succeed(pod: t.Pod, container: str, probe: t.Probe) -> bool:
    return True


class FakeProber:
    """Injectable probe results keyed (pod_name, container, kind);
    unkeyed probes succeed. The hollow-node seam."""

    def __init__(self):
        self._lock = threading.Lock()
        self._results: Dict[Tuple[str, str, str], bool] = {}
        self.calls = 0

    def set_result(self, pod_name: str, container: str, kind: str,
                   ok: bool) -> None:
        with self._lock:
            self._results[(pod_name, container, kind)] = ok

    def __call__(self, pod: t.Pod, container: str, probe: t.Probe,
                 kind: str = "") -> bool:
        with self._lock:
            self.calls += 1
            return self._results.get(
                (pod.metadata.name, container, kind), True
            )


class RuntimeProber:
    """Probe against a live runtime: exec probes run their command in
    the container and the exit code is the verdict (prober.go runProbe
    -> ExecInContainer). Probes without a concrete action succeed, the
    reference's missing-handler behavior."""

    def __init__(self, runtime):
        self.runtime = runtime

    def __call__(self, pod: t.Pod, container: str, probe: t.Probe,
                 kind: str = "") -> bool:
        cmd = getattr(probe, "exec_command", None)
        if probe.handler == "exec" and cmd:
            return self.runtime.exec_probe(
                pod.metadata.uid, container, cmd
            )
        return True


class _Worker:
    """prober/worker.go: the per-(container, kind) probe loop."""

    def __init__(self, manager: "ProbeManager", pod: t.Pod, container: str,
                 probe: t.Probe, kind: str):
        self.manager = manager
        self.pod = pod
        self.container = container
        self.probe = probe
        self.kind = kind  # "liveness" | "readiness"
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop,
            name=f"prober-{kind}-{pod.metadata.name}-{container}",
            daemon=True,
        )

    def run(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        # the initial result registers BEFORE the initial-delay wait:
        # a probed container must not report Ready during
        # initialDelaySeconds just because no result exists yet
        # (worker.go:88,170 sets readiness to Failure immediately)
        healthy = self.kind == "liveness"
        self.manager._set_result(self.pod, self.container, self.kind, healthy)
        if self.probe.initial_delay_seconds:
            if self._stop.wait(self.probe.initial_delay_seconds):
                return
        failures = successes = 0
        period = max(self.probe.period_seconds, self.manager.min_period)
        while not self._stop.wait(period):
            try:
                if self.manager._runner_takes_kind:
                    ok = self.manager.runner(
                        self.pod, self.container, self.probe, kind=self.kind
                    )
                else:
                    ok = self.manager.runner(
                        self.pod, self.container, self.probe
                    )
            except Exception:
                ok = False
            if ok:
                successes += 1
                failures = 0
                if not healthy and successes >= self.probe.success_threshold:
                    healthy = True
                    self.manager._set_result(
                        self.pod, self.container, self.kind, True
                    )
            else:
                failures += 1
                successes = 0
                if healthy and failures >= self.probe.failure_threshold:
                    healthy = False
                    self.manager._set_result(
                        self.pod, self.container, self.kind, False
                    )
                    if self.kind == "liveness":
                        self.manager._liveness_failed(self.pod, self.container)
                        # the restarted container starts a fresh probe
                        # history (worker.go resets on container restart)
                        healthy = True
                        failures = 0


class ProbeManager:
    """prober/prober_manager.go AddPod/RemovePod + results lookup."""

    def __init__(self, runner: Optional[ProbeRunner] = None,
                 on_liveness_failure=None, on_result_change=None,
                 min_period: float = 0.05):
        import inspect

        self.runner = runner or always_succeed
        # detect once whether the runner takes the kind= kwarg — probing
        # a TypeError at call time would swallow runner-internal bugs
        try:
            params = inspect.signature(self.runner).parameters
            self._runner_takes_kind = "kind" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values()
            )
        except (TypeError, ValueError):
            self._runner_takes_kind = False
        self.on_liveness_failure = on_liveness_failure
        # results_manager -> status_manager push (prober_manager.go
        # updateReadiness): a flip must re-generate the pod status
        self.on_result_change = on_result_change
        self.min_period = min_period
        self._lock = threading.Lock()
        self._workers: Dict[Tuple[str, str, str], _Worker] = {}
        self._results: Dict[Tuple[str, str, str], bool] = {}

    def add_pod(self, pod: t.Pod) -> None:
        uid = pod.metadata.uid
        with self._lock:
            for c in pod.spec.containers:
                for kind, probe in (("liveness", c.liveness_probe),
                                    ("readiness", c.readiness_probe)):
                    key = (uid, c.name, kind)
                    if probe is None or key in self._workers:
                        continue
                    w = _Worker(self, pod, c.name, probe, kind)
                    self._workers[key] = w
                    w.run()

    def remove_pod(self, pod_uid: str) -> None:
        with self._lock:
            for key in [k for k in self._workers if k[0] == pod_uid]:
                self._workers.pop(key).stop()
            for key in [k for k in self._results if k[0] == pod_uid]:
                del self._results[key]

    def stop(self) -> None:
        with self._lock:
            for w in self._workers.values():
                w.stop()
            self._workers.clear()

    # -- results -------------------------------------------------------------

    def _set_result(self, pod: t.Pod, container: str, kind: str,
                    ok: bool) -> None:
        with self._lock:
            key = (pod.metadata.uid, container, kind)
            changed = self._results.get(key) is not ok
            self._results[key] = ok
        if changed and self.on_result_change is not None:
            self.on_result_change(pod)

    def _liveness_failed(self, pod: t.Pod, container: str) -> None:
        if self.on_liveness_failure is not None:
            self.on_liveness_failure(pod, container)

    def is_ready(self, pod_uid: str, container: str) -> bool:
        """Container readiness gate: no readiness probe (or no result
        yet on a probe-less container) means ready."""
        with self._lock:
            return self._results.get((pod_uid, container, "readiness"), True)
