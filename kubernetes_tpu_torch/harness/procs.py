"""Multi-process control-plane supervision (the hub-and-spoke shape).

The wire path was capped by ONE apiserver process's GIL; this module
runs the production topology instead: N apiserver replicas as separate
OS processes, each embedding one quorum-store member (its own watch
cache, APF instance, and HTTP frontend), plus optional scheduler HA —
two scheduler processes sharing a leader-election lease. The driver
process (bench / tests) talks to the replica set through the
multi-endpoint ``HTTPTransport`` (spread + 503 failover).

Supervision is crash-safe by construction: every spawned process is
registered in a module-global table swept by an ``atexit`` hook AND by
explicit ``stop()`` — the sweep SIGKILLs stragglers so no orphaned
listener survives between tests, even when the driver dies mid-soak
(the reason `bench.py --wire-soak-procs` can be ctrl-C'd freely).

Accounting: replicas expose ``/metrics`` (scraped counters per
process) and ``/healthz`` (quorum member identity); the supervisor
reads ``/proc/<pid>/{status,stat}`` for per-process RSS and CPU — the
per-process request/CPU rows in the BENCH record.

Copy of kubernetes_tpu/harness/procs.py: only the import package differs.
"""

from __future__ import annotations

import atexit
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

#: every Popen this module ever spawned; the atexit sweep SIGKILLs
#: whatever is still alive (idempotent — kill of a reaped pid no-ops)
_SUPERVISED: List[subprocess.Popen] = []
_reg_mu = threading.Lock()
_sweep_armed = False


def _sigkill_sweep() -> None:
    for p in list(_SUPERVISED):
        if p.poll() is None:
            try:
                p.kill()
            except OSError:
                pass
    for p in list(_SUPERVISED):
        try:
            p.wait(timeout=5)
        except Exception:
            pass


def supervise(proc: subprocess.Popen) -> subprocess.Popen:
    """Register `proc` for the crash-safe teardown sweep."""
    global _sweep_armed
    with _reg_mu:
        if not _sweep_armed:
            atexit.register(_sigkill_sweep)
            _sweep_armed = True
        _SUPERVISED.append(proc)
    return proc


def free_ports(n: int) -> List[int]:
    """Reserve n distinct ephemeral ports (bind-then-close; the usual
    benign race — the spawned servers bind them back immediately)."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def proc_rss_mb(pid: int) -> float:
    """Resident set of `pid` in MB (0.0 once it is gone)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def proc_cpu_seconds(pid: int) -> float:
    """User+system CPU seconds `pid` has burned (0.0 once gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[-1].split()
        # fields after the comm: utime is index 11, stime 12 (stat(5)
        # fields 14/15, minus pid+comm+state)
        ticks = int(fields[11]) + int(fields[12])
        return ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


# The label-aware exposition parser (and its sum/scrape helpers) used
# to live here, private to the multi-process harness. The telemetry
# collector (telemetry/scrape.py) scrapes the same fleet through the
# same lines, so the shared implementation moved to telemetry/expo.py;
# these re-exports keep every historical harness import path working.
from kubernetes_tpu_torch.telemetry.expo import (  # noqa: E402,F401
    healthz,
    parse_series as _parse_series,
    scrape_metrics,
    scrape_raw,
    series_sum,
)


class ApiserverReplica:
    """One apiserver OS process embedding one quorum member."""

    def __init__(self, node_id: str, url: str, http_port: int,
                 peer_port: int, data_dir: str,
                 proc: subprocess.Popen, log_path: str):
        self.node_id = node_id
        self.url = url
        self.http_port = http_port
        self.peer_port = peer_port
        self.data_dir = data_dir
        self.proc = proc
        self.log_path = log_path

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        """kill -9: the chaos verb (no flush, no goodbye)."""
        if self.alive():
            try:
                self.proc.send_signal(signal.SIGKILL)
            except OSError:
                pass
        try:
            self.proc.wait(timeout=10)
        except Exception:
            pass

    def quorum_status(self) -> Optional[dict]:
        h = healthz(self.url)
        if h is None:
            return None
        return h.get("quorum")

    def accounting(self) -> Dict[str, float]:
        """Per-process resource row for the BENCH record."""
        return {
            "pid": float(self.pid),
            "rss_mb": round(proc_rss_mb(self.pid), 1),
            "cpu_seconds": round(proc_cpu_seconds(self.pid), 2),
        }


class ApiserverFleet:
    """N apiserver replicas, one quorum, spawned and supervised.

    Each replica is ``python -m kubernetes_tpu_torch.hyperkube apiserver
    --store=quorum`` on its own pre-reserved HTTP + peer-RPC ports,
    with a symmetric ``--quorum-peers`` list (each member filters
    itself out). ``urls()`` is the comma-separated endpoint list the
    multi-endpoint HTTPTransport takes."""

    def __init__(self, n: int, base_dir: str,
                 election_timeout: float = 0.5,
                 env_extra: Optional[Dict[str, str]] = None):
        self.n = n
        self.base_dir = base_dir
        self.election_timeout = election_timeout
        self.env_extra = dict(env_extra or {})
        self.replicas: List[ApiserverReplica] = []
        self._log_files: List = []

    def start(self, ready_timeout: float = 60.0) -> "ApiserverFleet":
        os.makedirs(self.base_dir, exist_ok=True)
        ports = free_ports(2 * self.n)
        self._http_ports = ports[: self.n]
        self._peer_ports = ports[self.n:]
        self._peers_spec = ",".join(
            f"q{i}=127.0.0.1:{self._peer_ports[i]}"
            for i in range(self.n)
        )
        for i in range(self.n):
            self.replicas.append(self._spawn(i))
        self.wait_ready(ready_timeout)
        return self

    def _spawn(self, i: int) -> ApiserverReplica:
        env = dict(os.environ)
        # the apiserver process never imports jax (PR 8 moved jax
        # config to env), but pin the platform anyway so an accidental
        # import in a future change cannot grab an accelerator
        env.setdefault("JAX_PLATFORMS", "cpu")
        env.update(self.env_extra)
        data_dir = os.path.join(self.base_dir, f"q{i}")
        log_path = os.path.join(self.base_dir, f"replica-{i}.log")
        logf = open(log_path, "ab")
        self._log_files.append(logf)
        proc = supervise(subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.hyperkube",
             "apiserver",
             "--port", str(self._http_ports[i]),
             "--enable-binary-wire",
             "--store", "quorum",
             "--quorum-id", f"q{i}",
             "--quorum-listen", str(self._peer_ports[i]),
             "--quorum-peers", self._peers_spec,
             "--quorum-election-timeout",
             str(self.election_timeout),
             "--data-dir", data_dir],
            stdout=logf, stderr=subprocess.STDOUT, env=env,
        ))
        return ApiserverReplica(
            f"q{i}", f"http://127.0.0.1:{self._http_ports[i]}",
            self._http_ports[i], self._peer_ports[i], data_dir, proc,
            log_path,
        )

    def restart(self, replica: ApiserverReplica,
                ready_timeout: float = 60.0) -> ApiserverReplica:
        """Bring a killed replica back on the SAME data_dir and ports:
        the raft log replays, the member re-joins, and pre-vote keeps
        its rejoin from bumping anyone's term."""
        i = self.replicas.index(replica)
        replica.kill()  # idempotent; also reaps
        fresh = self._spawn(i)
        self.replicas[i] = fresh
        deadline = time.monotonic() + ready_timeout
        while time.monotonic() < deadline:
            if healthz(fresh.url) is not None:
                return fresh
            if not fresh.alive():
                raise RuntimeError(
                    f"restarted replica {fresh.node_id} died "
                    f"(see {fresh.log_path})")
            time.sleep(0.1)
        raise RuntimeError(
            f"restarted replica {fresh.node_id} never became healthy")

    def wait_ready(self, timeout: float) -> None:
        """Every replica answers /healthz AND some member leads."""
        deadline = time.monotonic() + timeout
        pending = list(self.replicas)
        while pending and time.monotonic() < deadline:
            pending = [r for r in pending if healthz(r.url) is None]
            if pending:
                dead = [r for r in pending if not r.alive()]
                if dead:
                    raise RuntimeError(
                        f"apiserver replica {dead[0].node_id} died at "
                        f"startup (see {dead[0].log_path})")
                time.sleep(0.1)
        if pending:
            raise RuntimeError(
                "apiserver replicas never became healthy: "
                + ", ".join(r.node_id for r in pending))
        while time.monotonic() < deadline:
            if self.leader() is not None:
                return
            time.sleep(0.1)
        raise RuntimeError("quorum never elected a leader across the "
                           "apiserver replica processes")

    def urls(self, lead_first: bool = False) -> str:
        """The comma-separated endpoint list. lead_first puts the
        current leader's replica first (the sticky transports then pin
        the cheapest member; spread transports ignore order)."""
        reps = [r for r in self.replicas if r.alive()]
        if lead_first:
            lead = self.leader()
            if lead is not None:
                reps = [lead] + [r for r in reps if r is not lead]
        return ",".join(r.url for r in reps)

    def leader(self) -> Optional[ApiserverReplica]:
        """The replica whose embedded member currently leads (None
        during elections)."""
        for r in self.replicas:
            if not r.alive():
                continue
            q = r.quorum_status()
            if q and q.get("role") == "leader":
                return r
        return None

    def followers(self) -> List[ApiserverReplica]:
        lead = self.leader()
        return [r for r in self.replicas
                if r.alive() and r is not lead]

    def scrape(self) -> Dict[str, float]:
        """Summed metric counters across every live replica."""
        total: Dict[str, float] = {}
        for r in self.replicas:
            if not r.alive():
                continue
            try:
                for k, v in scrape_metrics(r.url).items():
                    total[k] = total.get(k, 0.0) + v
            except OSError:
                continue
        return total

    def scrape_raw(self):
        """Concatenated (name, labels, value) rows across every live
        replica (feed to series_sum for label-filtered folds)."""
        rows = []
        for r in self.replicas:
            if not r.alive():
                continue
            try:
                rows.extend(scrape_raw(r.url))
            except OSError:
                continue
        return rows

    def leader_terms(self) -> Dict[int, List[str]]:
        """term -> [node ids claiming to lead it] observed RIGHT NOW
        across live replicas (poll repeatedly and merge to gate the
        at-most-one-leader-per-term invariant from outside)."""
        claims: Dict[int, List[str]] = {}
        for r in self.replicas:
            if not r.alive():
                continue
            q = r.quorum_status()
            if q and q.get("role") == "leader":
                claims.setdefault(int(q.get("term", -1)), []).append(
                    q.get("node", r.node_id))
        return claims

    def accounting(self) -> List[Dict[str, float]]:
        return [dict(r.accounting(), node=r.node_id)
                for r in self.replicas if r.alive()]

    def stop(self) -> None:
        for r in self.replicas:
            r.kill()
        for f in self._log_files:
            try:
                f.close()
            except OSError:
                pass


class SchedulerProc:
    """One kube-scheduler OS process (leader-elect HA member).

    Deviation from kubernetes_tpu/harness/procs.py SchedulerProc: it
    takes `device` ("cuda" unless the caller asks for "cpu", the port's
    rule) and passes it as the scheduler's --device; it sets no
    JAX_PLATFORMS or JAX_ENABLE_X64, which mean nothing to the port's
    hyperkube scheduler.
    """

    def __init__(self, server_urls: str, identity: str, base_dir: str,
                 lease_duration: float = 4.0,
                 renew_deadline: float = 2.5,
                 retry_period: float = 0.5,
                 env_extra: Optional[Dict[str, str]] = None,
                 device: str = "cuda"):
        os.makedirs(base_dir, exist_ok=True)
        self.identity = identity
        self.log_path = os.path.join(base_dir,
                                     f"scheduler-{identity}.log")
        env = dict(os.environ)
        env.update(env_extra or {})
        self._logf = open(self.log_path, "wb")
        self.proc = supervise(subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.hyperkube",
             "scheduler",
             "--server", server_urls,
             "--leader-elect",
             "--leader-elect-identity", identity,
             "--lease-duration", str(lease_duration),
             "--renew-deadline", str(renew_deadline),
             "--retry-period", str(retry_period),
             "--device", device],
            stdout=self._logf, stderr=subprocess.STDOUT, env=env,
        ))

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        if self.alive():
            try:
                self.proc.send_signal(signal.SIGKILL)
            except OSError:
                pass
        try:
            self.proc.wait(timeout=10)
        except Exception:
            pass
        try:
            self._logf.close()
        except OSError:
            pass


def scheduler_lease_holder(client) -> str:
    """Who holds the kube-scheduler lease right now ('' when nobody):
    reads the leader-election annotation the electors CAS over."""
    from kubernetes_tpu_torch.client.leaderelection import (
        LEADER_ANNOTATION,
        _decode,
    )

    try:
        ep = client.resource("endpoints", "kube-system").get(
            "kube-scheduler")
    except Exception:
        return ""
    rec = _decode(ep.metadata.annotations.get(LEADER_ANNOTATION, ""))
    return rec.holder_identity if rec is not None else ""
