"""Leader election via annotation CAS on an Endpoints object.

Reference: pkg/client/leaderelection/leaderelection.go (:170 Run, :184
RunOrDie; acquire/renew loops :203+). The lease lives in the
`control-plane.alpha.kubernetes.io/leader` annotation as JSON; writes go
through resourceVersion CAS so two candidates cannot both win. Losing
the lease calls on_stopped_leading — callers are expected to exit
(crash-and-restart model, scheduler server.go:153-155).

Copy of kubernetes_tpu/client/leaderelection.py: only the import package differs.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Callable, Optional

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient
from kubernetes_tpu_torch.utils.clock import DEFAULT_CLOCK, Clock

LEADER_ANNOTATION = "control-plane.alpha.kubernetes.io/leader"


@dataclass
class LeaderElectionRecord:
    holder_identity: str
    lease_duration_seconds: float
    acquire_time: float
    renew_time: float


class LeaderElector:
    def __init__(
        self,
        client: RESTClient,
        namespace: str,
        name: str,
        identity: str,
        lease_duration: float = 15.0,
        renew_deadline: float = 10.0,
        retry_period: float = 2.0,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
        clock: Clock = DEFAULT_CLOCK,
    ):
        assert lease_duration > renew_deadline > retry_period
        self.client = client
        self.namespace = namespace
        self.name = name
        self.identity = identity
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.clock = clock
        self.observed_record: Optional[LeaderElectionRecord] = None
        self.observed_time: float = 0.0
        self._stop = threading.Event()
        # serializes lease writes vs. stop(): a renew in flight on the
        # elector thread must not overwrite the released record
        self._write_lock = threading.Lock()

    def is_leader(self) -> bool:
        return (
            self.observed_record is not None
            and self.observed_record.holder_identity == self.identity
        )

    def run(self) -> None:
        """Block: acquire, then renew until lost or stopped."""
        if not self._acquire():
            return
        if self.on_started_leading:
            threading.Thread(target=self.on_started_leading, daemon=True).start()
        self._renew_loop()
        if self.on_stopped_leading:
            self.on_stopped_leading()

    def stop(self, release: bool = True) -> None:
        """Stop participating; when currently leading and `release` is
        True, zero out the lease so a standby acquires immediately instead
        of waiting out lease_duration (the releasedLease pattern)."""
        was_leader = self.is_leader()
        self._stop.set()
        if release and was_leader:
            try:
                # the write lock orders this after any in-flight renew, and
                # the stop flag keeps later renews from resurrecting the
                # lease — standbys acquire immediately
                with self._write_lock:
                    self._release()
            except Exception:
                pass  # best effort; the lease will expire anyway

    def _release(self) -> None:
        endpoints = self.client.resource("endpoints", self.namespace)
        obj = endpoints.get(self.name)
        existing = _decode(obj.metadata.annotations.get(LEADER_ANNOTATION, ""))
        if existing is None or existing.holder_identity != self.identity:
            return
        released = LeaderElectionRecord(
            holder_identity=self.identity,
            lease_duration_seconds=0.0,  # freshness check fails instantly
            acquire_time=existing.acquire_time,
            renew_time=self.clock.now(),
        )
        obj.metadata.annotations[LEADER_ANNOTATION] = _encode(released)
        endpoints.update(obj)

    # -- internals -----------------------------------------------------------

    def _acquire(self) -> bool:
        while not self._stop.is_set():
            if self._try_acquire_or_renew():
                return True
            self._stop.wait(self.retry_period)
        return False

    def _renew_loop(self) -> None:
        while not self._stop.is_set():
            deadline = self.clock.now() + self.renew_deadline
            renewed = False
            while self.clock.now() < deadline and not self._stop.is_set():
                if self._try_acquire_or_renew():
                    renewed = True
                    break
                self._stop.wait(self.retry_period / 4)
            if not renewed or not self.is_leader():
                return
            self._stop.wait(self.retry_period)

    def _try_acquire_or_renew(self) -> bool:
        now = self.clock.now()
        record = LeaderElectionRecord(
            holder_identity=self.identity,
            lease_duration_seconds=self.lease_duration,
            acquire_time=now,
            renew_time=now,
        )
        endpoints = self.client.resource("endpoints", self.namespace)
        try:
            obj = endpoints.get(self.name)
        except APIStatusError as e:
            if e.code != 404:
                return False
            ep = t.Endpoints(
                metadata=t.ObjectMeta(
                    name=self.name,
                    namespace=self.namespace,
                    annotations={LEADER_ANNOTATION: _encode(record)},
                )
            )
            with self._write_lock:
                if self._stop.is_set():
                    return False
                try:
                    endpoints.create(ep)
                except APIStatusError:
                    return False
                self.observed_record = record
                self.observed_time = now
            return True

        existing = _decode(obj.metadata.annotations.get(LEADER_ANNOTATION, ""))
        if existing is not None:
            if (
                self.observed_record is None
                or self.observed_record != existing
            ):
                # the observation cache is read by stop()'s lease
                # release on another thread: same lock as every other
                # observed_* write (race found by the armed detector)
                with self._write_lock:
                    self.observed_record = existing
                    self.observed_time = now
            if (
                existing.holder_identity != self.identity
                and self.observed_time + existing.lease_duration_seconds > now
            ):
                return False  # lease held and fresh
            if existing.holder_identity == self.identity:
                record.acquire_time = existing.acquire_time

        obj.metadata.annotations[LEADER_ANNOTATION] = _encode(record)
        with self._write_lock:
            if self._stop.is_set():
                return False  # stop() won the race: keep its released lease
            try:
                endpoints.update(obj)  # CAS via resourceVersion
            except APIStatusError:
                return False
            self.observed_record = record
            self.observed_time = self.clock.now()
        return True


def _encode(r: LeaderElectionRecord) -> str:
    return json.dumps(
        {
            "holderIdentity": r.holder_identity,
            "leaseDurationSeconds": r.lease_duration_seconds,
            "acquireTime": r.acquire_time,
            "renewTime": r.renew_time,
        }
    )


def _decode(s: str) -> Optional[LeaderElectionRecord]:
    if not s:
        return None
    try:
        d = json.loads(s)
        return LeaderElectionRecord(
            holder_identity=d["holderIdentity"],
            lease_duration_seconds=d["leaseDurationSeconds"],
            acquire_time=d["acquireTime"],
            renew_time=d["renewTime"],
        )
    except Exception:
        return None
