"""Inbound scheduler-extender service backed by the port's device program.

PyTorch counterpart of kubernetes_tpu/scheduler/extender_server.py
(TPUExtenderServer): the same verbs, JSON shapes and FAILED_REASON, so
an external scheduler (the reference's Go binary, or an oracle-driven
scheduler with an HTTPExtender) can delegate Filter/Prioritize — and
bulk ScheduleBacklog — to the card over the reference's extender wire
protocol (plugin/pkg/scheduler/extender.go:96-173, api/types.go:135-151).

Wire surface (POST, JSON):
  /<apiVersion>/filter      {pod, nodes:{items}, existingPods?, services?}
                            -> {nodes:{items}, failedNodes:{name:reason},
                                error}
  /<apiVersion>/prioritize  same body -> [{host, score}]
  /<apiVersion>/scheduleBacklog
                            {nodes:{items}, existingPods?, services?,
                             pending:{items}, lastNodeIndex?}
                            -> {assignments:{namespace/name: node|null},
                                lastNodeIndex}

Filter/Prioritize are per-request pure (models/batch.BatchScheduler.
debug_evaluate against the shipped cluster); scheduleBacklog schedules
the whole pending list with the serial scan (BatchScheduler.schedule).
The service runs on `device`, the card unless it is constructed with
device="cpu"; without CUDA the default raises.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from kubernetes_tpu_torch.api.types import Node, Pod, Service
from kubernetes_tpu_torch.models.batch import BatchScheduler, SchedulerConfig
from kubernetes_tpu_torch.oracle.state import ClusterState
from kubernetes_tpu_torch.runtime import scheme as default_scheme
from kubernetes_tpu_torch.snapshot.encode import SnapshotEncoder

FAILED_REASON = "TPUExtenderPredicates"


class TorchExtenderServer:
    """Serves the extender wire protocol off the port's batched program."""

    def __init__(self, config=None, scheme=None, api_version: str = "v1beta1",
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchExtenderServer: CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        self.config = config or SchedulerConfig()
        self.scheme = scheme or default_scheme
        self.api_version = api_version
        self._sched = BatchScheduler(self.config, device=self.device)
        self._lock = threading.Lock()  # device dispatch is serialized
        self._server = None

    # -- request handling ----------------------------------------------------

    def _decode_cluster(self, body: dict) -> ClusterState:
        nodes = [
            self.scheme.decode(n, Node)
            for n in (body.get("nodes") or {}).get("items", [])
        ]
        existing = [
            self.scheme.decode(p, Pod)
            for p in body.get("existingPods", [])
        ]
        services = [
            self.scheme.decode(s, Service)
            for s in (body.get("services") or {}).get("items", [])
        ]
        state = ClusterState.build(nodes, services=services)
        for ep in existing:
            if ep.spec.node_name in state.node_infos:
                state.assign(ep)
        return state

    def _evaluate(self, body: dict):
        """(node_names, fit[N] bool, score[N] int) for body's pod."""
        state = self._decode_cluster(body)
        pod = self.scheme.decode(body["pod"], Pod)
        if not state.node_infos:
            return [], np.zeros(0, bool), np.zeros(0, np.int64)
        snap, batch = SnapshotEncoder(state, [pod], config=self.config).encode()
        with self._lock:
            fit, score = self._sched.debug_evaluate(snap, batch)
        return list(snap.node_names), fit[0], score[0]

    def handle(self, verb: str, body: dict):
        if verb == "filter":
            names, fit, _ = self._evaluate(body)
            items = (body.get("nodes") or {}).get("items", [])
            by_name = {
                (n.get("metadata") or {}).get("name", ""): n for n in items
            }
            passed, failed = [], {}
            for name, ok in zip(names, fit):
                if bool(ok):
                    passed.append(by_name[name])
                else:
                    failed[name] = FAILED_REASON
            return 200, {
                "nodes": {"kind": "NodeList", "items": passed},
                "failedNodes": failed,
                "error": "",
            }
        if verb == "prioritize":
            names, _, score = self._evaluate(body)
            return 200, [
                {"host": name, "score": int(s)}
                for name, s in zip(names, score)
            ]
        if verb == "scheduleBacklog":
            state = self._decode_cluster(body)
            pending = [
                self.scheme.decode(p, Pod)
                for p in (body.get("pending") or {}).get("items", [])
            ]
            last = int(body.get("lastNodeIndex", 0))
            if not state.node_infos:
                return 200, {
                    "assignments": {
                        p.metadata.full_name: None for p in pending
                    },
                    "lastNodeIndex": last,
                }
            snap, batch = SnapshotEncoder(
                state, pending, config=self.config
            ).encode()
            with self._lock:
                chosen, final = self._sched.schedule(
                    snap, batch, last_node_index=last
                )
            names = snap.node_names
            return 200, {
                # keyed namespace/name: bare names collide across
                # namespaces
                "assignments": {
                    p.metadata.full_name: (
                        names[int(c)] if 0 <= int(c) < len(names) else None
                    )
                    for p, c in zip(pending, chosen)
                },
                "lastNodeIndex": int(final["last_idx"]),
            }
        return 404, {"error": f"unknown verb {verb!r}"}

    # -- HTTP ----------------------------------------------------------------

    def serve_http(self, host: str = "127.0.0.1", port: int = 0):
        """Serve on a daemon thread: -> (host, bound port)."""
        svc = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                parts = self.path.strip("/").split("/")
                if len(parts) != 2 or parts[0] != svc.api_version:
                    self._send(404, {"error": f"unknown path {self.path}"})
                    return
                length = int(self.headers.get("Content-Length") or 0)
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self._send(400, {"error": "invalid JSON"})
                    return
                try:
                    code, payload = svc.handle(parts[1], body)
                except Exception as e:
                    # non-200 so every verb's client surfaces the failure
                    # (the prioritize reply shape has no error field)
                    code, payload = 500, {"error": str(e)}
                self._send(code, payload)

            def _send(self, code, payload):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        class Server(ThreadingHTTPServer):
            request_queue_size = 64  # default backlog of 5 RSTs bursts
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        threading.Thread(
            target=self._server.serve_forever,
            name="torch-extender",
            daemon=True,
        ).start()
        return host, self._server.server_address[1]

    def shutdown(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
