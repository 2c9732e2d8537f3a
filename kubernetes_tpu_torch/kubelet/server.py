"""The kubelet's node-local API (pkg/kubelet/server: the :10250 surface).

Serves the debugging endpoints kubectl needs a node for:

    GET  /healthz
    GET  /pods                                   (this node's pod specs)
    GET  /containerLogs/{ns}/{pod}/{container}   (?tailLines=N)
    POST /exec/{ns}/{pod}/{container}?command=...
    GET  /attach/{ns}/{pod}/{container}          (chunked follow stream)
    POST /portForward/{ns}/{pod}?port=N          (raw byte relay after 200)
    GET  /stats/summary                          (cadvisor-lite node stats)

Log/exec content comes from the container runtime seam — FakeRuntime
records written log lines and replies to exec with injectable output, the
hollow-node idiom. The kubelet registers the serving address and port on
its Node status (status.daemonEndpoints.kubeletEndpoint in the
reference; addresses + kubelet_port here) so clients can resolve it.

Copy of kubernetes_tpu/kubelet/server.py: only the import package differs.
"""

from __future__ import annotations

import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


def _relay(a: socket.socket, b: socket.socket) -> None:
    """Bidirectional byte copy until either side closes (the
    port-forward data plane). Runs on the caller's thread plus one
    helper; returns when both directions drain."""

    def pump(src, dst):
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            try:
                dst.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    t = threading.Thread(target=pump, args=(b, a), daemon=True)
    t.start()
    pump(a, b)
    t.join(timeout=10)
    try:
        b.close()
    except OSError:
        pass


def build_summary(kl) -> dict:
    """The /stats/summary payload (kubelet Summary API,
    stats/summary.go): per-node and per-pod cpu/memory/device usage.

    cpu/memory come from the container runtime's /proc sampling when it
    runs real processes (ProcessRuntime.pod_stats); device usage is the
    pod's requested accelerator count (the devices are logical slots
    here, so requested == held while the pod runs). Consumers: `kubectl
    top nodes|pods` and the heterogeneity-aware scoring work
    (PAPERS.md: per-node accounting)."""
    import os as _os

    from kubernetes_tpu_torch.api.resource import resource_list_gpu

    clk = 100.0
    try:
        clk = float(_os.sysconf("SC_CLK_TCK")) or 100.0
    except (ValueError, OSError, AttributeError):
        pass
    mem_avail = None
    if kl.eviction_manager is not None:
        mem_avail = kl.eviction_manager.memory_available()
    with kl._lock:
        pods = list(kl._pods.values())
    pod_stats = getattr(kl.runtime, "pod_stats", None)
    node_cpu_seconds = 0.0
    node_rss = 0
    node_devices = 0
    out_pods = []
    for p in pods:
        containers = []
        pod_cpu = 0.0
        pod_rss = 0
        stats = pod_stats(p.metadata.uid) if pod_stats is not None else {}
        for cname, cs in sorted(stats.items()):
            cpu_s = cs.get("cpu_jiffies", 0) / clk
            rss = cs.get("memory_rss_bytes", 0)
            pod_cpu += cpu_s
            pod_rss += rss
            containers.append({
                "name": cname,
                "cpu": {"usageCoreSeconds": round(cpu_s, 3)},
                "memory": {"rssBytes": rss},
            })
        devices = sum(
            resource_list_gpu(c.requests) for c in p.spec.containers
        )
        node_cpu_seconds += pod_cpu
        node_rss += pod_rss
        node_devices += devices
        out_pods.append({
            "podRef": {
                "namespace": p.metadata.namespace,
                "name": p.metadata.name,
                "uid": p.metadata.uid,
            },
            "cpu": {"usageCoreSeconds": round(pod_cpu, 3)},
            "memory": {"rssBytes": pod_rss},
            "devices": {"requested": devices},
            "containers": containers,
        })
    return {
        "node": {
            "nodeName": kl.config.node_name,
            "cpu": {"usageCoreSeconds": round(node_cpu_seconds, 3)},
            "memory": {
                "availableBytes": mem_avail,
                "workingSetBytes": node_rss,
            },
            "devices": {"requested": node_devices},
        },
        "pods": out_pods,
    }


class KubeletServer:
    def __init__(self, kubelet):
        self.kubelet = kubelet
        self._server = None

    def serve(self, host: str = "127.0.0.1", port: int = 0,
              tls_cert: str = "", tls_key: str = "",
              auth_token: str = ""):
        """tls_cert/tls_key serve HTTPS (the reference's :10250 is TLS
        by default, kubelet/server.go ListenAndServeKubeletServer);
        auth_token demands `Authorization: Bearer <token>` on every
        endpoint except /healthz (the webhook/x509 kubelet authn gate,
        server.go AuthFilter). Unauthenticated exec/logs on a runtime
        that runs REAL processes is remote code execution — the gate
        lands with the ProcessRuntime."""
        kl = self.kubelet

        def find_pod(ns: str, name: str):
            with kl._lock:
                for p in kl._pods.values():
                    if p.metadata.namespace == ns and p.metadata.name == name:
                        return p
            return None

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _send(self, code, payload, content_type="application/json"):
                data = (
                    payload.encode()
                    if isinstance(payload, str)
                    else json.dumps(payload).encode()
                )
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _authorized(self) -> bool:
                if not auth_token:
                    return True
                parsed = urlparse(self.path)
                if parsed.path == "/healthz":
                    return True  # liveness stays probeable (reference
                    # serves healthz on the read-only port)
                got = self.headers.get("Authorization", "")
                if got == f"Bearer {auth_token}":
                    return True
                self._send(401, {"message": "Unauthorized"})
                return False

            def do_GET(self):
                if not self._authorized():
                    return
                try:
                    self._get(urlparse(self.path))
                except ValueError as e:
                    self._send(400, {"message": str(e)})
                except Exception as e:
                    self._send(500, {"message": str(e)})

            def _get(self, parsed):
                parts = [p for p in parsed.path.split("/") if p]
                if parts == ["healthz"]:
                    self._send(200, "ok", "text/plain")
                    return
                if parts == ["metrics"]:
                    # the node daemon renders the registry itself now
                    # (reference kubelet serves prometheus on :10250)
                    from kubernetes_tpu_torch.metrics import (
                        registry as metrics_registry,
                    )

                    self._send(200, metrics_registry.render(),
                               "text/plain; version=0.0.4")
                    return
                if parts == ["debug", "traces"]:
                    from kubernetes_tpu_torch.trace.httpd import render_traces

                    q = {
                        k: v[0]
                        for k, v in parse_qs(parsed.query).items() if v
                    }
                    self._send(200, render_traces(q))
                    return
                if parts == ["debug", "audit"]:
                    from kubernetes_tpu_torch.audit import render_audit

                    q = {
                        k: v[0]
                        for k, v in parse_qs(parsed.query).items() if v
                    }
                    self._send(200, render_audit(q))
                    return
                if parts == ["pods"]:
                    from kubernetes_tpu_torch.runtime import scheme

                    with kl._lock:
                        pods = list(kl._pods.values())
                    self._send(200, {
                        "kind": "PodList",
                        "items": [scheme.encode(p) for p in pods],
                    })
                    return
                if parts[:1] == ["containerLogs"] and len(parts) == 4:
                    _, ns, name, container = parts
                    pod = find_pod(ns, name)
                    if pod is None:
                        self._send(404, {"message": f"pod {ns}/{name} not found"})
                        return
                    q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                    lines = kl.runtime.get_logs(
                        pod.metadata.uid, container,
                        tail=int(q["tailLines"]) if "tailLines" in q else None,
                    )
                    self._send(200, "".join(lines), "text/plain")
                    return
                if parts[:1] == ["attach"] and len(parts) == 4:
                    # server/server.go:63 getAttach — a follow stream of
                    # the container's output, chunked so the client sees
                    # writes as they happen
                    _, ns, name, container = parts
                    pod = find_pod(ns, name)
                    if pod is None:
                        self._send(404, {"message": f"pod {ns}/{name} not found"})
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    try:
                        for chunk in kl.runtime.attach(
                            pod.metadata.uid, container
                        ):
                            data = chunk.encode()
                            self.wfile.write(
                                f"{len(data):x}\r\n".encode() + data + b"\r\n"
                            )
                            self.wfile.flush()
                        self.wfile.write(b"0\r\n\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass  # client hung up: detach
                    return
                if parts == ["stats", "summary"]:
                    self._send(200, build_summary(kl))
                    return
                self._send(404, {"message": f"unknown path {parsed.path}"})

            def do_POST(self):
                if not self._authorized():
                    return
                try:
                    self._post(urlparse(self.path))
                except ValueError as e:
                    self._send(400, {"message": str(e)})
                except Exception as e:
                    self._send(500, {"message": str(e)})

            def _post(self, parsed):
                parts = [p for p in parsed.path.split("/") if p]
                if parts[:1] == ["exec"] and len(parts) == 4:
                    _, ns, name, container = parts
                    pod = find_pod(ns, name)
                    if pod is None:
                        self._send(404, {"message": f"pod {ns}/{name} not found"})
                        return
                    q = parse_qs(parsed.query)
                    command = q.get("command", [])
                    out = kl.runtime.exec_in(
                        pod.metadata.uid, container, command
                    )
                    self._send(200, out, "text/plain")
                    return
                if parts[:1] == ["portForward"] and len(parts) == 3:
                    # server/server.go:63 getPortForward — after the 200
                    # the HTTP connection becomes a raw bidirectional
                    # byte relay to the pod's port (the SPDY-upgrade
                    # analogue, without the SPDY)
                    _, ns, name = parts
                    pod = find_pod(ns, name)
                    if pod is None:
                        self._send(404, {"message": f"pod {ns}/{name} not found"})
                        return
                    q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                    try:
                        port = int(q.get("port", ""))
                    except ValueError:
                        self._send(400, {"message": "port required"})
                        return
                    try:
                        upstream = kl.runtime.port_socket(
                            pod.metadata.uid, port
                        )
                    except KeyError as e:
                        self._send(400, {"message": str(e)})
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    self.wfile.flush()
                    self.close_connection = True
                    # a client may pipeline payload bytes in the same
                    # TCP segment as the headers: they sit in rfile's
                    # buffer, which the raw-socket relay cannot see.
                    # Non-blocking drain: only already-buffered bytes,
                    # never a blocking read.
                    self.connection.setblocking(False)
                    try:
                        buffered = self.rfile.read1(65536) or b""
                    except (BlockingIOError, OSError):
                        buffered = b""
                    finally:
                        self.connection.setblocking(True)
                    if buffered:
                        upstream.sendall(buffered)
                    _relay(self.connection, upstream)
                    return
                self._send(404, {"message": f"unknown path {parsed.path}"})

        class Server(ThreadingHTTPServer):
            request_queue_size = 64  # default backlog of 5 RSTs bursts
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        if tls_cert and tls_key:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
            # lazy handshake: a silent client must not wedge accept()
            self._server.socket = ctx.wrap_socket(
                self._server.socket, server_side=True,
                do_handshake_on_connect=False,
            )
        threading.Thread(
            target=self._server.serve_forever,
            name=f"kubelet-server-{kl.config.node_name}",
            daemon=True,
        ).start()
        return host, self._server.server_address[1]

    def shutdown(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
