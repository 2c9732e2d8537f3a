"""How many threads one process may start, and how a local cluster's
threads grow with its pods.

    python -m kubernetes_tpu_torch.harness.thread_census limit \\
        [--stack BYTES] [--max N]
    python -m kubernetes_tpu_torch.harness.thread_census local-up \\
        [--module M] [--device D] [--nodes N] STEP [STEP ...]

`limit` starts sleeping threads until --max or a failure, with --stack
bytes of stack each (0: the default), and prints the count with the
process's VmSize and VmRSS (kB) every 100, flushed, so that the last
line stands when the machine kills the process.

`local-up` runs `python -m M local-up` (M is the port's hyperkube unless
--module names another with the same CLI) with N hollow nodes as a child
process, creates an RC of pause pods at scheduler_perf's shape with the
port's kubectl and scales it through each STEP, and prints one JSON line
a second: the child's RSS, virtual size, threads and mappings, the RC's
pods and the unbound ones. It ends when every step's pods are bound or
the child dies, and then prints the child's exit code.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import threading
import time


def _status(pid) -> dict:
    out = {}
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key in ("VmRSS", "VmSize", "Threads"):
                    out[key] = int(value.split()[0])
        with open(f"/proc/{pid}/maps") as f:
            out["maps"] = sum(1 for _ in f)
    except OSError:
        pass
    return out


def thread_limit(stack: int, most: int) -> int:
    if stack:
        threading.stack_size(stack)
    stop = threading.Event()
    n = 0
    try:
        while n < most:
            threading.Thread(target=stop.wait, daemon=True).start()
            n += 1
            if n % 100 == 0:
                st = _status("self")
                print(f"stack={stack} threads={n} VmSize={st.get('VmSize')} "
                      f"VmRSS={st.get('VmRSS')}", flush=True)
    except RuntimeError as e:
        print(f"stack={stack} failed at {n}: {e!r}", flush=True)
    print(f"stack={stack} reached {n}", flush=True)
    return 0


def _rc(replicas: int) -> dict:
    return {"apiVersion": "v1", "kind": "ReplicationController",
            "metadata": {"name": "density", "namespace": "default"},
            "spec": {"replicas": replicas, "selector": {"name": "density"},
                     "template": {
                         "metadata": {"labels": {"name": "density"}},
                         "spec": {"containers": [{
                             "name": "pause", "image": "kubernetes/pause",
                             "requests": {"cpu": "100m",
                                          "memory": "500Mi"}}]}}}}


def local_up(module: str, device, nodes: int, steps: list) -> int:
    from kubernetes_tpu_torch.client.rest import RESTClient
    from kubernetes_tpu_torch.client.transport import HTTPTransport
    from kubernetes_tpu_torch.harness.child import Child, kubectl
    from kubernetes_tpu_torch.harness.procs import free_ports
    from kubernetes_tpu_torch.utils.wait import poll_until

    port = free_ports(1)[0]
    url = f"http://127.0.0.1:{port}"
    argv = [sys.executable, "-m", module, "local-up", "--port", str(port),
            "--nodes", str(nodes), "--cloud-provider", "multizone"]
    if device:
        argv += ["--device", device]
    child = Child("local-up", argv)
    client = RESTClient(HTTPTransport(url, timeout=60.0))
    t0 = time.monotonic()
    seen: dict = {}
    done = threading.Event()

    def sample():
        while not done.wait(1.0):
            print(json.dumps({"t": round(time.monotonic() - t0, 1),
                              **seen, **_status(child.proc.pid)}),
                  flush=True)
            if child.proc.poll() is not None:
                print(f"# local-up exit {child.proc.returncode}; its last "
                      f"lines: {child.lines[-5:]}", flush=True)
                os._exit(1)

    def up():
        try:
            return len(client.nodes().list()[0]) >= nodes
        except Exception:
            return False

    threading.Thread(target=sample, daemon=True).start()
    try:
        if not poll_until(up, 0.5, 300):
            raise RuntimeError(f"{nodes} nodes not registered in 300 s")
        rcs = client.resource("replicationcontrollers", "default")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "rc.json")
            with open(path, "w") as f:
                json.dump(_rc(steps[0]), f)
            kubectl(url, "create", "-f", path)
        for i, n in enumerate(steps):
            if i:
                kubectl(url, "scale", "rc/density", "--replicas", str(n))
            t1 = time.monotonic()

            def bound():
                seen["replicas"] = rcs.get("density").status.replicas
                seen["unbound"] = len(client.pods("default").list(
                    label_selector="name=density",
                    field_selector="spec.nodeName=")[0])
                return seen["replicas"] == n and not seen["unbound"]

            poll_until(bound, 2.0, float("inf"))
            print(f"# {n} pods bound in {time.monotonic() - t1:.1f} s",
                  flush=True)
        done.set()
        print(json.dumps({"t": round(time.monotonic() - t0, 1), **seen,
                          **_status(child.proc.pid)}), flush=True)
    finally:
        child.stop(signal.SIGINT)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="thread_census")
    sub = p.add_subparsers(dest="cmd", required=True)
    lim = sub.add_parser("limit")
    lim.add_argument("--stack", type=int, default=0)
    lim.add_argument("--max", type=int, default=12000)
    lu = sub.add_parser("local-up")
    lu.add_argument("--module", default="kubernetes_tpu_torch.hyperkube")
    lu.add_argument("--device", default=None)
    lu.add_argument("--nodes", type=int, default=200)
    lu.add_argument("steps", type=int, nargs="+")
    args = p.parse_args(argv)
    if args.cmd == "limit":
        return thread_limit(args.stack, args.max)
    return local_up(args.module, args.device, args.nodes, args.steps)


if __name__ == "__main__":
    sys.exit(main())
