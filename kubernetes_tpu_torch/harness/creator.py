"""Lean pod-creation worker (perf/util.go:120-175 makePodsFromRC).

Separated from harness.perf so the creator SUBPROCESS of the wire
density rep imports no scheduler/apiserver/jax modules: its start-up
sits INSIDE the measured creation window, and pulling the tensor stack
cost it ~1.3s of import before the first request left the socket.

    python -m kubernetes_tpu_torch.harness.creator --server http://... --pods N

Copy of kubernetes_tpu/harness/creator.py: only the import package differs.
"""

from __future__ import annotations

import argparse
import sys

from kubernetes_tpu_torch.api.types import (
    Container,
    Node,
    NodeCondition,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodSpec,
)
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.utils.workqueue import parallelize


def make_nodes(client: RESTClient, n: int) -> None:
    """perf/util.go:88-118 node shape. Bulk-created: one request per
    2000 nodes instead of one per node (1000 sequential creates cost
    ~2s of request round-trips before the measurement even starts)."""
    nodes = [
        Node(
            metadata=ObjectMeta(name=f"node-{i:05d}"),
            status=NodeStatus(
                capacity={"cpu": "4", "memory": "32Gi", "pods": "110"},
                allocatable={"cpu": "4", "memory": "32Gi",
                             "pods": "110"},
                conditions=[NodeCondition("Ready", "True")],
            ),
        )
        for i in range(n)
    ]
    for i in range(0, len(nodes), 2000):
        res = client.nodes().create_many(nodes[i:i + 2000])
        for r in res:
            if r.get("status") != "Success":
                raise RuntimeError(
                    f"node create failed: {r.get('message', r)}")


def _perf_pod() -> Pod:
    return Pod(
        metadata=ObjectMeta(
            generate_name="sched-perf-pod-",
            labels={"name": "sched-perf"},
        ),
        spec=PodSpec(
            containers=[
                Container(
                    name="pause",
                    image="kubernetes/pause:go",
                    requests={"cpu": "100m", "memory": "500Mi"},
                )
            ]
        ),
    )


def make_pods(client: RESTClient, p: int, creators: int = 6,
              chunk: int = 1500) -> None:
    """perf/util.go:143-175 makePodsFromRC: pause pods, parallel
    creation. Batches flow through the bulk-create endpoint (an RC
    manager burst-creates its whole replica delta too); generateName
    collisions retry like the reference's RC manager self-heal.

    The count is VERIFIED against the server afterwards and any
    shortfall topped up: a connection dropped mid-request loses the
    reply (pods may or may not exist), parallelize logs worker panics
    without failing (HandleCrash semantics), and a density measurement
    waiting for a pod that was never created stalls forever.

    creators defaults to 6 x 1500-pod chunks (the reference runs 30
    workers): the apiserver is GIL-bound, so extra concurrency doesn't
    add throughput — it only inflates per-request latency until
    requests trip the client timeout, and every timed-out bulk reply
    costs a serial top-up reconciliation at the end. Fewer, larger
    chunks also cut the per-request recv wakeups, which are real CPU
    under gVisor."""
    chunks = [min(chunk, p - i) for i in range(0, p, chunk)]
    # Every pod is the SAME generateName template — the server mints
    # the names. Encoding the dataclass once and repeating the dict
    # (the TLV writer just reads it N times) drops the ~32us-per-pod
    # client-side encode that was ~1s of a 30k-pod storm. One step
    # further on the binary wire: the whole List BODY is TLV-encoded
    # once per distinct chunk size and POSTed as pre-encoded bytes —
    # 20 identical 1500-pod requests pay ONE body encode, not 20.
    template = client.scheme.encode(_perf_pod())
    pods_path = "/api/v1/namespaces/default/pods"
    bin_wire = getattr(client.transport, "binary", False)
    bodies: dict = {}

    def body_for(want: int):
        if not bin_wire:
            return {"kind": "List", "items": [template] * want}
        data = bodies.get(want)
        if data is None:
            from kubernetes_tpu_torch.runtime import binary as bin_codec

            data = bodies[want] = bin_codec.encode(
                {"kind": "List", "items": [template] * want})
        return data

    def create(ci: int) -> None:
        want = chunks[ci]
        for _ in range(5):
            payload = client.do_raw(
                "POST", pods_path, body=body_for(want),
            )
            res = payload.get("items", [])
            want = 0
            for r in res:
                if r.get("status") == "Success":
                    continue
                msg = r.get("message", "")
                if "already exists" in msg:
                    want += 1  # generateName collision: retry that one
                else:
                    raise RuntimeError(f"pod create failed: {msg}")
            if want == 0:
                return
        raise RuntimeError("pod create kept colliding")

    parallelize(min(creators, len(chunks)), len(chunks), create)

    def count() -> int:
        return len(client.pods().list(label_selector="name=sched-perf")[0])

    have = count()
    for _ in range(10):
        if have >= p:
            return
        missing = p - have
        print(f"pod creation shortfall: {missing} lost to dropped "
              "connections; topping up", file=sys.stderr)
        chunks[:] = [min(chunk, missing - i)
                     for i in range(0, missing, chunk)]
        # reuse the chunk worker: collision retries + loud non-collision
        # failures (a validation error must surface, not read as a
        # shortfall)
        for ci in range(len(chunks)):
            create(ci)
        have = count()
    raise RuntimeError(
        f"pod creation kept falling short: {have}/{p} after top-ups"
    )


def main(argv=None):
    from kubernetes_tpu_torch.client.transport import HTTPTransport

    ap = argparse.ArgumentParser()
    ap.add_argument("--server", required=True)
    ap.add_argument("--pods", type=int, required=True)
    args = ap.parse_args(argv)
    # a named tenant flow (workload-high), NOT control-plane exempt:
    # the creator is the workload the apiserver is allowed to queue
    client = RESTClient(HTTPTransport(args.server, binary=True,
                                      timeout=180.0,
                                      user="perf-creator"))
    make_pods(client, args.pods)


if __name__ == "__main__":
    main()
