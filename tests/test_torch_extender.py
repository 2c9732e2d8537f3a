"""The port's inbound scheduler-extender service against the JAX
package's TPUExtenderServer, on the CPU: the same replies to the same
bodies (tests/test_extender_server.py's, and a Policy with services),
one HTTP round trip in which the JAX package's outbound HTTPExtender
calls the port's server, an oracle-driven scheduler that delegates to
the port's extender, and `python -m kubernetes_tpu_torch.hyperkube
extender` serving a request."""

import json
import os
import pathlib
import subprocess
import sys
import urllib.request

import pytest
import torch

from kubernetes_tpu.api import types as t
from kubernetes_tpu.models import batch as JB
from kubernetes_tpu.oracle import ClusterState
from kubernetes_tpu.oracle import predicates as opreds
from kubernetes_tpu.oracle import priorities as oprios
from kubernetes_tpu.oracle.scheduler import PriorityConfig
from kubernetes_tpu.runtime.scheme import scheme
from kubernetes_tpu.scheduler.core import ExtendedGenericScheduler
from kubernetes_tpu.scheduler.extender import HTTPExtender
from kubernetes_tpu.scheduler.extender_server import TPUExtenderServer
from kubernetes_tpu.scheduler.policy import ExtenderConfig

from kubernetes_tpu_torch.models import batch as TB
from kubernetes_tpu_torch.scheduler import extender_server as TES
from kubernetes_tpu_torch.scheduler.extender_server import (
    TorchExtenderServer,
)

import tests.test_extender_server as TE
import tests.test_wave as TW

ROOT = pathlib.Path(__file__).resolve().parent.parent

CONFIG = dict(predicates=(JB.GENERAL_PREDICATES,
                          JB.POD_TOLERATES_NODE_TAINTS),
              priorities=((JB.LEAST_REQUESTED, 1),))
SVC_CONFIG = dict(
    predicates=(JB.GENERAL_PREDICATES, (JB.SERVICE_AFFINITY, ("zone",))),
    priorities=((JB.LEAST_REQUESTED, 1), ((JB.SERVICE_ANTI_AFFINITY, "zone"),
                                          2)))


def _servers(config):
    return (TPUExtenderServer(JB.SchedulerConfig(**config)),
            TorchExtenderServer(TB.SchedulerConfig(**config), device="cpu"))


def _nodes_body(nodes):
    return {"items": [scheme.encode(n) for n in nodes]}


def _tainted_nodes():
    return [TE.node("n0"), TE.node("n1", cpu="8"),
            TE.node("n-taint", taints=[t.Taint(key="dedicated", value="x",
                                               effect="NoSchedule")])]


def _bodies():
    """verb -> body: tests/test_extender_server.py's bodies, and the
    same verbs under a Policy with ServiceAffinity/ServiceAntiAffinity on
    a zoned cluster with one member already placed."""
    nodes = _tainted_nodes()
    four = [TE.node(f"n{i}") for i in range(4)]
    zoned = TW._zone_nodes(9, unlabeled=1)
    peer = TW._members(1, name0=900)[0]
    peer.spec.node_name = "node-0004"
    members = TW._members(12)
    svc = {"items": [scheme.encode(t.Service(
        metadata=t.ObjectMeta(name="app"),
        spec=t.ServiceSpec(selector={"app": "x"})))]}
    return [
        (CONFIG, "filter", {"pod": scheme.encode(TE.pod("p0")),
                            "nodes": _nodes_body(nodes)}),
        (CONFIG, "prioritize", {"pod": scheme.encode(TE.pod("p0")),
                                "nodes": _nodes_body(nodes)}),
        (CONFIG, "filter", {
            "pod": scheme.encode(TE.pod("p0", cpu="3")),
            "nodes": _nodes_body([TE.node("n0"), TE.node("n1")]),
            "existingPods": [scheme.encode(TE.pod("busy", cpu="2",
                                                  node_name="n0"))]}),
        (CONFIG, "scheduleBacklog", {
            "nodes": _nodes_body(four),
            "pending": {"items": [scheme.encode(TE.pod(f"p{i:02d}"))
                                  for i in range(12)]},
            "lastNodeIndex": 0}),
        (CONFIG, "scheduleBacklog", {"nodes": {"items": []},
                                     "pending": {"items": [
                                         scheme.encode(TE.pod("p0"))]},
                                     "lastNodeIndex": 5}),
        (CONFIG, "filter", {"pod": scheme.encode(TE.pod("p0")),
                            "nodes": {"items": []}}),
        (SVC_CONFIG, "filter", {"pod": scheme.encode(members[0]),
                                "nodes": _nodes_body(zoned),
                                "existingPods": [scheme.encode(peer)],
                                "services": svc}),
        (SVC_CONFIG, "prioritize", {"pod": scheme.encode(members[0]),
                                    "nodes": _nodes_body(zoned),
                                    "existingPods": [scheme.encode(peer)],
                                    "services": svc}),
        (SVC_CONFIG, "scheduleBacklog", {
            "nodes": _nodes_body(zoned), "services": svc,
            "pending": {"items": [scheme.encode(p) for p in members]},
            "lastNodeIndex": 3}),
        (CONFIG, "bogus", {}),
    ]


BODIES = _bodies()


@pytest.mark.parametrize("i", range(len(BODIES)),
                         ids=[f"{b[1]}-{i}" for i, b in enumerate(BODIES)])
def test_replies_match_tpu_extender(i):
    config, verb, body = BODIES[i]
    jax_server, port_server = _servers(config)
    want = jax_server.handle(verb, json.loads(json.dumps(body)))
    got = port_server.handle(verb, json.loads(json.dumps(body)))
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    if verb == "filter" and config is SVC_CONFIG:
        # the member follows its peer's zone (node-0004: zb)
        kept = {n["metadata"]["name"] for n in got[1]["nodes"]["items"]}
        assert kept and all(int(n[-4:]) % 3 == 1 for n in kept)
    assert TES.FAILED_REASON == "TPUExtenderPredicates"


@pytest.fixture()
def port_service():
    server = TorchExtenderServer(TB.SchedulerConfig(**CONFIG), device="cpu")
    host, port = server.serve_http()
    yield server, f"http://{host}:{port}"
    server.shutdown()


def test_http_round_trip_with_the_outbound_extender(port_service):
    """The JAX package's own HTTPExtender drives the port's server over
    127.0.0.1; the replies equal the host oracle's view."""
    _, base = port_service
    ext = HTTPExtender(ExtenderConfig(url_prefix=base, filter_verb="filter",
                                      prioritize_verb="prioritize", weight=1))
    nodes = _tainted_nodes()
    p = TE.pod("p0")
    filtered, failed = ext.filter(p, nodes)
    assert [n.metadata.name for n in filtered] == ["n0", "n1"]
    assert failed == {"n-taint": "TPUExtenderPredicates"}
    scores = dict(ext.prioritize(p, nodes))
    expected = oprios.least_requested_priority(p, ClusterState.build(nodes))
    assert scores == {n: expected[n] for n in scores}
    req = urllib.request.Request(f"{base}/v1beta1/filter", data=b"{bad",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req)
    assert err.value.code == 400


def _delegating_oracle(base):
    """An oracle-driven scheduler whose own predicates know nothing of
    taints; only the extender (the device program) does."""
    return ExtendedGenericScheduler(
        [("GeneralPredicates", opreds.general_predicates)],
        [PriorityConfig(oprios.equal_priority, 1, "EqualPriority")],
        [HTTPExtender(ExtenderConfig(url_prefix=base, filter_verb="filter",
                                     prioritize_verb="prioritize",
                                     weight=1))])


def test_oracle_delegates_to_the_port_extender(port_service):
    _, base = port_service
    jax_server = TPUExtenderServer(JB.SchedulerConfig(**CONFIG))
    host, port = jax_server.serve_http()
    try:
        nodes = [TE.node(f"ok{i}") for i in range(3)] + [TE.node(
            "bad", taints=[t.Taint(key="dedicated", value="x",
                                   effect="NoSchedule")])]
        pods = [TE.pod(f"p{i}") for i in range(9)]
        got = _delegating_oracle(base).schedule_backlog(
            pods, ClusterState.build(nodes))
        want = _delegating_oracle(f"http://{host}:{port}").schedule_backlog(
            pods, ClusterState.build(nodes))
    finally:
        jax_server.shutdown()
    assert got == want
    assert all(got) and "bad" not in got


def test_hyperkube_extender_serves(tmp_path):
    """`python -m kubernetes_tpu_torch.hyperkube extender --device cpu`
    starts, prints its address and answers a filter."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch.hyperkube", "extender",
         "--port", "0", "--device", "cpu"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "serving Filter/Prioritize/ScheduleBacklog" in line, (
            line + proc.stderr.read() if proc.poll() is not None else line)
        base = line.split(" on ")[1].split()[0]
        body = {"pod": scheme.encode(TE.pod("p0")),
                "nodes": _nodes_body(_tainted_nodes())}
        req = urllib.request.Request(
            f"{base}/filter", data=json.dumps(body).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        # the default SchedulerConfig filters the NoSchedule taint
        assert out["failedNodes"] == {"n-taint": "TPUExtenderPredicates"}
    finally:
        proc.kill()
        proc.communicate(timeout=30)


def test_extender_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchExtenderServer()
