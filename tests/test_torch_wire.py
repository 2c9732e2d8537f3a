"""The port's scheduler daemon on the wire, against the JAX package's:
one heterogeneous cluster (mixed requests, host ports, zones, a Service,
a PodGroup gang, a gang short of its minMember and a priority gang that
preempts) created in each package's apiserver before its daemon starts,
so that both FIFOs see one list. The pod -> node map read back from the
apiservers, the PodGroup statuses and the victims are equal, and the
port's binds equal the port's oracle copy on the same pods in the order
the loop bound them. Also: the provider registry wires the daemon's
scheduler cache into TorchScheduleAlgorithm (decisions off wave_view,
equal to the JAX provider's on the same cache events), and the port's
client and daemon speak the JAX apiserver's binary wire."""

import threading
import time

import pytest

import kubernetes_tpu.api.types as JT
from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.client import LocalTransport as JaxLocal
from kubernetes_tpu.client import RESTClient as JaxClient
from kubernetes_tpu.scheduler import algorithmprovider as JProv
from kubernetes_tpu.scheduler import cache as JC
from kubernetes_tpu.scheduler import core as JCore
from kubernetes_tpu.scheduler import factory as JFactory
from kubernetes_tpu.scheduler import plugins as JPlug
from kubernetes_tpu.scheduler import server as JServer

import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client import LocalTransport, RESTClient
from kubernetes_tpu_torch.client.transport import HTTPTransport
from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.oracle import ClusterState as PortState
from kubernetes_tpu_torch.oracle import GenericScheduler as PortOracle
from kubernetes_tpu_torch.scheduler import algorithmprovider as TProv
from kubernetes_tpu_torch.scheduler import cache as PC
from kubernetes_tpu_torch.scheduler import core as PCore
from kubernetes_tpu_torch.scheduler import factory as PFactory
from kubernetes_tpu_torch.scheduler import plugins as TPlug
from kubernetes_tpu_torch.scheduler import server as PServer
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm
from kubernetes_tpu_torch.snapshot.incremental import IncrementalEncoder


def wait_until(pred, timeout, interval=0.05) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return bool(pred())


def wait_settled(read, timeout, quiet=1.0, interval=0.05) -> bool:
    """Wait until read() has returned the same value for `quiet` seconds
    on end, up to `timeout` seconds in all; -> whether it settled."""
    deadline = time.monotonic() + timeout
    last, since = read(), time.monotonic()
    while time.monotonic() < deadline:
        time.sleep(interval)
        now = read()
        if now != last:
            last, since = now, time.monotonic()
        elif time.monotonic() - since >= quiet:
            return True
    return False


@pytest.fixture(autouse=True)
def jax_latency_histograms_kept():
    """The JAX daemon's waves below observe the JAX package's
    process-wide latency histograms; tests/test_slo.py gates on their
    median, so they are left as they were found."""
    from kubernetes_tpu import metrics as JM

    hists = (JM.scheduler_algorithm_latency, JM.scheduler_binding_latency,
             JM.scheduler_e2e_latency)
    saved = [(list(h._counts), h._sum, h._count) for h in hists]
    yield
    for h, (counts, total, n) in zip(hists, saved):
        with h._lock:
            h._counts, h._sum, h._count = counts, total, n


# -- the heterogeneous cluster ---------------------------------------------


def wire_cluster(T):
    """-> (nodes, bound pods, services, pod groups, pending pods) of
    package T's types: 12 nodes in zones a/b/c (the last four smaller,
    with a disktype label), each holding bound priority-0 fillers; a
    Service over the web pods; two web templates, host-port pods,
    singletons of distinct requests (some with a node selector), a gang
    of four that fits and a priority-10 PodGroup of one 2 CPU member that
    fits only after preemption. Every pod carries its own creation
    timestamp, so the director's newest-first victim order does not
    depend on when the pods were created.

    The preempting PodGroup has one member: the members of a parked
    gang come back to the FIFO one by one, each through the error
    handler's backoff thread and through the watch event of its
    condition update, so a wave can hold part of the gang, or one member
    twice (ROADMAP.md queue 3), and how many times it preempts depends on
    the threads' timing, in either package. One member comes back
    whole."""
    nodes, bound = S.bound_cluster(T, 12, per_node=18)
    for i, n in enumerate(nodes):
        n.metadata.name = f"n{i:02d}"
        n.metadata.labels = {S.ZONE: "abc"[i % 3]}
        if i >= 8:
            n.status.allocatable = {"cpu": "3", "memory": "16Gi",
                                    "pods": "40"}
            n.metadata.labels["disktype"] = "ssd"
    for k, p in enumerate(bound):
        p.spec.node_name = f"n{k // 18:02d}"
    services = [S.service(T, "web", {"app": "web"})]
    pending = (S.template_pods(T, 2, 6, labels={"app": "web"})
               + S.port_pods(T, 5)
               + S.pause_pods(T, 3, prefix="ssd",
                              requests={"cpu": "250m", "memory": "1Gi"})
               + S.pause_pods(T, 3, prefix="lone",
                              requests={"cpu": "300m"}))
    for p in pending:
        if p.metadata.name.startswith("ssd"):
            p.spec.node_selector = {"disktype": "ssd"}
    groups = [S.pod_group(T, "train", 4, priority=2),
              S.pod_group(T, "big", 1, priority=10)]
    pending += (S.gang_members(T, "train", 4, cpu="200m")
                + S.gang_members(T, "big", 1, cpu="2"))
    for i, p in enumerate(pending):
        s = (i * 7919) % 3600
        p.metadata.creation_timestamp = (
            f"2026-01-02T00:{s // 60:02d}:{s % 60:02d}Z")
    return nodes, bound, services, groups, pending


PACKAGES = {
    "port": (TT, APIServer, lambda s: RESTClient(LocalTransport(s)),
             PServer, PCore,
             lambda: PServer.SchedulerServerOptions(
                 algorithm_provider="CUDAProvider", device="cpu"),
             PFactory),
    "jax": (JT, JaxAPIServer, lambda s: JaxClient(JaxLocal(s)), JServer,
            JCore,
            lambda: JServer.SchedulerServerOptions(
                algorithm_provider="TPUProvider"),
            JFactory),
}


def wire_run(name, monkeypatch, timeout=60.0) -> dict:
    """The wire cluster through package `name`'s apiserver and daemon ->
    {"binds": {pod: node}, "statuses": {group: status}, "victims": the
    pods evicted, "waves": [[(pod, node), ...], ...] in the order the
    loop bound them}."""
    T, API, client_of, srv_mod, core, options, factory = PACKAGES[name]
    nodes, bound, services, groups, pending = wire_cluster(T)
    server = API()
    client = client_of(server)
    waves = []
    orig = core.Scheduler._assume_and_bind_wave

    def recorded(self, pairs, cycle_start):
        waves.append([(p.metadata.name, h) for p, h in pairs])
        return orig(self, pairs, cycle_start)

    monkeypatch.setattr(core.Scheduler, "_assume_and_bind_wave", recorded)
    evict = factory.ConfigFactory._preempt_many

    def evict_observed(self, victims):
        """The daemon's preemptor, then a wait until its scheduler cache
        holds none of the victims. It steps round an open fault of both
        daemons (ROADMAP.md queue 3, witness
        tests/witness_gang_status_races.py): the preempting gang comes
        back to the FIFO right after its wave, and were some evictions
        not yet observed, it would preempt again for what the cache still
        shows, a number of victims that depends on the threads'
        timing."""
        out = evict(self, victims)
        assert wait_until(lambda: not any(
            self.scheduler_cache.has_pod(v) for v in victims), timeout)
        return out

    monkeypatch.setattr(factory.ConfigFactory, "_preempt_many",
                        evict_observed)
    write = factory.ConfigFactory._update_podgroup_status

    def write_observed(self, namespace, pg_name, status):
        """The daemon's PodGroup status writer, then a wait until its
        PodGroup informer holds what it wrote. It steps round an open
        fault of both daemons (ROADMAP.md queue 3, witness
        tests/witness_gang_status_races.py): a gang parked again adds its
        new victims to the preempted count the informer shows, so a
        stale informer loses the earlier count, by the threads'
        timing."""
        write(self, namespace, pg_name, status)
        want = self.client.resource("podgroups", namespace).get(
            pg_name).metadata.resource_version
        assert wait_until(lambda: any(
            g.metadata.name == pg_name
            and g.metadata.resource_version == want
            for g in self.podgroup_informer.store.list()), timeout)

    monkeypatch.setattr(factory.ConfigFactory, "_update_podgroup_status",
                        write_observed)
    for n in nodes:
        client.nodes().create(n)
    for s in services:
        client.resource("services", "default").create(s)
    for g in groups:
        client.resource("podgroups", "default").create(g)
    for p in bound + pending:
        client.pods().create(p)
    srv = srv_mod.SchedulerServer(client, options()).start()
    pgs = client.resource("podgroups", "default")
    try:
        # the priority gang binds once its victims are gone
        assert wait_until(lambda: pgs.get("big").status.phase
                          == "Scheduled", timeout), f"{name}: big parked"
        assert wait_until(lambda: all(
            p.spec.node_name for p in client.pods().list()[0]), timeout)
        # the director writes PodGroup statuses after the binds: read
        # them only once none has changed for a while
        assert wait_settled(lambda: sorted(
            (g.metadata.name, g.metadata.resource_version)
            for g in pgs.list()[0]), timeout), f"{name}: statuses moving"
    finally:
        srv.stop()
        server.close_cachers()
    pods = client.pods().list()[0]
    statuses = {g.metadata.name: (g.status.phase, g.status.scheduled,
                                  g.status.members, g.status.message,
                                  g.status.preempted)
                for g in pgs.list()[0]}
    live = {p.metadata.name for p in pods}
    return {"binds": {p.metadata.name: p.spec.node_name for p in pods},
            "statuses": statuses,
            "victims": sorted(p.metadata.name for p in bound + pending
                              if p.metadata.name not in live),
            "waves": waves}


def oracle_binds(waves, victims):
    """The port's oracle copy on the pods the loop bound, wave by wave in
    the loop's order, each wave on the cluster as the waves before it
    left it: the director evicts the victims in the first wave's
    after_wave, so they are gone from the second on."""
    nodes, bound, services, _groups, pending = wire_cluster(TT)
    by_name = {p.metadata.name: p for p in pending}
    assigned = list(bound)
    oracle = PortOracle()
    out = []
    for wave in waves:
        pods = [by_name[n] for n, _ in wave]
        hosts = oracle.schedule_backlog(
            pods, PortState.build(nodes, assigned, services=services))
        out.append(list(zip([p.metadata.name for p in pods], hosts)))
        for p, h in zip(pods, hosts):
            q = TT.shallow_copy(p)
            q.spec = TT.shallow_copy(p.spec)
            q.spec.node_name = h
            assigned.append(q)
        assigned = [p for p in assigned if p.metadata.name not in victims]
    return out


def in_loop_order(run) -> list:
    """A run's waves as (the hosts in the loop's order, the pods' names
    sorted): what the daemon decided, whatever order identical pods
    that came back through the error handler's backoff threads took."""
    return [([h for _, h in w], sorted(n for n, _ in w))
            for w in run["waves"]]


def test_wire_daemon_binds_what_the_jax_daemon_and_the_oracle_bind(
        monkeypatch):
    port = wire_run("port", monkeypatch)
    jax = wire_run("jax", monkeypatch)
    assert len(port["waves"]) == len(jax["waves"]) == 2
    assert port["waves"][0] == jax["waves"][0]
    assert in_loop_order(port) == in_loop_order(jax)
    first = dict(port["waves"][0])
    assert {n: h for n, h in port["binds"].items() if n in first} == {
        n: h for n, h in jax["binds"].items() if n in first}
    assert sorted(port["binds"].items()) != [] and sorted(
        port["binds"].values()) == sorted(jax["binds"].values())
    assert port["statuses"] == jax["statuses"]
    assert port["statuses"]["big"][0] == "Scheduled"
    assert port["victims"] == jax["victims"] and port["victims"]
    oracle = oracle_binds(port["waves"], set(port["victims"]))
    assert [[h for _, h in w] for w in oracle] == [
        [h for _, h in w] for w in port["waves"]]


# -- the provider registry wires the daemon ----------------------------------


class _Lister:
    def __init__(self, items):
        self.items = list(items)

    def list(self):
        return list(self.items)


def provider_algorithm(name, T, C, plugins, device_kw):
    """The device provider's algorithm through package `name`'s registry,
    with a scheduler cache and listers in the factory arguments, as the
    daemon's ConfigFactory.plugin_args gives them."""
    cache = C.SchedulerCache()
    svc = _Lister([S.service(T, "web", {"app": "web"})])
    args = plugins.PluginFactoryArgs(
        scheduler_cache=cache, service_lister=svc,
        controller_lister=_Lister([]), replica_set_lister=_Lister([]))
    provider = plugins.get_algorithm_provider(name)
    return provider.algorithm_factory(args, **device_kw), cache


def test_provider_registry_wires_the_scheduler_cache(monkeypatch):
    """_tpu_algorithm_factory with a cache in its arguments: the port's
    algorithm subscribes its IncrementalEncoder to the cache and takes
    every wave from wave_view; its decisions equal the JAX provider's on
    the same cache events. With default arguments it encodes every wave
    from scratch, as before."""
    port, pcache = provider_algorithm("CUDAProvider", TT, PC, TPlug,
                                      {"device": "cpu"})
    jax, jcache = provider_algorithm("TPUProvider", JT, JC, JPlug, {})
    assert isinstance(port, TorchScheduleAlgorithm)
    assert port._inc is not None and port._inc.on_cache_event in (
        pcache._listeners)
    assert jax._inc is not None
    views = []
    orig = IncrementalEncoder.wave_view

    def counted(self, *a, **kw):
        out = orig(self, *a, **kw)
        views.append(out[0] is not None)
        return out

    monkeypatch.setattr(IncrementalEncoder, "wave_view", counted)
    picks = {}
    for name, T, cache, algo in (("port", TT, pcache, port),
                                 ("jax", JT, jcache, jax)):
        nodes = S.zoned_density_nodes(T, 9)
        for n in nodes:
            cache.add_node(n)
        got = []
        for k in range(3):
            pods = (S.template_pods(T, 2, 5, labels={"app": "web"},
                                    name0=f"w{k}")
                    + S.pause_pods(T, 2, prefix=f"lone{k}",
                                   requests={"cpu": "300m"}))
            hosts = algo.schedule_backlog(pods, cache.snapshot())
            for p, h in zip(pods, hosts):
                q = T.shallow_copy(p)
                q.spec = T.shallow_copy(p.spec)
                q.spec.node_name = h
                cache.add_pod(q)
            got.append(hosts)
            if k == 0:
                cache.remove_node(nodes[4])
        picks[name] = got
    assert picks["port"] == picks["jax"]
    assert views == [True] * 3
    assert TProv._tpu_algorithm_factory(
        TPlug.PluginFactoryArgs(), device="cpu")._inc is None


# -- the port's daemon on the JAX apiserver's wire ---------------------------


def test_port_daemon_on_the_jax_apiservers_binary_wire():
    """The port's client stack (HTTPTransport over the TLV binary wire)
    and daemon against the JAX package's apiserver: the copies speak the
    same wire, and the binds equal the port's oracle copy."""
    server = JaxAPIServer()
    host, port = server.serve_http(port=0, enable_binary=True)
    client = RESTClient(HTTPTransport(f"http://{host}:{port}", binary=True,
                                      timeout=30.0))
    try:
        nodes = S.zoned_density_nodes(TT, 6)
        client.nodes().create_many(nodes)
        srv = PServer.SchedulerServer(client, PServer.SchedulerServerOptions(
            algorithm_provider="CUDAProvider", device="cpu")).start()
        try:
            assert wait_until(lambda: srv.ready.is_set(), 30)
            pods = S.template_pods(TT, 3, 8)
            for p in pods:
                client.pods().create(p)
            jax_client = JaxClient(JaxLocal(server))
            assert wait_until(lambda: all(
                p.spec.node_name for p in jax_client.pods().list()[0]), 30)
        finally:
            srv.stop()
        binds = {p.metadata.name: p.spec.node_name
                 for p in jax_client.pods().list()[0]}
        want = PortOracle().schedule_backlog(pods, PortState.build(nodes))
        assert [binds[p.metadata.name] for p in pods] == want
    finally:
        server.shutdown_http()
