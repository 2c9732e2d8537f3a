"""The port's scheduling core on the CPU: the scheduler cache's state
machine, the assume races of the scheduling loop (the counterparts of
tests/test_scheduler_shell.py TestSchedulerCache and TestAssumeRaces),
core.Scheduler over a pre-queued backlog against the JAX package's
(waves, gangs and preemption included), the wave driver's resident
device tables, daemon-mode warmup, and the outbound extender chain
(ExtendedGenericScheduler, factory.create_from_config with extenders).
Decisions are compared exactly."""

import dataclasses
import http.server
import json
import threading

import numpy as np
import pytest
import torch

import kubernetes_tpu.api.types as JT
# the provider registrations resolve_policy looks the keys up in
import kubernetes_tpu.scheduler.algorithmprovider  # noqa: F401
from kubernetes_tpu.models.wave import WaveScheduler as JaxWave
from kubernetes_tpu.oracle import ClusterState as JaxState
from kubernetes_tpu.scheduler import cache as JC
from kubernetes_tpu.scheduler import core as JCore
from kubernetes_tpu.scheduler import extender as JExt
from kubernetes_tpu.scheduler import gang as JG
from kubernetes_tpu.scheduler import plugins as JPlug
from kubernetes_tpu.scheduler import policy as JPol
from kubernetes_tpu.scheduler.tpu_algorithm import TPUScheduleAlgorithm
from kubernetes_tpu.snapshot.encode import SnapshotEncoder as JaxEncoder

import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.models.wave import WaveScheduler
from kubernetes_tpu_torch.native import build as B
from kubernetes_tpu_torch.oracle import ClusterState as PortState
from kubernetes_tpu_torch.oracle import GenericScheduler as PortOracle
from kubernetes_tpu_torch.scheduler import cache as PC
from kubernetes_tpu_torch.scheduler import core as PCore
from kubernetes_tpu_torch.scheduler import extender as PExt
from kubernetes_tpu_torch.scheduler import factory as TF
from kubernetes_tpu_torch.scheduler import gang as PG
from kubernetes_tpu_torch.scheduler import plugins as TPlug
from kubernetes_tpu_torch.scheduler import policy as TPol
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm
from kubernetes_tpu_torch.scheduler.cache import CacheError, SchedulerCache
from kubernetes_tpu_torch.snapshot.encode import SnapshotEncoder
from kubernetes_tpu_torch.utils.clock import FakeClock

from tests.test_torch_wave import dispatch_shape


@pytest.fixture(autouse=True)
def jax_latency_histograms_kept():
    """The JAX package's scheduler latency histograms are process-wide,
    and tests/test_slo.py gates on the algorithm latency's median: the
    JAX core's waves below, first compiles included, leave them as they
    found them for whatever test runs next in this process."""
    from kubernetes_tpu import metrics as JM

    hists = (JM.scheduler_algorithm_latency, JM.scheduler_binding_latency,
             JM.scheduler_e2e_latency)
    saved = [(list(h._counts), h._sum, h._count) for h in hists]
    yield
    for h, (counts, total, n) in zip(hists, saved):
        with h._lock:
            h._counts, h._sum, h._count = counts, total, n


def pod(name, ns="default", node="", cpu="100m", mem="500Mi"):
    return TT.Pod(
        metadata=TT.ObjectMeta(name=name, namespace=ns),
        spec=TT.PodSpec(node_name=node, containers=[
            TT.Container(name="c", requests={"cpu": cpu, "memory": mem})]))


def node(name, cpu="4", mem="32Gi", pods="110"):
    return TT.Node(
        metadata=TT.ObjectMeta(name=name,
                               labels={"kubernetes.io/hostname": name}),
        status=TT.NodeStatus(
            allocatable={"cpu": cpu, "memory": mem, "pods": pods},
            conditions=[TT.NodeCondition("Ready", "True")]))


class TestSchedulerCache:
    def test_assume_confirm_update_remove(self):
        cache = SchedulerCache(ttl=30)
        cache.add_node(node("n1"))
        p = pod("p1", node="n1")
        cache.assume_pod(p, now=0)
        assert cache.is_assumed_pod(p)
        assert cache.snapshot().node_infos["n1"].requested_milli_cpu == 100
        cache.add_pod(p)  # watch confirm
        assert not cache.is_assumed_pod(p)
        assert cache.snapshot().node_infos["n1"].requested_milli_cpu == 100
        p2 = pod("p1", node="n1", cpu="200m")
        cache.update_pod(p, p2)
        assert cache.snapshot().node_infos["n1"].requested_milli_cpu == 200
        cache.remove_pod(p2)
        assert cache.snapshot().node_infos["n1"].requested_milli_cpu == 0

    def test_assume_expires(self):
        cache = SchedulerCache(ttl=30, clock=FakeClock(start=100.0))
        cache.add_node(node("n1"))
        p = pod("p1", node="n1")
        cache.assume_pod(p, now=100.0)
        cache.cleanup_expired(now=120.0)
        assert cache.is_assumed_pod(p)
        cache.cleanup_expired(now=131.0)
        assert not cache.is_assumed_pod(p)
        assert cache.snapshot().node_infos["n1"].requested_milli_cpu == 0

    def test_forget_undoes_assume(self):
        cache = SchedulerCache()
        cache.add_node(node("n1"))
        p = pod("p1", node="n1")
        cache.assume_pod(p)
        cache.forget_pod(p)
        assert cache.snapshot().node_infos["n1"].requested_milli_cpu == 0
        with pytest.raises(CacheError):
            cache.forget_pod(p)

    def test_double_assume_rejected(self):
        cache = SchedulerCache()
        p = pod("p1", node="n1")
        cache.assume_pod(p)
        with pytest.raises(CacheError):
            cache.assume_pod(p)

    def test_remove_node_keeps_pod_aggregates(self):
        cache = SchedulerCache()
        cache.add_node(node("n1"))
        p = pod("p1", node="n1")
        cache.add_pod(p)
        cache.remove_node(node("n1"))
        snap = cache.snapshot()
        assert snap.node_infos["n1"].node is None
        assert snap.node_infos["n1"].requested_milli_cpu == 100
        cache.remove_pod(p)
        assert "n1" not in cache.snapshot().node_infos

    def test_listener_replays_then_follows(self):
        """add_listener replays the cache's contents, then every
        transition arrives as pod_add / pod_remove / node_set /
        node_remove."""
        cache = SchedulerCache()
        cache.add_node(node("n1"))
        cache.add_pod(pod("p0", node="n1"))
        seen = []
        cache.add_listener(lambda kind, obj: seen.append(
            (kind, obj.metadata.name)))
        p = pod("p1", node="n1")
        cache.assume_pod(p)
        cache.add_pod(p)  # confirm in place: no event
        cache.remove_pod(p)
        cache.remove_node(node("n1"))
        assert seen == [("node_set", "n1"), ("pod_add", "p0"),
                        ("pod_add", "p1"), ("pod_remove", "p1"),
                        ("node_remove", "n1")]


class TestAssumeRaces:
    """Duplicate watch deliveries never double-commit or bind twice."""

    def _core(self, cache, queue, binds, errors):
        class Algo:
            def schedule(self, p, state):
                return "n1"

        cfg = PCore.SchedulerConfig(
            scheduler_cache=cache, algorithm=Algo(),
            binder=lambda p, host: binds.append((p.metadata.name, host)),
            next_pod=lambda: queue.pop(0) if queue else None,
            error=lambda p, err: errors.append((p.metadata.name, err)))
        return PCore.Scheduler(cfg)

    def test_duplicate_delivery_dropped_from_wave(self):
        cache = SchedulerCache(ttl=30)
        cache.add_node(node("n1"))
        p = pod("p1")
        binds, errors = [], []
        sched = self._core(cache, [p], binds, errors)
        sched.schedule_one()
        sched._bind_pool.shutdown(wait=True)
        assert binds == [("p1", "n1")]
        assert cache.has_pod(p)
        sched2 = self._core(cache, [p], binds, errors)
        sched2.schedule_one()
        sched2._bind_pool.shutdown(wait=True)
        assert binds == [("p1", "n1")]
        assert errors == []

    def test_assume_failure_requeues_and_skips_bind(self):
        cache = SchedulerCache(ttl=30)
        cache.add_node(node("n1"))
        p = pod("p1")
        binds, errors = [], []
        sched = self._core(cache, [p], binds, errors)
        orig_keys = cache.pod_keys
        cache.pod_keys = lambda: set()
        cache.assume_pod(p)
        sched.schedule_one()
        sched._bind_pool.shutdown(wait=True)
        cache.pod_keys = orig_keys
        assert binds == []
        assert [n for n, _ in errors] == ["p1"]

    def test_assume_failure_mid_wave_binds_the_rest(self):
        cache = SchedulerCache(ttl=30)
        cache.add_node(node("n1"))
        p1, p2 = pod("p1"), pod("p2")
        binds, errors = [], []
        sched = self._core(cache, [p1], binds, errors)
        cache.assume_pod(p1)
        sched._assume_and_bind_wave([(p1, "n1"), (p2, "n1")], 0.0)
        sched._bind_pool.shutdown(wait=True)
        assert binds == [("p2", "n1")]
        assert [n for n, _ in errors] == ["p1"]

    def test_algorithm_failure_reports_surviving_pod(self):
        cache = SchedulerCache(ttl=30)
        cache.add_node(node("n1"))
        p1, p2 = pod("p1"), pod("p2")
        cache.assume_pod(p1)
        errors = []

        class Boom:
            def schedule(self, p, state):
                raise RuntimeError("algorithm down")

            def schedule_backlog(self, pods_, state):
                raise RuntimeError("algorithm down")

        cfg = PCore.SchedulerConfig(
            scheduler_cache=cache, algorithm=Boom(),
            binder=lambda p, host: None, next_pod=lambda: p1,
            drain_waiting=lambda n: [p2],
            error=lambda p, err: errors.append(p.metadata.name))
        PCore.Scheduler(cfg).schedule_one()
        assert errors == ["p2"]


# -- core.Scheduler over a backlog, the port against the JAX package ---------

PACKAGES = {
    "port": (TT, PC, PCore, PG,
             lambda **kw: TorchScheduleAlgorithm(device="cpu", **kw),
             {"device": "cpu"}),
    "jax": (JT, JC, JCore, JG, lambda **kw: TPUScheduleAlgorithm(**kw), {}),
}


def mixed_backlog(T):
    """Template runs, short runs and singletons with host ports and
    selectors on a small cluster of two node shapes."""
    nodes = (S.density_nodes(T, 12)
             + S.density_nodes(T, 4, cpu="2", mem="8Gi", pods_cap="20"))
    for i, n in enumerate(nodes):
        n.metadata.name = f"n{i:02d}"
        n.metadata.labels = {"disktype": "ssd" if i % 3 else "hdd"}
    pods = (S.template_pods(T, 3, 12, labels={"app": "web"})
            + S.port_pods(T, 6)
            + S.pause_pods(T, 9, prefix="lone", requests={"cpu": "300m"})
            + S.template_pods(T, 2, 20, labels={"app": "db"}, cpu0=200))
    for i, p in enumerate(pods):
        if i % 7 == 3:
            p.spec.node_selector = {"disktype": "ssd"}
        p.metadata.name = f"{p.metadata.name}-{i}"
    return nodes, pods


def run_core(name, build, algo_kw=None, **flow_kw):
    """build(T) -> (nodes, bound pods, backlog, pod groups or None):
    scenarios.daemon_flow in package `name`, tallying each cycle's
    dispatches. -> (the flow's outcome with the tallies, the
    algorithm)."""
    T, C, core, G, make, kw = PACKAGES[name]
    nodes, bound, backlog, groups = build(T)
    algos, tallies = [], []

    def algorithm(cache):
        algos.append(make(cache=cache, **(algo_kw or {})))
        return algos[0]

    out = S.daemon_flow(
        C, core, G, algorithm, nodes, bound, backlog, groups=groups,
        director_kw=kw, wave_floor=0, on_wave=lambda: tallies.append(
            dispatch_shape(algos[0]._wave.dispatches)), **flow_kw)
    return dict(out, tallies=tallies), algos[0]


@pytest.mark.parametrize("max_batch", [16, 37, 4096])
def test_core_binds_what_jax_binds_and_the_oracle_chooses(max_batch):
    def build(T):
        nodes, pods = mixed_backlog(T)
        return nodes, [], pods, None

    port, algo = run_core("port", build, {"min_run": 4},
                          max_batch=max_batch)
    jax, _ = run_core("jax", build, {"min_run": 4}, max_batch=max_batch)
    assert port == jax
    nodes, _bound, pods, _groups = build(TT)
    want = PortOracle().schedule_backlog(pods, PortState.build(nodes))
    assert [port["binds"].get(p.metadata.name) for p in pods] == want
    assert port["cycles"] == -(-len(pods) // max_batch)
    # every wave took the incremental view
    assert algo._wave._dev_source == algo._inc.source_token
    assert algo._wave.stats["waves"] == port["cycles"]


def gang_build(T):
    """A small gang scenario: bound priority-0 pods filling most of each
    node, singletons, three gangs that fit, one short of its minMember,
    and a priority-10 gang that fits only after preemption."""
    nodes, bound = S.bound_cluster(T, 8, per_node=24)
    wave, groups = S.gang_wave(T, singles=10, gangs=3, members=4, big=4,
                               short=2)
    return nodes, bound, wave, groups


def test_core_gang_waves_match_jax():
    """The director wired into the scheduling loop: the parked big gang
    preempts, is queued again and binds whole, as in the JAX package."""
    port, _ = run_core("port", gang_build, retries=2)
    jax, _ = run_core("jax", gang_build, retries=2)
    assert port == jax
    assert port["victims"]
    assert all(port["binds"].get(f"big-{i:06d}") for i in range(4))
    assert not any(n.startswith("short-") for n in port["binds"])
    assert any("minMember" in e for n, e in port["errors"]
               if n.startswith("short-"))


# -- the wave driver's resident device tables ---------------------------------


def port_wave(T_nodes, pods, wave=None, snap=None, **kw):
    """-> (names, the wave driver's dispatch tally, the wave driver, the
    encoded snapshot) of one wave on the port's WaveScheduler (a new one
    unless given)."""
    state = PortState.build(T_nodes)
    enc = SnapshotEncoder(state, pods)
    if snap is None:
        snap = enc.encode_nodes()
    batch = enc.encode_pods()
    wave = wave or WaveScheduler(device="cpu", min_run=4)
    chosen, _carry, _last = wave.schedule_backlog(
        snap, batch, np.arange(len(pods)), **kw)
    return ([snap.node_names[i] if i >= 0 else None for i in chosen],
            dict(wave.dispatches), wave, snap)


def ported_pods():
    """Host-port and labelled pods: a wave that reached the next through
    an aliased carry would find every port taken."""
    return (S.port_pods(TT, 6)
            + S.template_pods(TT, 1, 10, labels={"app": "web"}))


def test_resident_tables_quiet_wave_reuses_every_table():
    nodes = S.density_nodes(TT, 6)
    pods = ported_pods()
    cold, cold_tally, wave, snap = port_wave(nodes, pods)
    fields = len(wave.scan.STATIC_FIELDS) + len(wave._CARRY_FIELDS)
    assert wave.stats["table_ships"] == fields
    again, tally, wave, _ = port_wave(nodes, pods, wave=wave, snap=snap)
    assert (again, tally) == (cold, cold_tally)
    assert wave.stats["table_ships"] == fields
    assert wave.stats["table_reuses"] == fields
    assert wave.stats["table_scatters"] == 0
    assert wave.stats["wave_table_bytes"] == 0


def test_resident_tables_changed_node_scatters_its_row():
    nodes = S.density_nodes(TT, 80)
    pods = ported_pods()
    _names, _tally, wave, snap = port_wave(nodes, pods)
    alloc = snap.alloc_mcpu.copy()
    alloc[3] = 500
    changed = dataclasses.replace(snap, alloc_mcpu=alloc)
    got, tally, wave, _ = port_wave(nodes, pods, wave=wave, snap=changed)
    want, want_tally, _w, _s = port_wave(nodes, pods, snap=changed)
    assert got == want
    assert tally == dict(want_tally, table_scatter=1)
    assert wave.stats["table_scatters"] == 1
    _shape, _dtype, dev, mirror = wave._dev["alloc_mcpu"]
    assert dev.tolist() == changed.alloc_mcpu.tolist()
    assert mirror[3] == 500


def test_resident_tables_new_source_clears_the_cache():
    nodes = S.density_nodes(TT, 6)
    pods = ported_pods()
    cold, _tally, wave, snap = port_wave(nodes, pods)
    fields = len(wave.scan.STATIC_FIELDS) + len(wave._CARRY_FIELDS)
    # a `keep` names tables the producer vouches for: reused unchecked
    got, _t, wave, _ = port_wave(nodes, pods, wave=wave, snap=snap,
                                 keep=frozenset({"alloc_mcpu"}))
    assert got == cold and wave.stats["table_reuses"] == fields
    got, _t, wave, _ = port_wave(nodes, pods, wave=wave, snap=snap,
                                 source="other")
    assert got == cold
    assert wave.stats["table_ships"] == 2 * fields
    assert wave._dev_source == "other"


def test_resident_table_counts_match_the_jax_driver():
    """The same three waves (cold, quiet, one changed row) on both
    drivers: equal decisions, tallies and ship/reuse/scatter counts."""
    out = {}
    for name, (T, CS, Drv, Enc, kw) in {
            "port": (TT, PortState, WaveScheduler, SnapshotEncoder,
                     {"device": "cpu"}),
            "jax": (JT, JaxState, JaxWave, JaxEncoder, {})}.items():
        nodes = S.density_nodes(T, 80)
        pods = S.port_pods(T, 6) + S.template_pods(
            T, 1, 10, labels={"app": "web"})
        e = Enc(CS.build(nodes), pods)
        snap, batch = e.encode_nodes(), e.encode_pods()
        drv = Drv(min_run=4, **kw)
        rows = []
        for step in range(3):
            if step == 2:
                snap.alloc_mcpu = snap.alloc_mcpu.copy()
                snap.alloc_mcpu[5] = 700
            chosen, _c, _l = drv.schedule_backlog(snap, batch,
                                                  np.arange(len(pods)))
            rows.append((np.asarray(chosen).tolist(),
                         dispatch_shape(drv.dispatches),
                         {k: drv.stats[k] for k in (
                             "waves", "table_ships", "table_reuses",
                             "table_scatters")}))
        out[name] = rows
    assert out["port"] == out["jax"]


# -- warmup --------------------------------------------------------------------


def test_warmup_leaves_the_daemon_state_as_it_was():
    cache = SchedulerCache()
    algo = TorchScheduleAlgorithm(device="cpu", cache=cache)
    inc = algo._inc
    algo.warmup(6)
    assert algo._inc is inc and algo._last_node_index == 0
    nodes = S.density_nodes(TT, 6)
    for n in nodes:
        cache.add_node(n)
    pods = S.pause_pods(TT, 20)
    got = algo.schedule_backlog(pods, PortState.build(nodes))
    assert got == PortOracle().schedule_backlog(pods,
                                                PortState.build(nodes))
    assert algo._wave._dev_source == inc.source_token


def test_warmup_raises_when_a_kernel_build_fails(monkeypatch):
    """On the card warmup builds K1 and K3 first; a failed nvcc build
    stops it (the JAX warmup logs and swallows its failures)."""
    def no_nvcc(stem):
        raise RuntimeError(f"nvcc failed on {stem}")

    from kubernetes_tpu_torch.ops import probe_kernel

    monkeypatch.setattr(B, "build_cuda", no_nvcc)
    monkeypatch.setattr(probe_kernel, "_LIB", None)
    algo = TorchScheduleAlgorithm(device="cpu", cache=SchedulerCache())
    algo.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="nvcc failed on probe_kernel"):
        algo.warmup(4)


def test_warmup_raises_where_the_jax_warmup_swallows(monkeypatch):
    """A failure inside the warm waves (a kernel launch, on the card)
    propagates from the port's warmup; the JAX package's logs it."""
    def launch_failed(*a, **kw):
        raise RuntimeError("resource_probe kernel launch failed")

    port = TorchScheduleAlgorithm(device="cpu", cache=SchedulerCache())
    jax = TPUScheduleAlgorithm(cache=JC.SchedulerCache())
    monkeypatch.setattr(port._wave, "schedule_backlog", launch_failed)
    monkeypatch.setattr(jax._wave, "schedule_backlog", launch_failed)
    jax.warmup(4, phase="scan")
    with pytest.raises(RuntimeError, match="launch failed"):
        port.warmup(4, phase="scan")
    assert port._last_node_index == 0


# -- the outbound extender chain ------------------------------------------------


@pytest.fixture
def extender():
    """A local HTTP extender: filter rejects n0, prioritize scores n2 100
    and n3 40, everything else 0; it counts its calls."""
    calls = {"filter": 0, "prioritize": 0}

    class Ext(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            items = body["nodes"]["items"]
            if self.path.endswith("/filter"):
                calls["filter"] += 1
                resp = {"nodes": {"kind": "NodeList", "items": [
                    n for n in items if n["metadata"]["name"] != "n0"]},
                    "failedNodes": {"n0": "extender says no"}}
            else:
                calls["prioritize"] += 1
                score = {"n2": 100, "n3": 40}
                resp = [{"host": n["metadata"]["name"],
                         "score": score.get(n["metadata"]["name"], 0)}
                        for n in items]
            data = json.dumps(resp).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Ext)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_port}/api", calls
    finally:
        httpd.shutdown()
        thread.join(timeout=10)
        assert not thread.is_alive()


def extender_policy(url):
    return {"kind": "Policy",
            "predicates": [{"name": "GeneralPredicates"}],
            "priorities": [{"name": "LeastRequestedPriority", "weight": 1}],
            "extenders": [{"urlPrefix": url, "apiVersion": "v1beta1",
                           "filterVerb": "filter",
                           "prioritizeVerb": "prioritize", "weight": 1}]}


def extender_cluster(T, CS):
    nodes = S.density_nodes(T, 5)
    for i, n in enumerate(nodes):
        n.metadata.name = f"n{i}"
    return CS.build(nodes), S.pause_pods(T, 12)


def test_extended_scheduler_matches_jax(extender):
    url, calls = extender
    out = {}
    for name, (T, CS, Core, Ext, Pol, Plug) in {
            "port": (TT, PortState, PCore, PExt, TPol, TPlug),
            "jax": (JT, JaxState, JCore, JExt, JPol, JPlug)}.items():
        policy = Pol.load_policy(json.dumps(extender_policy(url)))
        preds, prios = Pol.resolve_policy(policy, Plug.PluginFactoryArgs())
        sched = Core.ExtendedGenericScheduler(
            list(preds.items()), prios,
            [Ext.HTTPExtender(e) for e in policy.extenders])
        state, pods = extender_cluster(T, CS)
        out[name] = sched.schedule_backlog(pods, state)
    assert out["port"] == out["jax"]
    assert "n0" not in out["port"] and out["port"][0] == "n2"
    assert calls["filter"] == calls["prioritize"] == 24


def test_create_from_config_with_extenders(extender):
    """The factory's Policy path: a Policy with extenders resolves to the
    host ExtendedGenericScheduler with one HTTPExtender per entry, whose
    decisions equal the JAX package's (test above) chain."""
    url, calls = extender
    policy = TPol.load_policy(json.dumps(extender_policy(url)))
    algo = TF.create_from_config(policy, device="cpu")
    assert type(algo) is PCore.ExtendedGenericScheduler
    assert [e.config.url_prefix for e in algo.extenders] == [url]
    state, pods = extender_cluster(TT, PortState)
    got = algo.schedule_backlog(pods, state)
    jpolicy = JPol.load_policy(json.dumps(extender_policy(url)))
    preds, prios = JPol.resolve_policy(jpolicy, JPlug.PluginFactoryArgs())
    jstate, jpods = extender_cluster(JT, JaxState)
    want = JCore.ExtendedGenericScheduler(
        list(preds.items()), prios,
        [JExt.HTTPExtender(e) for e in jpolicy.extenders]
    ).schedule_backlog(jpods, jstate)
    assert got == want
    assert calls["filter"] == 24
