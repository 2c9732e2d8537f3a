"""The port's daemon snapshot path (scheduler/cache.py ->
snapshot/incremental.py -> TorchScheduleAlgorithm(cache=...)) against the
JAX package's, on the CPU; the counterpart of tests/test_incremental.py.

Randomized node and pod event streams (numpy, seeded) go into both
packages' SchedulerCache, each with its IncrementalEncoder subscribed:
  * the port's wave_view equals the JAX package's field for field, and
    its snapshot after the deltas decodes, node by node, to what the
    port's from-scratch SnapshotEncoder derives from the same cache;
  * over several waves, with the decisions assumed into the caches
    between them, the port's daemon-mode algorithm chooses what the JAX
    package's and the serial oracle choose, with the same dispatch tally
    and the same resident-table counts;
  * the scope gates send a wave to the full encode in both packages.
Exact equality throughout."""

import dataclasses

import numpy as np
import pytest

import kubernetes_tpu.api.types as JT
from kubernetes_tpu.scheduler import cache as JC
from kubernetes_tpu.scheduler.tpu_algorithm import TPUScheduleAlgorithm
from kubernetes_tpu.snapshot.incremental import (
    IncrementalEncoder as JaxIncremental,
)

from kubernetes_tpu_torch.oracle import ClusterState as PortState
from kubernetes_tpu_torch.oracle import GenericScheduler as PortOracle
from kubernetes_tpu_torch.scheduler import cache as PC
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm
from kubernetes_tpu_torch.scheduler.factory import node_schedulable
from kubernetes_tpu_torch.snapshot.encode import SnapshotEncoder
from kubernetes_tpu_torch.snapshot.incremental import IncrementalEncoder

from tests.test_torch_ops import to_port
from tests.test_torch_wave import dispatch_shape

ZONE = "failure-domain.beta.kubernetes.io/zone"


class Lister:
    def __init__(self, items=()):
        self.items = list(items)

    def list(self):
        return list(self.items)


def pick(rng, seq):
    return seq[int(rng.integers(len(seq)))]


def rand_node(rng, name):
    labels = {"kubernetes.io/hostname": name}
    if rng.random() < 0.4:
        labels[ZONE] = pick(rng, ["a", "b"])
    if rng.random() < 0.5:
        labels["disktype"] = pick(rng, ["ssd", "hdd"])
    taints = None
    if rng.random() < 0.25:
        taints = [JT.Taint(key="dedicated", value=pick(rng, ["a", "b"]),
                           effect=pick(rng, ["NoSchedule",
                                             "PreferNoSchedule"]))]
    conds = [JT.NodeCondition("Ready", pick(rng, ["True"] * 3 + ["False"]))]
    if rng.random() < 0.2:
        conds.append(JT.NodeCondition("MemoryPressure", "True"))
    return JT.Node(
        metadata=JT.ObjectMeta(name=name, labels=labels),
        spec=JT.NodeSpec(taints=taints),
        status=JT.NodeStatus(
            allocatable={
                "cpu": f"{pick(rng, [1000, 2000, 4000])}m",
                "memory": str(pick(rng, [2, 4, 8]) * 1024**3),
                "pods": str(pick(rng, [5, 20, 110])),
            },
            conditions=conds))


def rand_assigned(rng, i, node_name):
    reqs = {}
    if rng.random() < 0.8:
        reqs["cpu"] = f"{pick(rng, [0, 100, 300])}m"
    if rng.random() < 0.8:
        reqs["memory"] = str(pick(rng, [0, 256, 512]) * 1024**2)
    ports = []
    if rng.random() < 0.3:
        ports.append(JT.ContainerPort(host_port=pick(rng, [8080, 9090])))
    return JT.Pod(
        metadata=JT.ObjectMeta(
            name=f"assigned-{i}",
            labels=dict(pick(rng, [{"app": "web"}, {"app": "db"}, {}]))),
        spec=JT.PodSpec(node_name=node_name,
                        containers=[JT.Container(requests=reqs,
                                                 ports=ports)]))


def rand_pending(rng, i):
    kw = {}
    if rng.random() < 0.3:
        kw["node_selector"] = dict(pick(rng, [{"disktype": "ssd"},
                                              {ZONE: "a"}]))
    return JT.Pod(
        metadata=JT.ObjectMeta(
            name=f"pending-{i}",
            labels=dict(pick(rng, [{"app": "web"}, {"app": "db"}]))),
        spec=JT.PodSpec(
            containers=[JT.Container(requests={"cpu": "100m",
                                               "memory": "100Mi"})],
            **kw))


class Cluster:
    """One cluster's event stream applied to both packages' caches; the
    live objects are the JAX package's, converted for the port."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.caches = {"jax": JC.SchedulerCache(), "port": PC.SchedulerCache()}
        self.nodes, self.pods, self.seq = {}, {}, 0

    def apply(self, method, *objs):
        getattr(self.caches["jax"], method)(*objs)
        getattr(self.caches["port"], method)(*map(to_port, objs))

    def events(self, steps):
        """`steps` random mutations: node add, update and removal, bound
        pod add and removal (tests/test_incremental.py drive_events)."""
        rng = self.rng
        for _ in range(steps):
            op = rng.random()
            if op < 0.25 or not self.nodes:
                name = f"node-{int(rng.integers(200)):03d}"
                node = rand_node(rng, name)
                if name in self.nodes:
                    self.apply("update_node", self.nodes[name], node)
                else:
                    self.apply("add_node", node)
                self.nodes[name] = node
            elif op < 0.35:
                name = pick(rng, sorted(self.nodes))
                self.apply("remove_node", self.nodes.pop(name))
            elif op < 0.75:
                self.seq += 1
                pod = rand_assigned(rng, self.seq,
                                    pick(rng, sorted(self.nodes)))
                self.apply("add_pod", pod)
                self.pods[pod.metadata.name] = pod
            elif self.pods:
                name = pick(rng, sorted(self.pods))
                self.apply("remove_pod", self.pods.pop(name))

    def assume(self, pods, hosts):
        """The scheduling loop's assume of a wave's decisions."""
        assumed = []
        for p, h in zip(pods, hosts):
            if h is not None:
                a = JT.shallow_copy(p)
                a.spec = JT.shallow_copy(p.spec)
                a.spec.node_name = h
                assumed.append(a)
        self.apply("assume_pods", assumed)


def restricted_state(cache, services=()):
    """The schedulable nodes of the cache's state (the JAX test's
    restricted_state, through the port's node_schedulable)."""
    state = cache.snapshot(services=list(services))
    sub = PortState(services=list(services))
    sub.node_infos = {n: info for n, info in state.node_infos.items()
                      if info.node is not None and node_schedulable(info.node)}
    sub.full = state
    return sub


def assert_same(a, b, what):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what
    else:
        assert a == b, what


def node_rows(snap, vocabs, names):
    """name -> the node's encoded row decoded through the vocabularies:
    resources, labels, taints, ports, spread classes and flags."""
    inv = {k: {i: v for v, i in getattr(vocabs, k).ids.items()}
           for k in ("kv", "taints", "ports", "classes", "zones")}

    def bits(row, table):
        return {table[i] for i in table
                if int(row[i // 32]) >> (i % 32) & 1}

    out = {}
    for slot, name in enumerate(snap.node_names):
        if name not in names:
            continue
        out[name] = {
            **{f: int(getattr(snap, f)[slot]) for f in (
                "alloc_mcpu", "alloc_mem", "alloc_gpu", "alloc_pods",
                "req_mcpu", "req_mem", "req_gpu", "nz_mcpu", "nz_mem",
                "pod_count")},
            **{f: bool(getattr(snap, f)[slot]) for f in (
                "has_taints", "taint_bad", "mem_pressure")},
            "zone": inv["zones"][int(snap.zone_id[slot])],
            "labels": bits(snap.label_kv[slot], inv["kv"]),
            "ports": bits(snap.port_mask[slot], inv["ports"]),
            "taints": {inv["taints"][i]: int(c) for i, c in
                       enumerate(snap.taint_count[slot]) if c},
            "classes": {inv["classes"][i]: int(c) for i, c in
                        enumerate(snap.class_count[slot]) if c},
        }
    return out


@pytest.mark.parametrize("seed", range(4))
def test_incremental_view_equals_jax_and_scratch(seed):
    cl = Cluster(7000 + seed)
    encs = {"jax": JaxIncremental(), "port": IncrementalEncoder()}
    for k, enc in encs.items():
        cl.caches[k].add_listener(enc.on_cache_event)
    for rnd in range(4):
        cl.events(40)
        pending = rand_pending(cl.rng, rnd)
        jsnap, jbatch, jkeep = encs["jax"].wave_view([pending])
        psnap, pbatch, pkeep = encs["port"].wave_view([to_port(pending)])
        assert psnap is not None and jsnap is not None
        assert pkeep == jkeep
        for f in dataclasses.fields(jsnap):
            assert_same(getattr(psnap, f.name), getattr(jsnap, f.name),
                        f"snapshot {f.name}, round {rnd}")
        for f in dataclasses.fields(jbatch):
            assert_same(getattr(pbatch, f.name), getattr(jbatch, f.name),
                        f"batch {f.name}, round {rnd}")
        # the port's deltas against the port's from-scratch encode of the
        # same cache's schedulable nodes
        cache = cl.caches["port"]
        state = restricted_state(cache)
        scratch = SnapshotEncoder(state, [to_port(pending)])
        ssnap = scratch.encode_nodes()
        names = set(state.node_infos)
        got = node_rows(psnap, encs["port"].vocabs, names)
        want = node_rows(ssnap, scratch.vocabs, names)
        assert got == want, f"round {rnd}"
        # every other slot is free, a gone node holding pods, or an
        # unschedulable node: never fit (zero allocatable)
        full = cache.snapshot()
        for slot, name in enumerate(psnap.node_names):
            if name in names:
                continue
            assert psnap.alloc_pods[slot] == 0 and psnap.alloc_mcpu[slot] == 0
            if name:
                assert name in full.node_infos


@pytest.mark.parametrize("seed", range(3))
def test_daemon_decisions_match_jax_and_oracle(seed):
    cl = Cluster(8000 + seed)
    services = [JT.Service(metadata=JT.ObjectMeta(name="web"),
                           spec=JT.ServiceSpec(selector={"app": "web"}))]
    port_services = to_port(services)
    port = TorchScheduleAlgorithm(
        device="cpu", min_run=1, cache=cl.caches["port"],
        service_lister=Lister(port_services), controller_lister=Lister(),
        replica_set_lister=Lister())
    jax = TPUScheduleAlgorithm(
        min_run=1, cache=cl.caches["jax"], service_lister=Lister(services),
        controller_lister=Lister(), replica_set_lister=Lister())
    oracle = PortOracle()
    pend = 0
    for rnd in range(4):
        cl.events(30)
        pending = []
        for _ in range(int(cl.rng.integers(1, 12))):
            pend += 1
            pending += [rand_pending(cl.rng, pend)] * int(
                cl.rng.integers(1, 5))
        ppending = to_port(pending)
        state = restricted_state(cl.caches["port"], port_services)
        want = oracle.schedule_backlog(ppending, state.clone())
        got = port.schedule_backlog(ppending, state)
        assert got == want, f"seed {seed} round {rnd}"
        assert port._wave._dev_source == port._inc.source_token
        assert jax.schedule_backlog(pending, None) == got
        assert dispatch_shape(port._wave.dispatches) == \
            dispatch_shape(jax._wave.dispatches)
        counts = ("waves", "table_ships", "table_reuses", "table_scatters")
        assert {k: port._wave.stats[k] for k in counts} == \
            {k: jax._wave.stats[k] for k in counts}
        cl.assume(pending, got)


def affinity_pod():
    p = JT.Pod(metadata=JT.ObjectMeta(name="anti", labels={"app": "web"}),
               spec=JT.PodSpec(containers=[JT.Container(
                   requests={"cpu": "100m"})]))
    p.spec.affinity = JT.Affinity(pod_anti_affinity=JT.PodAntiAffinity(
        required_during_scheduling_ignored_during_execution=(
            JT.PodAffinityTerm(
                label_selector=JT.LabelSelector(match_labels={"app": "web"}),
                topology_key="kubernetes.io/hostname"),)))
    return p


def volume_pod():
    p = JT.Pod(metadata=JT.ObjectMeta(name="vol", labels={"app": "db"}),
               spec=JT.PodSpec(containers=[JT.Container(
                   requests={"cpu": "100m"})]))
    p.spec.volumes = [JT.Volume(name="v", gce_persistent_disk=(
        JT.GCEPersistentDisk(pd_name="disk-1")))]
    return p


@pytest.mark.parametrize("gate", ["wave affinity", "cluster affinity",
                                  "wave volumes"])
def test_scope_gates_fall_back_to_the_full_encode(gate):
    """wave_view declines in both packages; both algorithms then encode
    from scratch (source "full") and choose what the oracle chooses."""
    cl = Cluster(9000)
    for i in range(6):
        node = rand_node(cl.rng, f"node-{i:03d}")
        node.status.conditions = [JT.NodeCondition("Ready", "True")]
        cl.apply("add_node", node)
    pending = [rand_pending(cl.rng, i) for i in range(3)]
    if gate == "wave affinity":
        pending.append(affinity_pod())
    elif gate == "wave volumes":
        pending.append(volume_pod())
    else:
        bound = affinity_pod()
        bound.spec.node_name = "node-000"
        cl.apply("add_pod", bound)
    algos = {
        "port": TorchScheduleAlgorithm(device="cpu", min_run=1,
                                       cache=cl.caches["port"]),
        "jax": TPUScheduleAlgorithm(min_run=1, cache=cl.caches["jax"]),
    }
    ppending = to_port(pending)
    for k, algo in algos.items():
        assert algo._inc.wave_view(
            ppending if k == "port" else pending)[0] is None
    state = restricted_state(cl.caches["port"])
    want = PortOracle().schedule_backlog(ppending, state.clone())
    got = algos["port"].schedule_backlog(ppending, state)
    assert got == want
    assert algos["port"]._wave._dev_source == "full"
    jstate = JC.SchedulerCache.snapshot(cl.caches["jax"])
    jstate.node_infos = {n: i for n, i in jstate.node_infos.items()
                         if n in state.node_infos}
    assert algos["jax"].schedule_backlog(pending, jstate) == got
