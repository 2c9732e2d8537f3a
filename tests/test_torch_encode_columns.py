"""The port's node encode, built column by column, against the JAX
package's node-by-node encode: every ClusterSnapshot field (value, dtype
and shape), the vocabularies' ids, and the VolumeCompiler program, over
seeded clusters that reach each branch of the node pass. And the port's
pod encode, whose spread selectors go through an index of the classes'
label pairs, against the JAX package's: every PodBatch field, over
clusters of many RCs and of every kind of spread selector.
"""

import dataclasses
import json
import pathlib
import random

import numpy as np
import pytest

import kubernetes_tpu.api.types as J
from kubernetes_tpu.oracle.state import ClusterState
from kubernetes_tpu.snapshot.encode import SnapshotEncoder as JaxEncoder
from kubernetes_tpu.snapshot.volumes import VolumeCompiler as JaxVolumes

from benchmark import traffic as bench_traffic
from kubernetes_tpu_torch.snapshot.encode import SnapshotEncoder
from kubernetes_tpu_torch.snapshot.volumes import VolumeCompiler
from tests.test_conformance import REGION, ZONE, scenario_pvs_pvcs
from tests.test_torch_ops import port_state, to_port

GPU = "alpha.kubernetes.io/nvidia-gpu"
BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
VOCABS = ("ports", "kv", "keys", "numkeys", "taints", "zones", "classes")


def _node(name, labels=None, alloc=None, taints=None, annotations=None,
          conditions=(), images=()):
    return J.Node(
        metadata=J.ObjectMeta(name=name, labels=dict(labels or {}),
                              annotations=dict(annotations or {})),
        spec=J.NodeSpec(taints=taints),
        status=J.NodeStatus(
            allocatable=dict(alloc or {"cpu": "4", "memory": "32Gi",
                                       "pods": "110"}),
            conditions=[J.NodeCondition("Ready", "True"), *conditions],
            images=list(images)))


def _pod(name, node="", labels=None, ports=(), image="", volumes=(),
         affinity=None, cpu="100m"):
    c = J.Container(image=image, requests={"cpu": cpu, "memory": "500Mi"},
                    ports=[J.ContainerPort(host_port=p, container_port=80)
                           for p in ports])
    return J.Pod(metadata=J.ObjectMeta(name=name, labels=dict(labels or {})),
                 spec=J.PodSpec(node_name=node, containers=[c],
                                volumes=list(volumes), affinity=affinity))


def _node_affinity(*reqs):
    term = J.NodeSelectorTerm(match_expressions=tuple(
        J.NodeSelectorRequirement(key=k, operator=op, values=(v,))
        for k, op, v in reqs))
    return J.Affinity(node_affinity=J.NodeAffinity(
        required_during_scheduling_ignored_during_execution=J.NodeSelector(
            node_selector_terms=(term,))))


def zoned_1k(rng):
    """The benchmark's zoned shape at 1,000 nodes, from its generator."""
    config = json.loads(
        (BENCH / "configs/scheduler-perf-1k-zoned.json").read_text())
    traffic = json.loads(
        (BENCH / "traffic/rc-backlog-30-per-node.json").read_text())
    desc = bench_traffic.describe(config, traffic, rng.randrange(2**40))
    ns, st = desc["namespace"], desc["states"][rng.randrange(2)]
    nodes = [_node(n["name"], n["labels"], n["allocatable"])
             for n in st["nodes"]]
    bound = []
    for b in st["bound"]:
        p = _pod(b["name"], b["node"], b["labels"])
        p.metadata.namespace = ns
        bound.append(p)
    g = desc["groups"][0]
    pending = [_pod(f"{g['name']}-{i}", labels=g["labels"]) for i in range(3)]
    for p in pending:
        p.metadata.namespace = ns
    services = [J.Service(metadata=J.ObjectMeta(name=s["name"], namespace=ns),
                          spec=J.ServiceSpec(selector=dict(s["selector"])))
                for s in desc["services"]]
    return ClusterState.build(nodes, assigned_pods=bound,
                              services=services), pending


def taints(rng):
    """Duplicate taints in one list, annotation taints, and malformed
    annotations (no taints, taint_bad)."""
    dup = J.Taint(key="dedicated", value="a", effect="NoSchedule")
    nodes = []
    for i in range(40):
        kind = rng.randrange(5)
        kw = {}
        if kind == 1:
            kw["taints"] = [dup, dup, J.Taint(key="x", value="",
                                              effect="PreferNoSchedule")]
        elif kind == 2:
            kw["annotations"] = {J.TAINTS_ANNOTATION: json.dumps(
                [{"key": "special", "value": "b"},
                 {"key": "special", "value": "b"}])}
        elif kind == 3:
            kw["annotations"] = {J.TAINTS_ANNOTATION: "[{not json"}
        elif kind == 4:
            kw["taints"] = []
        nodes.append(_node(f"n{i:02d}", {ZONE: rng.choice("ab")}, **kw))
    bound = [_pod(f"b{i}", f"n{rng.randrange(40):02d}", {"app": "x"})
             for i in range(30)]
    return ClusterState.build(nodes, assigned_pods=bound), [_pod("p")]


def numeric_labels(rng):
    """Gt/Lt keys on nodes with numeric, non-numeric and absent values."""
    values = ["4", "12", "x", "1e3", "-2.5", "", "nan", None]
    nodes = []
    for i in range(30):
        labels = {"k": f"v{i % 3}"}
        for key in ("gen", "cores"):
            v = rng.choice(values)
            if v is not None:
                labels[key] = v
        nodes.append(_node(f"n{i:02d}", labels))
    pending = [_pod("p0", affinity=_node_affinity(("gen", "Gt", "3"))),
               _pod("p1", affinity=_node_affinity(("cores", "Lt", "20"),
                                                  ("k", "In", "v1")))]
    return ClusterState.build(nodes), pending


def images(rng):
    """Two status.images entries naming the same image: the first wins."""
    nodes = []
    for i in range(20):
        imgs = [J.ContainerImage(names=("web:1", "web:latest"),
                                 size_bytes=rng.randrange(1, 10**9)),
                J.ContainerImage(names=("web:1",), size_bytes=5),
                J.ContainerImage(names=("db:2",), size_bytes=2**40 + i)]
        rng.shuffle(imgs)
        nodes.append(_node(f"n{i:02d}", images=imgs[:rng.randrange(4)]))
    pending = [_pod("p0", image="web:1"), _pod("p1", image="db:2"),
               _pod("p2", image="web:latest"), _pod("p3", image="none")]
    return ClusterState.build(nodes), pending


def host_ports(rng):
    """Host ports of assigned pods, 0 among them, some shared on a node."""
    nodes = [_node(f"n{i:02d}") for i in range(20)]
    bound = [_pod(f"b{i}", f"n{rng.randrange(20):02d}",
                  ports=rng.sample([0, 0, 80, 8080, 9090, 9091],
                                   rng.randrange(4)))
             for i in range(40)]
    return (ClusterState.build(nodes, assigned_pods=bound),
            [_pod("p", ports=(8080,))])


def memory_pressure(rng):
    nodes = []
    for i in range(20):
        conds = [J.NodeCondition(rng.choice(["MemoryPressure", "DiskPressure"]),
                                 rng.choice(["True", "False", "Unknown"]))
                 for _ in range(rng.randrange(3))]
        nodes.append(_node(f"n{i:02d}", conditions=conds))
    return ClusterState.build(nodes), [_pod("p")]


def volumes(rng):
    """EBS, GCE and PVC volumes on assigned and pending pods; nodes with
    zone and region labels, one or both or neither."""
    ebs = J.Volume(name="e", aws_elastic_block_store=J.AWSElasticBlockStore(
        volume_id="vol-1"))
    gce = J.Volume(name="g", gce_persistent_disk=J.GCEPersistentDisk(
        pd_name="pd-a", read_only=True))
    claims = [J.Volume(name=c, persistent_volume_claim=(
        J.PersistentVolumeClaimSource(claim_name=c)))
        for c in ("claim-ebs", "claim-gce", "claim-zoned", "claim-unbound",
                  "claim-missing")]
    choices = [ebs, gce, *claims]
    # the first node brings a new zone and a new region at once, so the
    # order in which a node's two values are interned shows in the ids
    nodes = [_node("n00", {ZONE: "c", REGION: "r3"})]
    for i in range(1, 30):
        labels = {}
        if rng.random() < 0.6:
            labels[ZONE] = rng.choice(["a", "b"])
        if rng.random() < 0.6:
            labels[REGION] = rng.choice(["r1", "r2"])
        nodes.append(_node(f"n{i:02d}", labels))
    bound = [_pod(f"b{i}", f"n{rng.randrange(30):02d}",
                  volumes=rng.sample(choices, rng.randrange(3)))
             for i in range(40)]
    pending = [_pod("p0", volumes=[claims[2]]), _pod("p1", volumes=[ebs]),
               _pod("p2")]
    pvs, pvcs = scenario_pvs_pvcs()
    return ClusterState.build(nodes, assigned_pods=bound, pvs=pvs,
                              pvcs=pvcs), pending


def no_pods(rng):
    """Nodes with no pods, whose allocatables repeat and differ in one
    value, its type or its spelling, or leave a resource out."""
    base = {"cpu": "2", GPU: "1", "memory": "8Gi", "pods": "110"}
    allocs = [base, {**base, "cpu": 2, GPU: 1}, {**base, "cpu": "2500m"},
              {**base, "memory": "16Gi"}, {**base, GPU: "2"},
              {**base, "pods": 64}, {"memory": "8Gi"}]
    nodes = [_node(f"n{i:02d}", {ZONE: "a", "x": str(i)},
                   alloc=allocs[rng.randrange(7) if i >= 7 else i])
             for i in range(24)]
    return ClusterState.build(nodes), [_pod("p")]


def one_node(rng):
    return (ClusterState.build([_node("only", {ZONE: "a"})],
                               assigned_pods=[_pod("b", "only")]),
            [_pod("p")])


CLUSTERS = (zoned_1k, taints, numeric_labels, images, host_ports,
            memory_pressure, volumes, no_pods, one_node)
#: what each cluster must reach in the reference's snapshot, so that the
#: comparison covers the branch it is there for
REACHES = {
    "zoned_1k": lambda s: s.num_nodes == 1000 and s.class_count.any(),
    "taints": lambda s: s.taint_bad.any() and (s.taint_count > 1).any()
    and s.has_taints.any(),
    "numeric_labels": lambda s: np.isfinite(s.numval).any()
    and np.isnan(s.numval).any(),
    "images": lambda s: (s.img_size == 5).any() and (s.img_size > 5).any(),
    "host_ports": lambda s: s.port_mask.any() and not s.port_mask.all(),
    "memory_pressure": lambda s: s.mem_pressure.any()
    and not s.mem_pressure.all(),
    "volumes": lambda s: s.vol_any.any() and s.ebs_bad.any()
    and s.vz_has.any() and not s.vz_has.all(),
    "no_pods": lambda s: not s.pod_count.any()
    and len(set(zip(s.alloc_mcpu, s.alloc_mem, s.alloc_gpu,
                    s.alloc_pods))) == 6,
    "one_node": lambda s: s.num_nodes == 1 and s.pod_count[0] == 1,
}


def _assert_equal(name, port, ref):
    if isinstance(ref, np.ndarray):
        assert isinstance(port, np.ndarray), name
        assert (port.dtype, port.shape) == (ref.dtype, ref.shape), name
        assert np.array_equal(port, ref, equal_nan=ref.dtype.kind == "f"), \
            name
    else:
        assert port == ref, name


@pytest.mark.parametrize("cluster", CLUSTERS, ids=lambda f: f.__name__)
def test_node_encode_matches_the_jax_encoder(cluster):
    state, pending = cluster(random.Random(2147510061))
    pstate, ppending = port_state(state), to_port(pending)

    ref_enc = JaxEncoder(state, pending)
    enc = SnapshotEncoder(pstate, ppending)
    ref, snap = ref_enc.encode_nodes(), enc.encode_nodes()
    assert REACHES[cluster.__name__](ref)
    for f in dataclasses.fields(ref):
        _assert_equal(f.name, getattr(snap, f.name), getattr(ref, f.name))
    for v in VOCABS:
        assert list(getattr(enc, v).ids.items()) == list(
            getattr(ref_enc, v).ids.items()), v
    assert list(enc.images.ids.items()) == list(ref_enc.images.ids.items())

    names = ref_enc.node_names
    ref_compiler = JaxVolumes(state, pending, names)
    compiler = VolumeCompiler(pstate, ppending, names)
    ref_vol, vol = ref_compiler.compile(), compiler.compile()
    for f in dataclasses.fields(ref_vol):
        _assert_equal(f.name, getattr(vol, f.name), getattr(ref_vol, f.name))
    for v in ("conflict", "ebs", "gce", "vzval"):
        assert list(getattr(compiler, v).ids.items()) == list(
            getattr(ref_compiler, v).ids.items()), v
    with_volumes = sum(bool(p.spec.volumes) for p in
                       pstate.all_assigned_pods())
    assert compiler.volume_pods == enc.volume_pods == with_volumes


def _meta(name, ns="default", labels=None):
    return J.ObjectMeta(name=name, namespace=ns, labels=dict(labels or {}))


def many_rcs(rng):
    """The rc-spread-500x40 cell's shape cut to 30 nodes and 24 RCs, from
    the benchmark's generator; a pending pod of each RC and bound pods of
    some."""
    config = json.loads((BENCH / "configs/spread-3k-zoned.json").read_text())
    traffic = json.loads((BENCH / "traffic/rc-spread-500x40.json").read_text())
    config["nodes"] = 30
    traffic["groups"][0]["copies"] = 24
    desc = bench_traffic.describe(config, traffic, rng.randrange(2**40))
    ns, st = desc["namespace"], desc["states"][rng.randrange(2)]
    nodes = [_node(n["name"], n["labels"], n["allocatable"])
             for n in st["nodes"]]
    bound = [_pod(b["name"], b["node"], b["labels"]) for b in st["bound"]]
    for i, g in enumerate(desc["groups"][::3]):
        bound.append(_pod(f"{g['name']}-b", rng.choice(nodes).metadata.name,
                          g["labels"]))
    pending = [_pod(f"{g['name']}-0", labels=g["labels"])
               for g in desc["groups"]]
    for p in bound + pending:
        p.metadata.namespace = ns
    rcs = [J.ReplicationController(
        metadata=_meta(c["name"], ns),
        spec=J.ReplicationControllerSpec(selector=dict(c["selector"]),
                                         replicas=c["replicas"]))
        for c in desc["controllers"]]
    return ClusterState.build(nodes, assigned_pods=bound,
                              controllers=rcs), pending


def spread_selectors(rng):
    """Services, RCs and ReplicaSets in three namespaces: empty and nil
    selectors, selectors of several pairs, of pairs no pod holds and of
    every ReplicaSet operator; deleted and unlabelled assigned pods; in
    "third" one RC of two pairs, and classes holding either pair alone."""
    nodes = [_node(f"n{i:02d}", {ZONE: rng.choice("ab")}) for i in range(12)]
    apps = [{"app": "web"}, {"app": "web", "tier": "fe"}, {"app": "db"},
            {"tier": "fe"}, {}, {"app": "web", "tier": "be", "v": "2"}]
    bound = []
    for i in range(40):
        p = _pod(f"b{i}", f"n{rng.randrange(12):02d}", rng.choice(apps))
        p.metadata.namespace = rng.choice(["default", "other"])
        if rng.random() < 0.2:
            p.metadata.deletion_timestamp = "2016-01-01T00:00:00Z"
        bound.append(p)
    for i, labels in enumerate(apps[:4]):
        p = _pod(f"t{i}", f"n{i:02d}", labels)
        p.metadata.namespace = "third"
        bound.append(p)
    services = [J.Service(metadata=_meta("web"),
                          spec=J.ServiceSpec(selector={"app": "web"})),
                J.Service(metadata=_meta("all", "other"),
                          spec=J.ServiceSpec(selector={})),
                J.Service(metadata=_meta("none"),
                          spec=J.ServiceSpec(selector={"app": "gone"}))]
    rcs = [J.ReplicationController(
               metadata=_meta("fe"),
               spec=J.ReplicationControllerSpec(selector={"app": "web",
                                                          "tier": "fe"})),
           J.ReplicationController(
               metadata=_meta("nil", "other"),
               spec=J.ReplicationControllerSpec(selector=None)),
           J.ReplicationController(
               metadata=_meta("db", "other"),
               spec=J.ReplicationControllerSpec(selector={"app": "db"})),
           J.ReplicationController(
               metadata=_meta("fe", "third"),
               spec=J.ReplicationControllerSpec(selector={"app": "web",
                                                          "tier": "fe"}))]
    req = J.LabelSelectorRequirement
    rss = [J.ReplicaSet(metadata=_meta("rs-in"), spec=J.ReplicaSetSpec(
               selector=J.LabelSelector(match_expressions=(
                   req("tier", "In", ("fe", "be")),
                   req("v", "DoesNotExist"))))),
           J.ReplicaSet(metadata=_meta("rs-not", "other"),
                        spec=J.ReplicaSetSpec(selector=J.LabelSelector(
                            match_labels={"app": "web"},
                            match_expressions=(req("tier", "NotIn",
                                                   ("fe",)),)))),
           J.ReplicaSet(metadata=_meta("rs-exists"), spec=J.ReplicaSetSpec(
               selector=J.LabelSelector(match_expressions=(
                   req("v", "Exists"),))))]
    pending = []
    for i, labels in enumerate(apps * 2):
        p = _pod(f"p{i}", labels=labels)
        p.metadata.namespace = "default" if i < len(apps) else "other"
        pending.append(p)
    third = _pod("p-third", labels={"app": "web", "tier": "fe"})
    third.metadata.namespace = "third"
    pending.append(third)
    return ClusterState.build(nodes, assigned_pods=bound, services=services,
                              controllers=rcs, replica_sets=rss), pending


#: what each cluster's reference PodBatch must reach: every pod has a
#: selector and matches some classes but not all, or some pods have none
#: and the "other" namespace's everything-selectors match all its classes
POD_REACHES = {
    "many_rcs": lambda b: b.has_selectors.all()
    and (b.spread_match.sum(axis=1) > 0).all()
    and not b.spread_match.all(axis=1).any(),
    "spread_selectors": lambda b: b.has_selectors.any()
    and not b.has_selectors.all()
    and (b.spread_match.sum(axis=1) > 1).any(),
}


@pytest.mark.parametrize("cluster", (many_rcs, spread_selectors),
                         ids=lambda f: f.__name__)
def test_pod_encode_matches_the_jax_encoder(cluster):
    state, pending = cluster(random.Random(2147510063))
    ref_enc = JaxEncoder(state, pending)
    enc = SnapshotEncoder(port_state(state), to_port(pending))
    ref_enc.encode_nodes(), enc.encode_nodes()
    ref, batch = ref_enc.encode_pods(), enc.encode_pods()
    assert POD_REACHES[cluster.__name__](ref)
    for f in dataclasses.fields(ref):
        _assert_equal(f.name, getattr(batch, f.name), getattr(ref, f.name))
    assert list(enc.classes.ids.items()) == list(ref_enc.classes.ids.items())
