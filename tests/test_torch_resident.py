"""The port's resident sharded state (parallel/resident) and its row
scatter (parallel/resident_kernel: the plain version of K8) against the
JAX package's, on the CPU.

The counterparts of tests/test_resident.py: steady waves ship no
node-table bytes and keep every resident tensor's storage (the port
updates in place where the JAX package donates); a node update or
removal inside the padded bucket scatters rows and equals a rebuild and
the single-device decisions; the resident stats (rebuilds, scatters,
replaces, what changed, the bytes) and the dispatch tally equal the JAX
mesh's wave by wave. The port's mesh runs at 1, 2 and 8 shards of the
CPU, the JAX mesh at its 8 CPU devices. Exact equality throughout."""

import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as PSpec

import jax
import kubernetes_tpu.api.types as JT
from kubernetes_tpu.oracle import ClusterState as JaxState
from kubernetes_tpu.parallel.mesh import MeshWaveScheduler as JaxMeshWave
from kubernetes_tpu.parallel.mesh import _pad_snapshot
from kubernetes_tpu.parallel.resident import AXIS
from kubernetes_tpu.parallel.resident import (
    ResidentClusterState as JaxResident,
)
from kubernetes_tpu.scheduler.tpu_algorithm import TPUScheduleAlgorithm
from kubernetes_tpu.snapshot.encode import SnapshotEncoder
from kubernetes_tpu.snapshot.pad import next_pow2

import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.models.wave import WaveScheduler
from kubernetes_tpu_torch.oracle import ClusterState as PortState
from kubernetes_tpu_torch.parallel import resident_kernel as RK
from kubernetes_tpu_torch.parallel.mesh import MeshWaveScheduler
from kubernetes_tpu_torch.parallel.resident import (
    CARRY_FIELDS,
    ResidentClusterState,
)
from kubernetes_tpu_torch.parallel.shard import DeviceMesh
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm

from tests.test_torch_ops import fields_of

SHARDS = (1, 2, 8)
_JAX: dict = {}


def jax_mesh():
    return Mesh(np.array(jax.devices()), ("nodes",))


def jax_once(key, fn):
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def port_mesh(k):
    return DeviceMesh(["cpu"] * k)


def _nodes(T, n, cpu="4"):
    return [T.Node(
        metadata=T.ObjectMeta(name=f"rnode-{i:05d}"),
        status=T.NodeStatus(
            allocatable={"cpu": cpu, "memory": "32Gi", "pods": "110"},
            conditions=[T.NodeCondition("Ready", "True")]),
    ) for i in range(n)]


def _pods(T, n, cpu="100m", tag="t"):
    return [T.Pod(
        metadata=T.ObjectMeta(name=f"rp-{tag}-{i:06d}",
                              labels={"app": "resident"}),
        spec=T.PodSpec(containers=[T.Container(
            requests={"cpu": cpu, "memory": "500Mi"})]),
    ) for i in range(n)]


def _encode(state, reps):
    """The JAX encoder's padded snapshot and batch, and the port's
    copies of them."""
    from kubernetes_tpu_torch.snapshot.carry import (
        batch_from_arrays,
        snapshot_from_arrays,
    )

    enc = SnapshotEncoder(state, reps)
    snap, batch = enc.encode_nodes(), enc.encode_pods()
    snap = _pad_snapshot(snap, next_pow2(snap.num_nodes, 64))
    return (snap, batch, snapshot_from_arrays(fields_of(snap)),
            batch_from_arrays(fields_of(batch)))


def _stats(stats):
    return {k: v for k, v in stats.items()}


def _ptrs(res: ResidentClusterState):
    return {(f, s): t.data_ptr()
            for f, ts in list(res._static.items()) + list(res._carry.items())
            for s, t in enumerate(ts) if t.numel()}


# -- the row scatter ----------------------------------------------------------


def _jax_scatter(c):
    """The JAX package's sharded row-scatter program (_scatter_fn under
    shard_map) on the same rows, at the case's shard count."""
    names = [f[0] for f in c["fields"]]
    axes = [f[1] for f in c["fields"]]
    mesh = Mesh(np.array(jax.devices()[:c["shards"]]), ("nodes",))
    specs = tuple(PSpec(*[AXIS if i == ax else None
                          for i in range(c["new"][nm].ndim)])
                  for nm, ax in zip(names, axes))
    arrays = tuple(
        jax.device_put(c["old"][nm].astype(c["new"][nm].dtype),
                       NamedSharding(mesh, sp))
        for nm, sp in zip(names, specs))
    run = JaxResident(mesh)._scatter_program(
        tuple(names), tuple(axes), specs, c["layout"],
        tuple(a.shape for a in arrays), c["n_per_shard"], donate=False)
    return {nm: np.asarray(a) for nm, a in zip(names,
                                               run(arrays, c["buf"]))}


@pytest.mark.parametrize("case", S.SCATTER_CPU_CASES,
                         ids=[c[0] for c in S.SCATTER_CPU_CASES])
def test_scatter_rows_plain_matches_jax_scatter(case):
    """scatter_rows (its plain version on the CPU), shard by shard, equals
    the JAX package's _scatter_fn on the same packed rows and the
    expected update, on every dtype pair (a narrowed int8/int16 table
    kept narrow, a uint32 bitset with its top bit set zero-extended,
    bool, float with NaN), the node axis first and second, off-shard
    rows and -1 padding."""
    label, shards, n, M, k, fields = case
    c = S.scatter_case(shards, n, M, k, seed=5, fields=fields)
    names = [f[0] for f in c["fields"]]
    axes = [f[1] for f in c["fields"]]
    narrowed = frozenset(f[0] for f in c["fields"] if f[2])
    buf = torch.from_numpy(c["buf"])
    parts = {nm: [] for nm in names}
    for s in range(shards):
        tabs = {nm: torch.from_numpy(v)
                for nm, v in S.scatter_shard_tables(c, s).items()}
        RK.scatter_rows(c["layout"], buf, names, axes,
                        [tabs[nm] for nm in names], n, s * n, narrowed)
        for nm in names:
            parts[nm].append(tabs[nm].numpy())
    jax_out = _jax_scatter(c)
    for nm, ax in zip(names, axes):
        got = np.concatenate(parts[nm], axis=ax)
        want = c["expected"][nm]
        nan = want.dtype.kind == "f"
        assert got.dtype == want.dtype, (label, nm)
        assert np.array_equal(got, want, equal_nan=nan), (label, nm)
        jx = jax_out[nm]
        assert np.array_equal(
            jx.astype(want.dtype) if nm not in narrowed else jx, want,
            equal_nan=nan), (label, nm)


def _case_inputs(case, seed=5):
    """A SCATTER_CPU_CASES entry -> (case, names, axes, narrowed, buffer,
    each shard's tables {name: tensor})."""
    label, shards, n, M, k, fields = case
    c = S.scatter_case(shards, n, M, k, seed=seed, fields=fields)
    names = [f[0] for f in c["fields"]]
    axes = [f[1] for f in c["fields"]]
    narrowed = frozenset(f[0] for f in c["fields"] if f[2])
    tabs = [{nm: torch.from_numpy(v)
             for nm, v in S.scatter_shard_tables(c, s).items()}
            for s in range(shards)]
    return c, names, axes, narrowed, torch.from_numpy(c["buf"]), tabs


def _assert_expected(c, names, axes, narrowed, tabs, label, jax_out=None):
    for nm, ax in zip(names, axes):
        got = np.concatenate([tb[nm].numpy() for tb in tabs], axis=ax)
        want = c["expected"][nm]
        nan = want.dtype.kind == "f"
        assert got.dtype == want.dtype, (label, nm)
        assert np.array_equal(got, want, equal_nan=nan), (label, nm)
        if jax_out is not None:
            jx = jax_out[nm]
            assert np.array_equal(
                jx.astype(want.dtype) if nm not in narrowed else jx, want,
                equal_nan=nan), (label, nm)


def _table(names, tabs):
    """A DestTable on the CPU over every shard's tables."""
    return RK.DestTable("cpu", len(tabs), {
        nm: {s: tb[nm] for s, tb in enumerate(tabs)} for nm in names})


@pytest.mark.parametrize("case", S.SCATTER_CPU_CASES,
                         ids=[c[0] for c in S.SCATTER_CPU_CASES])
def test_scatter_shipment_plain_matches_jax_scatter(case):
    """The device-wide entry scatter_shipment (its plain version on the
    CPU), one call for every shard of the case with the shards' pointer
    table, equals the JAX package's _scatter_fn on the same packed rows
    and the expected update, on every dtype pair."""
    c, names, axes, narrowed, buf, tabs = _case_inputs(case)
    shards = c["shards"]
    RK.scatter_shipment(c["layout"], buf, names, axes,
                        [[tb[nm] for nm in names] for tb in tabs],
                        range(shards), c["n_per_shard"], narrowed,
                        table=_table(names, tabs))
    _assert_expected(c, names, axes, narrowed, tabs, case[0],
                     _jax_scatter(c))


def _load_bits(raw, p, code):
    width, kind = code & 0xff, code >> 8
    v = int.from_bytes(raw[p:p + width].tobytes(), "little",
                       signed=kind == RK.KIND_SIGNED)
    return v & (2**64 - 1)


def _store_bits(out, p, code, v):
    width, kind = code & 0xff, code >> 8
    if kind == RK.KIND_BOOL:
        out[p] = 1 if v != 0 else 0
        return
    out[p:p + width] = np.frombuffer(
        (v & (2**(8 * width) - 1)).to_bytes(width, "little"), np.uint8)


def reenact_k8(buf: torch.Tensor, table: RK.DestTable, a: RK.LaunchArgs,
               memory: dict) -> None:
    """csrc/resident_scatter.cu's kernel thread by thread on the CPU: the
    field on blockIdx.y, a team of a.lanes threads a row, the shard from
    idx // n_per_shard and the launch's bit set, the destination from the
    device table (memory: pointer -> the tensor's bytes), the 16-byte
    path where the copy keeps its code (not bool) and every segment and
    its destination are 16-byte aligned, else element by element with
    (a, b) stepped by the team's width."""
    raw = buf.numpy()
    base = buf.data_ptr()
    dests = table.table.numpy()
    n = a.n_per_shard
    idx = raw[a.idx_off:a.idx_off + 8 * a.M].view(np.int64)
    for src_off, outer, inner, codes, row in a.desc:
        src_code, dst_code = codes & 0xffff, codes >> 16
        src_w, dst_w = src_code & 0xff, dst_code & 0xff
        per_row = outer * inner
        for t in range(a.M * a.lanes):
            m, lane = t // a.lanes, t % a.lanes
            g = int(idx[m])
            if g < 0:
                continue
            s = g // n
            if s >= a.n_shards or not (a.mask[s >> 6] >> (s & 63)) & 1:
                continue
            local = g - s * n
            ptr = int(dests[row * a.n_shards + s])
            out = memory[ptr]
            if per_row == 0:
                continue
            r0 = src_off + m * per_row * src_w
            if src_code == dst_code and dst_code >> 8 != RK.KIND_BOOL:
                ln = inner * src_w
                vec = ln % 16 == 0 and all(
                    ((base + r0 + k * ln) | (ptr + (k * n + local) * ln))
                    % 16 == 0 for k in range(outer))
                if vec:
                    for k in range(outer):
                        for ch in range(lane, ln // 16, a.lanes):
                            d0 = (k * n + local) * ln + 16 * ch
                            s0 = r0 + k * ln + 16 * ch
                            out[d0:d0 + 16] = raw[s0:s0 + 16]
                    continue
            ai, b = 0, lane
            while b >= inner and ai < outer:
                b -= inner
                ai += 1
            e = lane
            while e < per_row:
                v = _load_bits(raw, r0 + e * src_w, src_code)
                _store_bits(out, ((ai * n + local) * inner + b) * dst_w,
                            dst_code, v)
                b += a.lanes
                while b >= inner:
                    b -= inner
                    ai += 1
                e += a.lanes


@pytest.mark.parametrize("lanes", (1, 8, 32))
@pytest.mark.parametrize("case", S.SCATTER_CPU_CASES,
                         ids=[c[0] for c in S.SCATTER_CPU_CASES])
def test_kernel_walk_reenacted(case, lanes):
    """The kernel's walk, re-enacted thread by thread over the wrapper's
    own launch arguments (launch_args: codes, strides, table rows, the
    shard bit set) at each team width: one launch of the even shards
    leaves the odd ones as they were, one of the odd shards then
    completes the expected update, every dtype pair included."""
    c, names, axes, narrowed, buf, tabs = _case_inputs(case)
    shards, n = c["shards"], c["n_per_shard"]
    table = _table(names, tabs)
    memory = {t.data_ptr(): t.numpy().view(np.uint8).reshape(-1)
              for tb in tabs for t in tb.values()}
    # the widest rows: 48 bytes (the (6, N) block) and 32 (4 label words
    # widened to int64): a team of 8
    for part in (range(0, shards, 2), range(1, shards, 2)):
        ids = list(part)
        if not ids:
            continue
        a = RK.launch_args(c["layout"], buf, names, axes,
                           [[tabs[s][nm] for nm in names] for s in ids],
                           ids, n, narrowed, table)
        assert a.lanes == 8 and a.n_shards == shards
        reenact_k8(buf, table, a._replace(lanes=lanes), memory)
        if ids[0] == 0:
            for s in range(1, shards, 2):
                for nm, v in S.scatter_shard_tables(c, s).items():
                    assert np.array_equal(tabs[s][nm].numpy(), v,
                                          equal_nan=v.dtype.kind == "f")
    _assert_expected(c, names, axes, narrowed, tabs, case[0])


@pytest.mark.parametrize("devices, owners, want", [
    (["cuda:0", "cuda:1"] * 4, (6, 0, 3, 1, 3),
     [("cuda:0", (0, 6)), ("cuda:1", (1, 3))]),
    (["cuda:0", "cuda:1"] * 4, (5, 7), [("cuda:1", (5, 7))]),
    (["cuda:0"] * 4, (3, 1, 2), [("cuda:0", (1, 2, 3))]),
    (["cuda:1", "cuda:0", "cuda:0", "cuda:1"], (2, 3, 1),
     [("cuda:0", (1, 2)), ("cuda:1", (3,))]),
], ids=["alternating", "one device owns", "one card", "first owner first"])
def test_launch_plan_groups_owning_shards_by_device(devices, owners, want):
    """The resident scatter's launch plan: one launch for each device
    that holds an owning shard, each with its own shards in mesh order
    and their first global nodes (no card is touched: the devices are
    only compared)."""
    n = 2048
    plan = RK.launch_plan([torch.device(d) for d in devices], owners, n)
    assert [(str(p.device), p.shards) for p in plan] == want
    for p in plan:
        assert p.offsets == tuple(s * n for s in p.shards)
        assert all(torch.device(devices[s]) == p.device for s in p.shards)


def test_scatter_rows_checks_its_inputs():
    c = S.scatter_case(2, 16, 64, 8, seed=1, fields="update")
    names = [f[0] for f in c["fields"]]
    axes = [f[1] for f in c["fields"]]
    tabs = S.scatter_shard_tables(c, 0)
    dests = [torch.from_numpy(tabs[nm]) for nm in names]
    buf = torch.from_numpy(c["buf"])
    with pytest.raises(ValueError, match="no kernel"):
        RK.scatter_rows(c["layout"], buf.to("meta"), names, axes, dests,
                        16, 0)
    assert RK._src_code(np.dtype(np.uint32)) == 4 | RK.KIND_UNSIGNED << 8
    assert RK._dst_code(torch.zeros(1, dtype=torch.int8)) == 1
    assert RK._axis_strides((2, 16, 3), 1) == (2, 3)
    # the device-wide entry: a shard outside the mesh, a destination on
    # another device than the buffer, a table that points elsewhere, a
    # shard twice, a plan of a shard past the mesh
    stale = RK.DestTable("cpu", 2, {nm: {0: d.clone()}
                                    for nm, d in zip(names, dests)})
    with pytest.raises(ValueError, match="outside a mesh of 2"):
        RK.scatter_shipment(c["layout"], buf, names, axes, [dests], [2],
                            16, table=stale)
    with pytest.raises(ValueError, match="outside a mesh of 2"):
        RK.scatter_shipment(c["layout"], buf, names, axes, [dests], [-1],
                            16, table=stale)
    with pytest.raises(ValueError, match="lies on meta"):
        RK.scatter_shipment(c["layout"], buf, names, axes,
                            [dests[:-1] + [dests[-1].to("meta")]], [0], 16)
    with pytest.raises(ValueError, match="not the tensor"):
        RK.scatter_shipment(c["layout"], buf, names, axes, [dests], [0], 16,
                            table=stale)
    with pytest.raises(ValueError, match="outside the table"):
        stale.check(names, [3], [dests])
    with pytest.raises(ValueError, match="twice"):
        RK.scatter_shipment(c["layout"], buf, names, axes, [dests, dests],
                            [0, 0], 16)
    with pytest.raises(ValueError, match="outside a mesh of 2"):
        RK.launch_plan(["cpu", "cpu"], [0, 2], 16)
    with pytest.raises(ValueError, match="not a shard's first node"):
        RK.scatter_rows(c["layout"], buf, names, axes, dests, 16, 8)
    with pytest.raises(ValueError, match="do not fit"):
        RK.launch_args(c["layout"], buf, names, axes, [dests[1:] + dests[:1]],
                       [0], 16, frozenset(), _table(names, [dict(
                           zip(names, dests))]))


# -- steady waves ---------------------------------------------------------------


@pytest.mark.parametrize("k", SHARDS)
def test_resident_tensors_stable_and_zero_table_bytes(k):
    """Across steady waves (reuse="carry"): no node-table bytes ship,
    the per-wave upload stays O(pending pods), every resident tensor
    keeps its storage (in-place folds, the counterpart of donation), and
    the stats equal the JAX mesh's wave by wave."""
    state = JaxState.build(_nodes(JT, 200))
    snap, batch, psnap, pbatch = _encode(state, _pods(JT, 1))
    rep_idx = np.zeros(128, np.int64)

    def ref():
        m = JaxMeshWave(jax_mesh())
        out, last, stats = [], 0, []
        for _ in range(5):
            o, _c, last = m.schedule_backlog(snap, batch, rep_idx, last,
                                             reuse="carry")
            out.append(o)
            stats.append(_stats(m.resident.stats))
        return out, stats

    jout, jstats = jax_once("steady", ref)
    m = MeshWaveScheduler(port_mesh(k))
    last = 0
    o, _c, last = m.schedule_backlog(psnap, pbatch, rep_idx, last,
                                     reuse="carry")
    assert np.array_equal(o, jout[0]) and m.resident.stats == jstats[0]
    ptrs = _ptrs(m.resident)
    for w in range(1, 5):
        o, _c, last = m.schedule_backlog(psnap, pbatch, rep_idx, last,
                                         reuse="carry")
        assert np.array_equal(o, jout[w])
        assert m.resident.stats == jstats[w]
        assert m.resident.stats["wave_table_bytes"] == 0
        assert m.resident.stats["wave_h2d_bytes"] < 64 * 1024
        assert _ptrs(m.resident) == ptrs, "a resident tensor moved"
    assert m.resident.stats["rebuilds"] == 1


@pytest.mark.parametrize("k", SHARDS)
def test_resident_waves_match_single_device_one_call(k):
    """Five waves against the stale wave-0 snapshot equal the
    single-device driver's one call over the concatenated backlog."""
    state = JaxState.build(_nodes(JT, 100, cpu="2"))
    _s, _b, psnap, pbatch = _encode(state, _pods(JT, 1))
    m = MeshWaveScheduler(port_mesh(k))
    outs, last = [], 0
    for _ in range(5):
        o, _c, last = m.schedule_backlog(psnap, pbatch,
                                         np.zeros(96, np.int64), last,
                                         reuse="carry")
        outs.append(o)
    want, _c, want_last = WaveScheduler(device="cpu").schedule_backlog(
        psnap, pbatch, np.zeros(96 * 5, np.int64), 0)
    assert np.array_equal(np.concatenate(outs), want)
    assert last == want_last


def _daemon_waves(T, CS, algo, n_waves, state=None, tag="w"):
    """Waves whose binds commit into the cluster between them (every
    wave re-encodes): -> (names per wave, stats per wave)."""
    state = state or CS.build(_nodes(T, 150))
    names, stats = [], []
    for i in range(n_waves):
        pods = _pods(T, 64, tag=f"{tag}{i}")
        hosts = algo.schedule_backlog(pods, state)
        assert all(h is not None for h in hosts)
        S.bind_hosts(state, pods, hosts)
        names.append(hosts)
        ms = algo._mesh_sched
        stats.append((_stats(ms.resident.stats), dict(ms.dispatches)))
    return names, stats, state


@pytest.mark.parametrize("k", SHARDS)
def test_auto_mode_daemon_shape_zero_table_bytes(k):
    """The daemon shape (reuse="auto"): the mirrors prove the re-encoded
    snapshot equals the resident state (its own binds and nothing else),
    so steady waves ship no node tables; names, stats and tallies equal
    the JAX mesh's wave by wave."""
    jnames, jstats = jax_once("daemon", lambda: _daemon_waves(
        JT, JaxState, TPUScheduleAlgorithm(mesh=jax_mesh()), 4)[:2])
    algo = TorchScheduleAlgorithm(device="cpu", mesh=port_mesh(k))
    names, stats, _st = _daemon_waves(TT, PortState, algo, 4)
    assert names == jnames
    assert stats == jstats
    for st, _d in stats[1:]:
        assert st["wave_table_bytes"] == 0 and st["last_changed"] == ()
    assert stats[-1][0]["rebuilds"] == 1


# -- node updates and removals ---------------------------------------------------


def _views_host(res, k):
    """The resident state as global host arrays: static field -> array,
    carry field -> array (shards concatenated on the node axis)."""
    from kubernetes_tpu_torch.parallel.resident import (
        carry_specs,
        static_specs,
    )

    sspec = static_specs(res._static.keys())
    out = {}
    for f, ts in res._static.items():
        ax = sspec[f]
        out[f] = (ts[0].numpy() if ax is None else
                  np.concatenate([t.numpy() for t in ts], axis=ax))
    for f, ax in zip(CARRY_FIELDS, carry_specs()):
        ts = res._carry[f]
        out[f] = (ts[0].numpy() if ax is None else
                  np.concatenate([t.numpy() for t in ts], axis=ax))
    return out


@pytest.mark.parametrize("k", SHARDS)
def test_node_update_scatter_matches_rebuild(k):
    """A node added and a capacity changed inside the 64-node bucket:
    the resident state scatters the changed rows (no rebuild), equals a
    fresh placement of the new snapshot and the JAX resident state, and
    its stats equal the JAX package's."""
    from kubernetes_tpu_torch.models.batch import SchedulerConfig

    state0 = JaxState.build(_nodes(JT, 50))
    nodes2 = _nodes(JT, 50) + _nodes(JT, 1, cpu="8")
    nodes2[-1].metadata.name = "rnode-00050"
    nodes2[7].status.allocatable = dict(nodes2[7].status.allocatable,
                                        cpu="16")
    state1 = JaxState.build(nodes2)
    snap0, _b, psnap0, _pb = _encode(state0, _pods(JT, 1))
    snap1, _b, psnap1, _pb = _encode(state1, _pods(JT, 1))

    def ref():
        jr = JaxResident(jax_mesh())
        cfg = JaxMeshWave(jax_mesh()).config
        jr.sync(cfg, snap0, 0)
        static, carry = jr.sync(cfg, snap1, 0)
        arrays = {f: np.asarray(v) for f, v in static.items()}
        arrays.update({f: np.asarray(v) for f, v in zip(CARRY_FIELDS,
                                                         carry)})
        return arrays, _stats(jr.stats)

    jarrays, jstats = jax_once("update", ref)
    cfg = SchedulerConfig()
    res = ResidentClusterState(port_mesh(k))
    res.sync(cfg, psnap0, 0)
    ptrs = _ptrs(res)
    res.sync(cfg, psnap1, 0)
    assert res.stats == jstats
    assert res.stats["rebuilds"] == 1 and res.stats["scatters"] == 1
    assert _ptrs(res) == ptrs, "the scatter must update in place"
    fresh = ResidentClusterState(port_mesh(k))
    fresh.sync(cfg, psnap1, 0)
    got, want = _views_host(res, k), _views_host(fresh, k)
    assert got.keys() == want.keys()
    for f in got:
        assert got[f].dtype == want[f].dtype, f
        nan = got[f].dtype.kind == "f"
        assert np.array_equal(got[f], want[f], equal_nan=nan), f
        assert np.array_equal(got[f], np.asarray(jarrays[f]).astype(
            got[f].dtype), equal_nan=nan), f


@pytest.mark.parametrize("k", SHARDS)
def test_node_remove_scatter_matches_rebuild_and_decisions(k):
    """A live node becomes a padded slot: the scatter-synced resident
    state schedules as the single-device driver and the JAX mesh do on
    the shrunken cluster, with no rebuild."""
    def run(T, CS, algo, single):
        state = CS.build(_nodes(T, 40))
        p0 = _pods(T, 32, tag="a")
        got0 = algo.schedule_backlog(p0, state)
        if single is not None:
            assert got0 == single.schedule_backlog(p0, state)
        state2 = CS.build(_nodes(T, 39))  # node 39 gone
        p1 = _pods(T, 32, tag="b")
        got1 = algo.schedule_backlog(p1, state2)
        if single is not None:
            assert got1 == single.schedule_backlog(p1, state2)
        ms = algo._mesh_sched
        return got0, got1, _stats(ms.resident.stats), dict(ms.dispatches)

    jref = jax_once("remove", lambda: run(
        JT, JaxState, TPUScheduleAlgorithm(mesh=jax_mesh()), None))
    algo = TorchScheduleAlgorithm(device="cpu", mesh=port_mesh(k))
    got = run(TT, PortState, algo, TorchScheduleAlgorithm(device="cpu"))
    assert got == jref
    assert got[2]["rebuilds"] == 1
    assert "rnode-00039" not in got[1]


@pytest.mark.parametrize("k", SHARDS)
def test_churn_waves_match_jax(k):
    """Create, delete and reschedule churn (the soak's shape): quiet
    waves ship no node tables; the delete wave resyncs by scatter or a
    bounded re-place; names and stats equal the JAX mesh's."""
    def run(T, CS, algo):
        state = CS.build(_nodes(T, 120))
        bound, out = [], []

        def wave(n, tag):
            pods = _pods(T, n, tag=tag)
            hosts = algo.schedule_backlog(pods, state)
            bound.extend(S.bind_hosts(state, pods, hosts))
            out.append((hosts, _stats(algo._mesh_sched.resident.stats)))

        wave(48, "s0")
        wave(48, "s1")
        for i in range(4):
            if i == 2:
                for q in bound[:48]:
                    state.get_node_info_any(q.spec.node_name).remove_pod(q)
                del bound[:48]
            wave(48, f"c{i}")
        return out

    jout = jax_once("churn", lambda: run(
        JT, JaxState, TPUScheduleAlgorithm(mesh=jax_mesh())))
    got = run(TT, PortState, TorchScheduleAlgorithm(device="cpu",
                                                    mesh=port_mesh(k)))
    assert got == jout
    quiet = [st for i, (_h, st) in enumerate(got) if i in (1, 2, 3, 5)]
    assert all(st["wave_table_bytes"] == 0 for st in quiet)
    assert got[-1][1]["rebuilds"] == 1


def test_narrowed_tables_rebuild_wider_when_a_value_outgrows_them():
    """A declared-narrow static table (zone_id) is placed at int8 and
    keeps its dtype through a row scatter; a vocab past int8 changes
    the placement signature and rebuilds it at int16."""
    from kubernetes_tpu_torch.models.batch import SchedulerConfig
    from kubernetes_tpu_torch.snapshot.carry import snapshot_from_arrays

    state = JaxState.build(_nodes(JT, 20))
    _s, _b, psnap, _pb = _encode(state, _pods(JT, 1))
    res = ResidentClusterState(port_mesh(2), quant_mode="int")
    cfg = SchedulerConfig()
    res.sync(cfg, psnap, 0)
    assert res._static["zone_id"][0].dtype == torch.int8
    fields = fields_of(psnap)
    zone = np.array(psnap.zone_id, copy=True)
    zone[3] = 5
    res.sync(cfg, snapshot_from_arrays(dict(fields, zone_id=zone)), 0)
    assert res.stats["rebuilds"] == 1 and res.stats["scatters"] == 1
    assert res._static["zone_id"][0].dtype == torch.int8
    assert int(res._static["zone_id"][0][3]) == 5
    zone[4] = 300
    res.sync(cfg, snapshot_from_arrays(dict(fields, zone_id=zone)), 0)
    assert res.stats["rebuilds"] == 2
    assert res._static["zone_id"][0].dtype == torch.int16
    off = ResidentClusterState(port_mesh(2), quant_mode="off")
    off.sync(cfg, psnap, 0)
    assert off._static["zone_id"][0].dtype == torch.int64


def _table_points_at_resident(res):
    """Every node-axis tensor of every shard is where its device's K8
    destination table points."""
    from kubernetes_tpu_torch.parallel.resident import (
        carry_specs,
        static_specs,
    )

    sspec = static_specs(res._static.keys())
    cspec = dict(zip(CARRY_FIELDS, carry_specs()))
    fields = {f: ts for f, ts in res._static.items() if sspec[f] is not None}
    fields.update((f, res._carry[f]) for f in CARRY_FIELDS
                  if cspec[f] is not None)
    assert set(res._dest_tables) == set(res.mesh.distinct_devices())
    for d, table in res._dest_tables.items():
        assert set(table.rows) == set(fields)
        assert table.n_shards == res.mesh.size
        assert np.array_equal(table.table.numpy(), table.ptrs.reshape(-1))
        for f, ts in fields.items():
            for s, t in enumerate(ts):
                want = t.data_ptr() if res.mesh.devices[s] == d else 0
                assert table.ptrs[table.rows[f], s] == want, (f, s)


def test_dest_tables_follow_the_placement():
    """The resident state's K8 destination tables: one a distinct device
    over every node-axis field of every shard, built at placement; a row
    scatter and a wholesale re-place write in place and keep them; a
    rebuild (a narrowed table outgrowing int8) builds them anew. (Their
    copies stay out of `stats`: the tests above hold the bytes to the JAX
    package's, which has no such table.)"""
    from kubernetes_tpu_torch.models.batch import SchedulerConfig
    from kubernetes_tpu_torch.snapshot.carry import snapshot_from_arrays

    state = JaxState.build(_nodes(JT, 40))
    _s, _b, psnap, _pb = _encode(state, _pods(JT, 1))
    res = ResidentClusterState(port_mesh(4), quant_mode="int")
    cfg = SchedulerConfig()
    res.sync(cfg, psnap, 0)
    _table_points_at_resident(res)
    tables = dict(res._dest_tables)
    fields = fields_of(psnap)
    zone = np.array(psnap.zone_id, copy=True)
    zone[3] = 5
    res.sync(cfg, snapshot_from_arrays(dict(fields, zone_id=zone)), 0)
    assert res.stats["scatters"] == 1 and res._dest_tables == tables
    zone[:] = 7  # every row: above SCATTER_FRAC, a wholesale re-place
    res.sync(cfg, snapshot_from_arrays(dict(fields, zone_id=zone)), 0)
    assert res.stats["replaces"] == 1 and res._dest_tables == tables
    _table_points_at_resident(res)
    zone[4] = 300
    res.sync(cfg, snapshot_from_arrays(dict(fields, zone_id=zone)), 0)
    assert res.stats["rebuilds"] == 2
    assert all(res._dest_tables[d] is not tables[d] for d in tables)
    _table_points_at_resident(res)
