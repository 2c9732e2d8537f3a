"""Registry of the port's device programs at representative shapes.

Every hot program the wave, scan and mesh drivers dispatch is rebuilt
here the way its driver builds it (the same device functions, the same
packed-buffer layouts, the same collect) against the small zoned
cluster and two-template backlog of _scenario, produced by the real
encoder. analysis/program_audit traces each one under fake CUDA tensors
to hold it to its contracts, so the registry never needs a card; on the
card chip_smoke.py runs the same programs for real (phase 15).

A program here is a dispatch, `fn(*args)`, which enqueues device work
and returns its outputs without a host sync, and a `collect(out)`, the
driver's device-to-host copy of the outputs that are not carry. The
output's leaves (tensors in tuples, lists and dicts; a Sharded tuple,
one logical array over the mesh's shards, is one leaf) start with
`carry_out_leaves` carry leaves, which stay on the device.

Deviation from kubernetes_tpu/analysis/programs.py <module>: the
programs are torch functions, not jitted XLA programs, so
  * sharding becomes placement: a mesh program declares, for each of
    its arguments that the mesh splits, the node axis of each field
    (parallel/resident carry_specs()/static_specs()), and the devices
    and node count of its shards (`placement`);
  * scatter forms are torch's (COMMUTATIVE_FORMS and the overwrite
    forms), not XLA primitives;
  * `collect` and `host_copies` are the port's: the JAX package counts
    host-bound output leaves, the port also counts its device-to-host
    copies, and where a driver ships several host-bound leaves in one
    copy (the zoned replay) the spec declares the copies it makes;
  * mesh_assign_auction has no counterpart (see _mesh_programs);
  * probe_pallas is K1's bf16 mode: the port's probe always takes K1,
    so the name that audits the JAX package's kernel build audits the
    kernel's other mode here.
_scenario is a verbatim copy (tests/test_torch_isolation.py
FUNCTION_COPIES); _assign_args too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

#: the scatter forms a program may declare: ("index_add_", dim),
#: ("scatter_add_", dim), ("index_put_acc", indexed dims), ("scatter_reduce_
#: <reduce>", dim) and ("index_fill_", dim) commute; the overwrite forms
#: ("index_copy_", dim), ("scatter_", dim), ("index_put_", indexed dims)
#: are order-dependent under colliding indices. Any form a program does
#: not declare is a finding.
COMMUTATIVE_FORMS = ("index_add_", "scatter_add_", "index_put_acc",
                     "scatter_reduce_sum", "scatter_reduce_prod",
                     "scatter_reduce_amax", "scatter_reduce_amin",
                     "index_fill_")


#: the scan's scatter forms: the commit and the zone counts
#: (index_add_), the class counts (an accumulating index_put_), and the
#: one-index overwrite of the chosen node's port and volume bitsets
#: (index_copy_, models/batch.py _scan_fn)
SCAN_SCATTERS = (("index_add_", 0), ("index_add_", 1), ("index_copy_", 0),
                 ("index_put_acc", (0, 1)))


#: the mesh programs' shards by default: four, each on its own device
#: (fake cuda:0..cuda:3 under the audit, so the placement rule can tell
#: the shards apart)
MESH_DEVICES = tuple(f"cuda:{i}" for i in range(4))


class Sharded(tuple):
    """One logical array over the mesh's shards: its tensor for each
    shard, in shard order (a leaf of a program's arguments or outputs)."""


def leaves(obj) -> List[Any]:
    """The leaves of a program's arguments or outputs, in order: tensors
    and host arrays in tuples, lists and dict values; a Sharded tuple is
    one leaf; None and Python scalars are none."""
    import torch

    if isinstance(obj, Sharded):
        return [obj]
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return [obj]
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in leaves(v)]
    if isinstance(obj, (tuple, list)):
        return [x for v in obj for x in leaves(v)]
    return []


def _to_host(out, carry_out_leaves: int):
    """The default collect: one copy each of the non-carry leaves."""
    return [leaf.cpu() for leaf in leaves(out)[carry_out_leaves:]]


@dataclass(frozen=True)
class Placement:
    """Where a mesh program's arguments lie: shard s of a split argument
    lies on devices[s], each node-axis field holding n_per_shard nodes
    on its declared axis (None: replicated, the whole table on every
    shard's device). args[i] declares argument i: a dict of field ->
    axis for a list of per-shard dicts, an axis for a Sharded leaf, or
    None for an argument the placement does not audit."""

    devices: Tuple[Any, ...]
    n_per_shard: int
    args: Tuple[Any, ...]


@dataclass(frozen=True)
class ProgramSpec:
    """One registered device program, ready to trace.

    ``carry_out_leaves`` — how many leading output leaves are the carry
    (device-resident across waves); the rest are host-bound per
    dispatch. ``expected_host_leaves`` is the transfer contract: the
    number of arrays this program may ship device->host per dispatch
    (None = unaudited); ``host_copies`` the device-to-host copies its
    collect makes for them, where fewer (None = one each).

    ``donate_argnums`` is the DONATION contract: the named args are
    resident-state tensors the program must update in place, each
    coming back in the same storage (``donated_leaves`` overrides the
    expected count; None = all leaves of the donated args).
    """

    name: str
    fn: Callable
    args: Tuple[Any, ...]
    allow_f64: bool = False
    carry_out_leaves: int = 0
    expected_host_leaves: Optional[int] = None
    donate_argnums: Tuple[int, ...] = ()
    donated_leaves: Optional[int] = None
    #: PLACEMENT contract (the sharding-drift audit): see Placement
    placement: Optional[Placement] = None
    #: SCATTER contract (scatter-contract audit): the (form, dims) the
    #: program may contain (COMMUTATIVE_FORMS and the overwrite forms).
    #: None = unaudited; any other form is a finding.
    scatter_allowed: Optional[Tuple[Tuple[str, Any], ...]] = None
    #: DTYPE contract (dtype-contract audit): static table name ->
    #: numpy dtype the program's matching input tensor must carry, for
    #: tables the quantized placement (parallel/quant) declares narrow;
    #: no node-axis narrow integer may be widened in the program except
    #: to feed an index.
    narrow_dtypes: Optional[Tuple[Tuple[str, str], ...]] = None
    notes: str = ""
    #: the driver's device-to-host copy of the outputs (None: one .cpu()
    #: of each host-bound leaf)
    collect: Optional[Callable] = None
    host_copies: Optional[int] = None

    def run_collect(self, out):
        if self.collect is not None:
            return self.collect(out)
        return _to_host(out, self.carry_out_leaves)


def _scenario():
    """A small zoned cluster + two-template backlog through the REAL
    encoder (the same row/vocab layout production snapshots have)."""
    from kubernetes_tpu_torch.api.types import (
        Container,
        Node,
        NodeCondition,
        NodeStatus,
        ObjectMeta,
        Pod,
        PodSpec,
    )
    from kubernetes_tpu_torch.oracle import ClusterState
    from kubernetes_tpu_torch.snapshot.encode import SnapshotEncoder

    zones = ["a", "b", "c"]
    nodes = [
        Node(
            metadata=ObjectMeta(
                name=f"audit-n{i:02d}",
                labels={
                    "kubernetes.io/hostname": f"audit-n{i:02d}",
                    "failure-domain.beta.kubernetes.io/zone": zones[i % 3],
                },
            ),
            status=NodeStatus(
                allocatable={"cpu": "8", "memory": "32Gi", "pods": "110"},
                conditions=[NodeCondition("Ready", "True")],
            ),
        )
        for i in range(13)  # non-pow2: exercises node padding
    ]
    existing = [
        Pod(
            metadata=ObjectMeta(name=f"audit-e{i}",
                                labels={"app": "web"}),
            spec=PodSpec(
                node_name=f"audit-n{i % 13:02d}",
                containers=[Container(requests={"cpu": "500m",
                                                "memory": "1Gi"})],
            ),
        )
        for i in range(6)
    ]

    def template(tag: str, cpu: str, n: int) -> List[Pod]:
        return [
            Pod(
                metadata=ObjectMeta(name=f"audit-{tag}-{i:03d}",
                                    labels={"app": tag}),
                spec=PodSpec(containers=[Container(
                    requests={"cpu": cpu, "memory": "200Mi"})]),
            )
            for i in range(n)
        ]

    pending = template("alpha", "100m", 24) + template("beta", "250m", 20)
    state = ClusterState.build(nodes, assigned_pods=existing)
    snap, batch = SnapshotEncoder(state, pending).encode()
    return snap, batch


def _uploaded(layout, buf_host: np.ndarray, device) -> dict:
    """A packed pod buffer shipped as the drivers ship it (models/pack.
    Packer.upload) and unpacked on the device."""
    from kubernetes_tpu_torch.models.pack import Packer, unpack

    return unpack(layout, Packer(device).upload(buf_host))


def build_programs(include_mesh: bool = True, device="cuda",
                   mesh_devices=None) -> List[ProgramSpec]:
    """Construct every registered program + its representative args on
    `device` (the mesh programs over mesh_devices: four shards, each on
    cuda:0..cuda:3 by default)."""
    import torch

    from kubernetes_tpu_torch.models.batch import (
        CARRY_FIELDS,
        BatchScheduler,
        SchedulerConfig,
        num_zones_of,
    )
    from kubernetes_tpu_torch.models.pack import pack_arrays
    from kubernetes_tpu_torch.models.probe import (
        WaveProbe,
        _group_probe_fn,
        _probe_fn,
    )
    from kubernetes_tpu_torch.models.wave import WaveScheduler, group_buffer
    from kubernetes_tpu_torch.models.zreplay import ZReplay
    from kubernetes_tpu_torch.snapshot.carry import place

    device = torch.device(device)
    config = SchedulerConfig()
    snap, batch = _scenario()
    N = snap.num_nodes
    num_zones = num_zones_of(snap)
    num_values = int(snap.svc_num_values)

    sched = BatchScheduler(config, device=device)
    static = sched.place_static(snap)
    carry = sched.initial_carry(snap)
    carry_leaves = len(CARRY_FIELDS)
    pods = {f: place(getattr(batch, f), device)
            for f in BatchScheduler.POD_FIELDS}

    rep = 0  # template-alpha row
    pod_host = {f: np.asarray(getattr(batch, f))[rep]
                for f in BatchScheduler.POD_FIELDS}
    layout, buf_host = pack_arrays(pod_host)
    pod = _uploaded(layout, buf_host, device)
    counts = torch.zeros((N,), dtype=torch.int64, device=device)

    wave = WaveScheduler(config, device=device)
    probe = WaveProbe(config, score_mode="i64")
    J = 128

    def scan(static_, carry_, pods_):
        return carry_, sched.run(static_, carry_, pods_, num_zones,
                                 num_values)

    def probe_program(wp):
        def run(static_, carry_, pod_):
            return _probe_fn(config, num_zones, num_values, J, static_,
                             carry_, pod_, score_mode=wp.score_mode)
        return run

    specs: List[ProgramSpec] = [
        ProgramSpec(
            name="scan",
            fn=scan,
            args=(static, carry, pods),
            allow_f64=True,  # reference-exact float64 score normalizers
            carry_out_leaves=carry_leaves,
            expected_host_leaves=1,  # chosen[P]
            # every accumulation is an index_add_ (the commit, the
            # zone counts) or an accumulating index_put_ (class counts);
            # the overwrite index_copy_ calls write ONE index (the chosen
            # node's port and volume bitsets): collision-free
            scatter_allowed=SCAN_SCATTERS,
            notes="the serial scan (models/batch._scan_fn, a Python loop "
                  "of steps); chosen ships once (batch.py schedule)",
        ),
        ProgramSpec(
            name="probe",
            fn=probe_program(probe),
            args=(static, carry, pod),
            carry_out_leaves=0,
            expected_host_leaves=1,  # ONE packed array
            notes="single-run packed probe (models/probe._probe_fn), "
                  "its resource section through K1",
        ),
        ProgramSpec(
            name="probe_pallas",
            fn=probe_program(WaveProbe(config, score_mode="bf16")),
            args=(static, carry, pod),
            carry_out_leaves=0,
            expected_host_leaves=1,
            notes="the probe through K1's bf16 mode (the "
                  "KUBERNETES_TPU_QUANT=bf16 profile): the port's probe "
                  "always takes K1, so this name audits its other mode",
        ),
    ]

    # quantized placements (parallel/quant): the probe traced against
    # narrowed static node tables at BOTH narrow widths, with the dtype
    # contract asserting the tables arrive narrow and are never widened
    # in-program
    from kubernetes_tpu_torch.parallel import quant as _quant

    for qdt in (np.int8, np.int16):
        qstatic = dict(static)
        decl = []
        for f in _quant.NARROWABLE:
            host_f = np.asarray(getattr(snap, f))
            nat = _quant.narrow_dtype(f, host_f)
            dt = np.dtype(qdt) if np.dtype(qdt).itemsize >= nat.itemsize \
                else nat
            qstatic[f] = torch.from_numpy(
                np.ascontiguousarray(host_f.astype(dt))).to(device)
            decl.append((f, dt.str))
        specs.append(ProgramSpec(
            name=f"probe_quant_{np.dtype(qdt).name}",
            fn=probe_program(probe),
            args=(qstatic, carry, pod),
            carry_out_leaves=0,
            expected_host_leaves=1,
            narrow_dtypes=tuple(decl),
            notes="probe against quantized node tables "
                  f"({np.dtype(qdt).name} placement): decisions "
                  "bit-identical, tables never widened in-program",
        ))

    def fused_same(static_, carry_, pod_, counts_):
        return probe.probe_fused_dispatch(static_, carry_, pod_, counts_,
                                          pod_, num_zones, num_values, J,
                                          wave._apply_fn)

    def fused_collect(out):
        host, done = out[1]
        if done is not None:
            done.synchronize()
        return [host]

    specs.append(ProgramSpec(
        name="probe_fused_same",
        fn=fused_same,
        args=(static, carry, pod, counts),
        carry_out_leaves=carry_leaves,
        expected_host_leaves=1,
        scatter_allowed=(("index_add_", 1),),
        collect=fused_collect,
        notes="fold-own-commits + re-probe, one dispatch: the product's "
              "copy into pinned memory starts in the dispatch and the "
              "collect waits for it (probe_fused_dispatch/_collect)",
    ))

    # G=16 is the GANG-shaped grouped probe: the gang driver routes a
    # wave's all-or-nothing spans through this same builder (a gang is
    # a run group), so the gang path's transfer contract is audited at
    # its bench shape alongside the template shapes
    for G in (8, 16, 32):
        reps = [0, 24] * (G // 2)  # alternate the two templates
        G_bucket, glayout, gbuf_host = group_buffer(batch, reps[:G])
        gpods = _uploaded(glayout, gbuf_host, device)

        def group_probe(static_, carry_, pods_, _G=G):
            return carry_, _group_probe_fn(config, num_zones, num_values,
                                           _G, static_, carry_, pods_)

        specs.append(ProgramSpec(
            name=f"group_probe_G{G_bucket}",
            fn=group_probe,
            args=(static, carry, gpods),
            carry_out_leaves=carry_leaves,
            expected_host_leaves=1,  # headers+usage CONCATENATED
            notes="grouped header probe (models/probe._group_probe_fn, "
                  "WaveProbe.probe_group): transfer count independent "
                  "of the template count G",
        ))
        if G == 8:
            gcounts = torch.zeros((G_bucket, N), dtype=torch.int64,
                                  device=device)
            specs.append(ProgramSpec(
                name="apply_group",
                fn=wave._apply_group_fn,
                args=(static, carry, gpods, gcounts),
                carry_out_leaves=carry_leaves,
                expected_host_leaves=0,  # the fold is carry-only
                scatter_allowed=(("index_add_", 1),),
                notes="grouped commit fold (wave._apply_group_fn)",
            ))

    specs.append(ProgramSpec(
        name="apply",
        fn=wave._apply_fn,
        args=(static, carry, pod, counts),
        carry_out_leaves=carry_leaves,
        expected_host_leaves=0,
        scatter_allowed=(("index_add_", 1),),
        notes="single-run commit fold (wave._apply_fn, unpacked row)",
    ))

    # zoned device replay: single-run and grouped (K3)
    perm = np.asarray(snap.name_desc_order).astype(np.int64)
    zone_perm = torch.from_numpy(np.ascontiguousarray(
        np.asarray(snap.zone_id)[perm], np.int32)).to(device)
    veto_perm = torch.zeros((N,), dtype=torch.bool, device=device)
    K = 64
    zr = ZReplay(config, wave._apply_fn, wave._apply_group_fn)

    def zreplay(static_, carry_, pod_, zone_perm_, veto_perm_):
        return zr.dispatch(static_, carry_, None, None, pod_, num_zones,
                           num_values, J, K, zone_perm_, veto_perm_, True,
                           32, K, 0)

    specs.append(ProgramSpec(
        name="zreplay",
        fn=zreplay,
        args=(static, carry, pod, zone_perm, veto_perm),
        allow_f64=True,  # mirrors replay._scores float64 exactly
        carry_out_leaves=carry_leaves,
        expected_host_leaves=4,  # chosen, counts, L, n_done
        collect=lambda out: zr.collect(out[1], out[3], out[4]),
        host_copies=1,  # chosen, L, n_done in one copy; counts stays
        notes="zoned-spread device replay (models/zreplay.ZReplay."
              "dispatch, K3); its collect ships chosen, L and n_done in "
              "ONE copy, and the folded counts not at all",
    ))
    Gz = 8
    reps = [0, 24] * (Gz // 2)
    Gz_bucket, gzlayout, gzbuf_host = group_buffer(batch, reps)
    gzpods = _uploaded(gzlayout, gzbuf_host, device)
    vetos = torch.zeros((Gz_bucket, N), dtype=torch.bool, device=device)

    def zreplay_group(static_, carry_, pods_, zone_perm_, vetos_):
        return zr.dispatch_group(
            static_, carry_, None, pods_, Gz_bucket, num_zones, num_values,
            J, K, zone_perm_, vetos_, np.ones(Gz_bucket, bool),
            np.full(Gz_bucket, 32, np.int64),
            np.full(Gz_bucket, K, np.int64), 0)

    specs.append(ProgramSpec(
        name="zreplay_group",
        fn=zreplay_group,
        args=(static, carry, gzpods, zone_perm, vetos),
        allow_f64=True,
        carry_out_leaves=carry_leaves,
        expected_host_leaves=3,  # chosen[G,K], n_done[G], L
        collect=lambda out: zr.collect(*out[1:]),
        host_copies=1,
        notes="grouped zoned device replay (ZReplay.dispatch_group): G "
              "runs, one dispatch, one copy",
    ))

    # gang preemption: the victim-selection scorer K6 (ops/preempt_kernel
    # .victim_score, VictimScorer.score's dispatch). Integer-only; ships
    # exactly 3 host-bound arrays (victims_needed, cost, eviction order)
    from kubernetes_tpu_torch.ops.preempt import pack_candidates
    from kubernetes_tpu_torch.ops.preempt_kernel import victim_score

    cand = [
        (snap.node_names[i % 13], i % 3, i, (500, 1 << 20, 0, 1))
        for i in range(9)
    ]
    vprio, vord, vres, _idx = pack_candidates(
        [n for n in snap.node_names if n], cand,
        floor_nodes=16, floor_cands=8,
    )
    vfree = np.zeros((vprio.shape[0], 4), np.int64)
    vreq = np.array([1000, 2 << 20, 0, 1], np.int64)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    specs.append(ProgramSpec(
        name="victim_score",
        fn=lambda *a: victim_score(*a, 10),
        args=(put(vprio), put(vord), put(vres), put(vfree), put(vreq)),
        carry_out_leaves=0,
        expected_host_leaves=3,
        notes="gang preemption victim scorer K6 (ops/preempt_kernel): "
              "lowest-priority-first / fewest-victims / newest-first",
    ))

    # optimizing profile: the joint-assignment solvers K7. Integer-only,
    # scatter-free, and ONE host-bound array per dispatch — the
    # O(1)-dispatches-per-wave budget the profile claims is this
    # transfer contract
    specs.extend(_assign_programs(N, device))

    if include_mesh:
        specs.extend(_mesh_programs(config, snap, batch, carry_leaves,
                                    mesh_devices))
    return specs


def _assign_args(N: int, P: int = 16):
    """Representative solver operands over an N-node cluster: P slots,
    two complementary request shapes (the packing case the profile
    exists for)."""
    rng = np.random.RandomState(7)
    fit = np.ones((P, N), bool)
    fit[:, N - 1] = False  # one unschedulable (padded-like) node
    score = rng.randint(0, 20, size=(P, N)).astype(np.int64)
    req = np.zeros((P, 4), np.int64)
    req[:, 0] = np.where(np.arange(P) % 2 == 0, 1000, 3000)
    req[:, 1] = np.int64(1) << 30
    req[:, 3] = 1
    commit = req.copy()
    check = np.ones((P, 4), bool)
    cap = np.zeros((N, 4), np.int64)
    cap[:, 0] = 4000
    cap[:, 1] = np.int64(32) << 30
    cap[:, 3] = 110
    prio = np.zeros(P, np.int32)
    order = np.arange(P, dtype=np.int32)
    return fit, score, req, commit, check, cap, prio, order


def _assign_programs(N: int, device) -> List[ProgramSpec]:
    import torch

    from kubernetes_tpu_torch.scheduler.optimizer.ops.assign import (
        auction_rounds,
    )
    from kubernetes_tpu_torch.scheduler.optimizer.ops.assign_kernel import (
        auction_assign,
        beam_assign,
    )

    P = 16
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in _assign_args(N, P)]
    rounds = auction_rounds(P, N)
    return [
        ProgramSpec(
            name="assign_auction",
            fn=lambda *a: auction_assign(*a, 8, rounds),
            args=tuple(args),
            carry_out_leaves=0,
            expected_host_leaves=1,  # owner[P]
            scatter_allowed=(),  # scatter-free: one-hot winner max
            notes="optimizing-profile auction solver K7a: its rounds in "
                  "one cooperative launch",
        ),
        ProgramSpec(
            name="assign_beam",
            fn=beam_assign,
            args=tuple(args[:6]),
            carry_out_leaves=0,
            expected_host_leaves=1,  # owner[P]
            scatter_allowed=(),
            notes="optimizing-profile top-K beam solver K7b (small "
                  "waves): one launch",
        ),
    ]


def _mesh_programs(config, snap, batch, carry_leaves,
                   mesh_devices=None) -> List[ProgramSpec]:
    """The mesh drivers' programs (parallel/mesh, parallel/resident) on
    a DeviceMesh of mesh_devices, over the resident placement
    (place_tables, ResidentClusterState).

    The JAX registry's mesh_assign_auction (a pjit of the auction over
    the node axis) has no counterpart: no JAX driver dispatches it (the
    daemon's mesh path keeps the optimizing profile on one device,
    scheduler/tpu_algorithm.py), and the port has no sharded auction;
    ROADMAP.md queues it."""
    from kubernetes_tpu_torch.models.batch import CARRY_FIELDS as BC
    from kubernetes_tpu_torch.models.batch import BatchScheduler
    from kubernetes_tpu_torch.models.pack import pack_arrays
    from kubernetes_tpu_torch.models.wave import group_buffer
    from kubernetes_tpu_torch.parallel import mesh as M
    from kubernetes_tpu_torch.parallel.resident import (
        carry_specs,
        host_carry,
        host_static,
        place_tables,
        static_specs,
        upload,
    )
    from kubernetes_tpu_torch.parallel.shard import DeviceMesh
    from kubernetes_tpu_torch.snapshot.pad import pad_snapshot

    mesh = DeviceMesh(list(mesh_devices or MESH_DEVICES))
    n_dev = mesh.size
    snap_p = pad_snapshot(snap, n_dev)
    n = len(snap_p.node_names)
    n_per_shard = n // n_dev
    num_zones = max(int(snap_p.zone_id.max()) + 1, 1)
    num_values = int(snap_p.svc_num_values)

    hs = host_static(config, snap_p)
    statics, carries = place_tables(mesh, hs, host_carry(snap_p, 0))
    pods_host = {f: np.asarray(getattr(batch, f))
                 for f in BatchScheduler.POD_FIELDS}
    J = 128
    wave = M.MeshWaveScheduler(mesh, config=config)

    sspec = static_specs(hs.keys())
    cspec = dict(zip(BC, carry_specs()))
    split = (sspec, cspec)

    def placement(*more):
        return Placement(tuple(mesh.devices), n_per_shard, split + more)

    def sharded_carry(carries_):
        return tuple(Sharded(c[k] for c in carries_) for k in BC)

    def rows_on_mesh(layout, buf_host):
        return M._shard_rows(mesh, layout,
                             {d: upload(buf_host, d)
                              for d in mesh.distinct_devices()})

    counts = np.zeros(n, np.int64)
    counts[: min(3, n)] = 2
    touch_idx, touch_cnt = M._sparse_counts(counts, floor=64)
    layout, pod_buf = pack_arrays(
        {f: v[0] for f, v in pods_host.items()})
    pod_rows = rows_on_mesh(layout, pod_buf)

    def mesh_scan(statics_, carries_, pods_):
        chosen = wave.scan._dispatch(statics_, carries_, pods_, n,
                                     n_per_shard, num_zones, num_values,
                                     batch.num_pods)
        return sharded_carry(carries_), chosen

    def mesh_probe(statics_, carries_, rows_):
        return Sharded(
            M._mesh_probe_fn(config, num_zones, num_values, J, n_per_shard,
                             n, s, statics_[s], carries_[s], rows_[s])
            for s in range(mesh.size))

    def gather(out):
        parts = leaves(out)[-1]
        return [wave._gather_host(list(parts))]

    def mesh_apply(statics_, carries_, rows_, idx_, cnt_):
        M._mesh_apply_fn(config, n, mesh, statics_, carries_, rows_,
                         idx_, cnt_)
        return sharded_carry(carries_)

    specs: List[ProgramSpec] = [
        ProgramSpec(
            name="mesh_scan",
            fn=mesh_scan,
            args=(statics, carries, pods_host),
            allow_f64=True,
            carry_out_leaves=carry_leaves,
            expected_host_leaves=1,
            placement=placement(None),
            scatter_allowed=SCAN_SCATTERS,
            notes="sharded scan (MeshBatchScheduler._dispatch); chosen "
                  "ships once (_exec)",
        ),
        ProgramSpec(
            name="mesh_probe",
            fn=mesh_probe,
            args=(statics, carries, pod_rows),
            carry_out_leaves=0,
            expected_host_leaves=1,
            placement=placement(None),
            collect=gather,
            notes="sharded single-run probe (MeshWaveScheduler._probe_run"
                  "): the shards' products gathered in one copy",
        ),
        ProgramSpec(
            name="mesh_apply",
            fn=mesh_apply,
            args=(statics, carries, pod_rows,
                  M._replicate(mesh, touch_idx),
                  M._replicate(mesh, touch_cnt)),
            carry_out_leaves=carry_leaves,
            expected_host_leaves=0,
            donate_argnums=(1,),
            placement=placement(None, None, None),
            scatter_allowed=(("index_add_", 0), ("index_add_", 1)),
            notes="sharded commit fold, scatter-form counts "
                  "(O(picks) shipment), resident carry in place",
        ),
    ]
    G_bucket, glayout, gbuf_host = group_buffer(batch, [0, 24, 0, 24])
    grows = rows_on_mesh(glayout, gbuf_host)
    gcounts = np.zeros((G_bucket, n), np.int64)
    gcounts[0, : min(3, n)] = 1
    g_idx, g_cnt = M._sparse_group_counts(gcounts, floor=64)

    def mesh_group_probe(statics_, carries_, rows_):
        return Sharded(
            M._mesh_group_probe_fn(config, num_zones, num_values, G_bucket,
                                   n_per_shard, n, s, statics_[s],
                                   carries_[s], rows_[s])
            for s in range(mesh.size))

    def mesh_apply_group(statics_, carries_, rows_, idx_, cnt_):
        M._mesh_apply_group_fn(config, n, mesh, statics_, carries_, rows_,
                               idx_, cnt_)
        return sharded_carry(carries_)

    specs.append(ProgramSpec(
        name="mesh_group_probe",
        fn=mesh_group_probe,
        args=(statics, carries, grows),
        carry_out_leaves=0,
        expected_host_leaves=1,
        placement=placement(None),
        collect=gather,
        notes="sharded grouped header probe: ONE host-bound array "
              "(usage block no longer ships — resident mirror)",
    ))
    specs.append(ProgramSpec(
        name="mesh_apply_group",
        fn=mesh_apply_group,
        args=(statics, carries, grows, M._replicate(mesh, g_idx),
              M._replicate(mesh, g_cnt)),
        carry_out_leaves=carry_leaves,
        expected_host_leaves=0,
        donate_argnums=(1,),
        placement=placement(None, None, None),
        scatter_allowed=(("index_put_acc", (0, 1)), ("index_add_", 1)),
        notes="sharded grouped commit fold, scatter-form counts, "
              "resident carry in place",
    ))
    specs.append(_resident_scatter_program(mesh, config, snap_p, n,
                                           n_per_shard))
    return specs


def _resident_scatter_program(mesh, config, snap_p, n,
                              n_per_shard) -> ProgramSpec:
    """The resident-state row-scatter update (node add/remove inside
    the padded bucket), as ResidentClusterState._scatter runs it: the
    changed rows of three fields packed in one buffer, one upload a
    distinct device, and K8 (parallel/resident_kernel.scatter_shipment)
    writing them into the resident tensors in place."""
    from kubernetes_tpu_torch.parallel.resident import (
        ResidentClusterState,
        carry_specs,
        host_carry,
        host_static,
        static_specs,
    )
    from kubernetes_tpu_torch.parallel.resident import CARRY_FIELDS as RC

    res = ResidentClusterState(mesh)
    res.sync(config, snap_p, 0)
    hs = host_static(config, snap_p)
    hc = host_carry(snap_p, 0)
    fields = [
        ("alloc_mcpu", hs["alloc_mcpu"], 0),
        ("label_kv", hs["label_kv"], 0),
        ("__res__", hc["__res__"], 1),
    ]
    rows = np.arange(min(3, n), dtype=np.int64)
    arrays = tuple(Sharded(res._tensors(f)) for f, _h, _ax in fields)
    sspec = static_specs(hs.keys())
    cspec = dict(zip(RC, carry_specs()))
    axes = tuple(cspec[f] if f in RC else sspec[f] for f, _h, _ax in fields)

    def scatter(arrays_, fields_):
        res._scatter(fields_, rows)
        return arrays_

    return ProgramSpec(
        name="resident_scatter",
        fn=scatter,
        args=(arrays, fields),
        carry_out_leaves=len(arrays),
        expected_host_leaves=0,
        donate_argnums=(0,),
        placement=Placement(tuple(mesh.devices), n_per_shard,
                            (axes, None)),
        scatter_allowed=(),  # K8 writes the rows; no torch scatter
        notes="resident node add/remove row scatter (K8): in-place "
              "update, O(changed rows) shipment",
    )
