"""Device-resident sharded cluster state for the mesh schedulers.

PyTorch counterpart of kubernetes_tpu/parallel/resident.py. The mesh
wave driver's node tables live on the mesh's devices across waves:

* Placement: every node-axis table is placed once, shard by shard (the
  shard's slice of the node axis on the shard's device, parallel/shard);
  vocab and count tables are replicated, once per distinct device. A
  table takes the port's placement rule (snapshot/carry.place: integers
  as int64, bool and float as they are), and a declared-narrow static
  table its parallel/quant width (int8/int16); the placed dtype is part
  of the topology signature, so a value outgrowing its narrow range
  rebuilds the table wider.
* Mirrors: a host numpy mirror of each resident table. The wave driver's
  commits fold into the mirrors with the device fold's integer
  arithmetic (note_commit, note_scan), so "did the cluster change under
  us?" is a host array_equal against the fresh snapshot. Carry blocks
  the host cannot mirror (interpod, volume and service tables touched by
  impure runs or the scan) are invalidated and resynced from the next
  snapshot.
* Scatter updates: a node add, remove or update inside the padded node
  bucket ships only the changed rows, in one packed buffer, which the
  row scatter K8 (parallel/resident_kernel.scatter_shipment; its plain
  version on the CPU) writes into the resident tensors: one launch for
  each distinct device holding a shard that owns a changed row, every
  such shard and every field in it. Each distinct device keeps a table
  of its node-axis tensors' pointers on the device (resident_kernel.
  DestTable), built when the tables are placed. A full rebuild happens
  only on topology change.
* In place: the folds, the scatter and a re-placed field update the
  resident tensors in place (copy_ into the same storage), the
  counterpart of the JAX package's donation; `stats` counts every
  host-to-device byte, as there, save one the JAX package has no
  counterpart of: the destination tables' copy at each placement (node-
  axis fields x the mesh's shards x 8 bytes a distinct device).

Deviation from kubernetes_tpu/parallel/resident.py <module>: the
PartitionSpecs of carry_specs/static_specs become the node-axis index of
each field (None = replicated), _node_axis and the pjit scatter program
(_scatter_fn, _scatter_program) have no counterpart (K8 takes their
place), and KUBERNETES_TPU_MESH_DONATE and mesh.runtime_donation() have
no meaning here: nothing is donated, so nothing is aliased, and `_alive`
reduces to "a carry is held". AXIS, CARRY_FIELDS, CARRY_BLOCKS,
host_static, host_carry and the mirror maintenance are verbatim copies
(tests/test_torch_isolation.py FUNCTION_COPIES).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.models.batch import CARRY_FIELDS as _BATCH_CARRY
from kubernetes_tpu_torch.models.pack import Packer
from kubernetes_tpu_torch.parallel import resident_kernel as RK
from kubernetes_tpu_torch.parallel.shard import DeviceMesh, shard_slice
from kubernetes_tpu_torch.snapshot.carry import place

AXIS = "nodes"

#: carry leaf order — matches models/batch.BatchScheduler.initial_carry
CARRY_FIELDS = (
    "__res__", "port_mask", "class_count", "__last__",
    "ip_term_count", "ip_own_anti", "ip_rev_hard", "ip_rev_pref",
    "ip_rev_anti", "ip_spec_total",
    "vol_any", "vol_rw", "ebs_mask", "gce_mask",
    "svc_first_peer", "svc_peer_node_count", "svc_peer_total",
)

#: carry fields that invalidate together when a device fold the host
#: cannot mirror touches them (impure runs, the scan fallback)
CARRY_BLOCKS = {
    "ip": ("ip_term_count", "ip_own_anti", "ip_rev_hard", "ip_rev_pref",
           "ip_rev_anti", "ip_spec_total"),
    "vol": ("vol_any", "vol_rw", "ebs_mask", "gce_mask"),
    "svc": ("svc_first_peer", "svc_peer_node_count", "svc_peer_total"),
}

_PURE_CARRY = ("__res__", "port_mask", "class_count", "__last__")


def carry_specs():
    """The node axis of each carry leaf, None where it is replicated (the
    JAX package's PartitionSpecs, parallel/resident.py:75-91)."""
    return (
        # stacked resources: node axis is axis 1
        1, 0, 0, None,
        # interpod count tables: replicated (domain-indexed, not node)
        None, None, None, None, None, None,
        # volume masks: node-axis sharded
        0, 0, 0, 0,
        # service-group tables: replicated (small: groups x labels);
        # every distinct device applies identical commits
        None, None, None,
    )


#: static snapshot fields sharded along their first (node) axis
_STATIC_SHARDED_1D = frozenset((
    "alloc_mcpu", "alloc_mem", "alloc_gpu", "alloc_pods",
    "has_taints", "taint_bad", "mem_pressure", "zone_id",
    "ebs_bad", "gce_bad", "vz_zone", "vz_region", "vz_has",
))
#: static snapshot fields sharded along axis 0 with trailing vocab axes
_STATIC_SHARDED_2D = frozenset((
    "label_kv", "label_key", "numval", "taint_mask", "taint_count",
    "img_size",
))


def static_specs(keys) -> dict:
    """The node axis of each static snapshot field (node tables sharded
    on axis 0, vocab/order tables replicated: None; nl_* are
    config-resolved node masks)."""
    out = {}
    for k in keys:
        if (k in _STATIC_SHARDED_1D or k.startswith("nl_")
                or k in _STATIC_SHARDED_2D):
            out[k] = 0
        else:
            out[k] = None  # replicated vocab tables + global order
    return out


def host_static(config, snap) -> Dict[str, np.ndarray]:
    """The full static dict the mesh programs consume, as HOST arrays
    (snapshot fields + config-resolved node-label masks, with the
    selection order under its mesh-global name)."""
    from kubernetes_tpu_torch.models.batch import BatchScheduler

    out = {f: np.asarray(getattr(snap, f))
           for f in BatchScheduler.STATIC_FIELDS}
    out.update(BatchScheduler.config_static(config, snap))
    out["name_desc_order_global"] = out.pop("name_desc_order")
    return out


def host_carry(snap, last_node_index: int) -> Dict[str, np.ndarray]:
    """The carry's seed values as HOST arrays, keyed by CARRY_FIELDS
    (__res__ is the stacked resource block, __last__ the round-robin
    counter)."""
    from kubernetes_tpu_torch.snapshot.encode import RES_CARRY_FIELDS

    out = {"__res__": np.stack([np.asarray(getattr(snap, f))
                                for f in RES_CARRY_FIELDS]),
           "__last__": np.int64(last_node_index)}
    for f in CARRY_FIELDS:
        if f not in ("__res__", "__last__"):
            out[f] = np.asarray(getattr(snap, f))
    return out


def _eq(a: np.ndarray, b: np.ndarray) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind == "f":
        return bool(np.array_equal(a, b, equal_nan=True))
    return bool(np.array_equal(a, b))


def _placed_tensor(arr: np.ndarray, device, narrow: bool) -> torch.Tensor:
    """One host array -> a fresh tensor on `device`: at its own narrow
    dtype when `narrow`, else by snapshot/carry.place."""
    if narrow:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return place(arr, device)


def place_field(mesh: DeviceMesh, arr, ax: Optional[int],
                narrow: bool = False) -> List[torch.Tensor]:
    """A host table on the mesh -> its tensor for each shard: the shard's
    slice of node axis `ax` on its device, or (ax None) one replicated
    copy a distinct device, shared by that device's shards."""
    arr = np.asarray(arr)
    if ax is None:
        copies = {d: _placed_tensor(arr, d, narrow)
                  for d in mesh.distinct_devices()}
        return [copies[d] for d in mesh.devices]
    n = arr.shape[ax] // mesh.size
    out = []
    for s, d in enumerate(mesh.devices):
        window = [slice(None)] * arr.ndim
        window[ax] = shard_slice(s, n)
        out.append(_placed_tensor(arr[tuple(window)], d, narrow))
    return out


def shard_views(mesh: DeviceMesh, static: Dict[str, list],
                carry: Dict[str, list]) -> Tuple[list, list]:
    """Per-field shard lists -> (static dict a shard, carry dict a shard);
    the carry dicts take models/batch's keys ("res", ..., "last_idx")."""
    statics = [{k: v[s] for k, v in static.items()}
               for s in range(mesh.size)]
    carries = [{b: carry[r][s] for r, b in zip(CARRY_FIELDS, _BATCH_CARRY)}
               for s in range(mesh.size)]
    return statics, carries


def place_tables(mesh: DeviceMesh, hs: dict, hc: dict):
    """Host static and carry dicts -> shard_views of their placement at
    the port's rule, nothing narrowed (the standalone mesh scan's
    tables)."""
    sspec = static_specs(hs.keys())
    cspec = dict(zip(CARRY_FIELDS, carry_specs()))
    static = {k: place_field(mesh, v, sspec[k]) for k, v in hs.items()}
    carry = {f: place_field(mesh, hc[f], cspec[f]) for f in CARRY_FIELDS}
    return shard_views(mesh, static, carry)


def upload(buf: np.ndarray, device) -> torch.Tensor:
    """A packed host buffer -> a uint8 tensor on `device` (one
    non_blocking copy from pinned memory on CUDA, models/pack.Packer)."""
    return Packer(device).upload(buf)


class ResidentClusterState:
    """Owns the mesh's resident sharded tensors + their host mirrors.

    One instance per MeshWaveScheduler. ``sync`` is the per-wave entry:
    it returns the shards' (static, carry) dicts, reusing the resident
    tensors wherever the snapshot proves nothing changed, scattering
    changed rows, and rebuilding only on topology change. The driver
    reports its commits through ``note_*`` so the mirrors stay exact.

    Deviation from kubernetes_tpu/parallel/resident.py
    ResidentClusterState: its tensors are updated in place (the folds,
    the row scatter K8, copy_ of a re-placed field) where the JAX
    package donates and re-binds jax arrays, so nothing is ever donated
    away: `_alive` is "a carry is held", set_carry has no counterpart,
    finish_wave takes the round-robin counter alone, and
    KUBERNETES_TPU_MESH_DONATE has no meaning. The placement is per shard
    on the mesh's devices (parallel/shard), replicated tables once a
    distinct device.
    """

    #: changed-row fraction above which a field re-places wholesale
    #: instead of scattering (the packed-row shipment would approach the
    #: full table anyway)
    SCATTER_FRAC = 0.25

    def __init__(self, mesh: DeviceMesh, quant_mode: Optional[str] = None):
        from kubernetes_tpu_torch.analysis import races as _races
        from kubernetes_tpu_torch.parallel import quant as _quant

        self.mesh = mesh
        # quantized placement (parallel/quant): declared-narrow STATIC
        # node tables place at their audited width; carry leaves stay
        # full width (the device folds accumulate into them)
        self._quant = _quant
        self._quant_mode = (_quant.mode() if quant_mode is None
                            else quant_mode)
        self._key = None  # topology signature (shapes/dtypes/field set)
        # field -> its tensor for each shard
        self._static: Dict[str, List[torch.Tensor]] = {}
        self._carry: Optional[Dict[str, List[torch.Tensor]]] = None
        self._m_static: Dict[str, np.ndarray] = {}
        self._m_carry: Dict[str, np.ndarray] = {}
        self._last: int = 0
        self._valid = {b: True for b in CARRY_BLOCKS}
        # distinct device -> its K8 destination table (_place_all)
        self._dest_tables: Dict[torch.device, RK.DestTable] = {}
        self.stats = {
            "rebuilds": 0, "scatters": 0, "replaces": 0, "waves": 0,
            "h2d_bytes_total": 0, "wave_h2d_bytes": 0,
            "wave_table_bytes": 0,
        }
        # the resident mirrors are wave-driver-private state
        _races.track(self, "parallel.ResidentClusterState")

    # -- accounting ----------------------------------------------------------

    def begin_wave(self) -> None:
        self.stats["waves"] += 1
        self.stats["wave_h2d_bytes"] = 0
        self.stats["wave_table_bytes"] = 0

    def count_h2d(self, nbytes: int, table: bool = False) -> None:
        self.stats["h2d_bytes_total"] += int(nbytes)
        self.stats["wave_h2d_bytes"] += int(nbytes)
        if table:
            self.stats["wave_table_bytes"] += int(nbytes)

    # -- sync ----------------------------------------------------------------

    def _placed_dtype(self, f: str, arr: np.ndarray) -> np.dtype:
        """Device-placement dtype for a field: the quant width audit
        for declared-narrow static tables, the host dtype otherwise."""
        if f in CARRY_FIELDS or not self._quant.narrow_enabled(
                self._quant_mode):
            return arr.dtype
        return self._quant.narrow_dtype(f, arr)

    def _placed(self, f: str, arr: np.ndarray) -> np.ndarray:
        dt = self._placed_dtype(f, arr)
        return arr.astype(dt, copy=False) if dt != arr.dtype else arr

    def _narrow(self, f: str, arr: np.ndarray) -> bool:
        """Whether field f keeps its narrowed dtype on the device (an
        int8/int16 table of parallel/quant.NARROWABLE), as the wave
        driver's WaveScheduler._placement decides."""
        dt = self._placed_dtype(f, arr)
        return (f not in CARRY_FIELDS and f in self._quant.NARROWABLE
                and self._quant.narrow_enabled(self._quant_mode)
                and dt.kind == "i" and dt.itemsize <= 2)

    def _signature(self, hs: dict, hc: dict):
        return tuple(sorted(
            (name, a.shape, a.dtype.str,
             self._placed_dtype(name, a).str)
            for name, a in list(hs.items()) + list(hc.items())
            if isinstance(a, np.ndarray)
        ))

    def _alive(self) -> bool:
        return self._carry is not None

    def views(self) -> Tuple[list, list]:
        """The shards' (static dict, carry dict) over the resident
        tensors (parallel/resident.shard_views)."""
        return shard_views(self.mesh, self._static, self._carry)

    def sync(self, config, snap, last_node_index: int,
             reuse: str = "auto"):
        """-> (static dict a shard, carry dict a shard) for this wave.

        reuse: "auto"  — mirror-compare against the snapshot (daemon
                         path: trusts nothing, ships only deltas);
               "carry" — trust the resident carry outright (loops whose
                         snapshot is the stale wave-0 view);
               "reship" — force a full re-placement (the A/B baseline).
        """
        hs = host_static(config, snap)
        hc = host_carry(snap, last_node_index)
        key = self._signature(hs, hc)
        if reuse == "carry" and self._alive() and key == self._key:
            self._set_last(last_node_index)
            return self.views()
        if reuse == "reship" or key != self._key or not self._alive():
            self._place_all(hs, hc, key)
            return self.views()
        self._diff_sync(hs, hc)
        self._set_last(int(last_node_index))
        return self.views()

    def _specs(self, static_keys):
        sspec = static_specs(static_keys)
        cspec = dict(zip(CARRY_FIELDS, carry_specs()))
        return sspec, cspec

    def _place_all(self, hs: dict, hc: dict, key) -> None:
        self.stats["rebuilds"] += 1
        sspec, cspec = self._specs(hs.keys())
        # static tables place at their audited (possibly narrow) width;
        # mirrors below keep the full-width host arrays
        placed = {n: self._placed(n, hs[n]) for n in hs}
        self._static = {
            n: place_field(self.mesh, placed[n], sspec[n],
                           self._narrow(n, hs[n]))
            for n in hs
        }
        self._carry = {f: place_field(self.mesh, hc[f], cspec[f])
                       for f in CARRY_FIELDS}
        self._m_static = {k: np.array(v, copy=True) for k, v in hs.items()}
        self._m_carry = {
            f: (np.array(hc[f], copy=True)
                if isinstance(hc[f], np.ndarray) else hc[f])
            for f in CARRY_FIELDS if f != "__last__"
        }
        self._last = int(hc["__last__"])
        self._valid = {b: True for b in CARRY_BLOCKS}
        self._key = key
        self._dest_tables = self._build_dest_tables(sspec, cspec)
        for a in list(placed.values()) + [hc[f] for f in CARRY_FIELDS]:
            self.count_h2d(np.asarray(a).nbytes, table=True)

    def _build_dest_tables(self, sspec: dict, cspec: dict) -> dict:
        """A K8 destination table for each distinct device over every
        node-axis field of every shard on it. Only a placement makes new
        tensors: the folds, the scatter and _rewrite write into them, so
        the tables stay right until the next _place_all."""
        sharded = {f: ts for f, ts in self._static.items()
                   if sspec[f] is not None}
        sharded.update((f, self._carry[f]) for f in CARRY_FIELDS
                       if cspec[f] is not None)
        return {d: RK.DestTable(d, self.mesh.size, {
            f: {s: ts[s] for s, sd in enumerate(self.mesh.devices)
                if sd == d} for f, ts in sharded.items()})
            for d in self.mesh.distinct_devices()}

    def _block_of(self, field: str) -> Optional[str]:
        for b, members in CARRY_BLOCKS.items():
            if field in members:
                return b
        return None

    def _diff_sync(self, hs: dict, hc: dict) -> None:
        sspec, cspec = self._specs(hs.keys())
        changed_static = [
            f for f in hs if not _eq(hs[f], self._m_static[f])
        ]
        changed_carry = []
        for f in CARRY_FIELDS:
            if f == "__last__":
                continue
            blk = self._block_of(f)
            if blk is not None and not self._valid[blk]:
                changed_carry.append(f)
            elif not _eq(hc[f], self._m_carry[f]):
                changed_carry.append(f)
        # breadcrumb for transfer forensics: WHAT forced bytes this wave
        self.stats["last_changed"] = tuple(changed_static + changed_carry)
        if not changed_static and not changed_carry:
            return
        scatter: List[Tuple[str, np.ndarray, int]] = []
        replace: List[Tuple[str, np.ndarray, Optional[int]]] = []
        n_global = self._m_carry["port_mask"].shape[0]
        rows_union: Optional[np.ndarray] = None
        for f in changed_static + changed_carry:
            carry_f = f in CARRY_FIELDS
            host = hc[f] if carry_f else hs[f]
            ax = cspec[f] if carry_f else sspec[f]
            if ax is None or (carry_f and self._block_of(f) is not None
                              and not self._valid[self._block_of(f)]):
                # replicated, or an invalidated block: resync wholesale
                replace.append((f, host, ax))
                continue
            mirror = self._m_carry[f] if carry_f else self._m_static[f]
            diff = np.moveaxis(host, ax, 0) != np.moveaxis(mirror, ax, 0)
            if host.dtype.kind == "f":
                same_nan = (np.isnan(np.moveaxis(host, ax, 0))
                            & np.isnan(np.moveaxis(mirror, ax, 0)))
                diff = diff & ~same_nan
            rows = np.nonzero(
                diff.reshape(diff.shape[0], -1).any(axis=1))[0]
            scatter.append((f, host, ax))
            rows_union = rows if rows_union is None else np.union1d(
                rows_union, rows)
        if rows_union is not None and (
            len(rows_union) > n_global * self.SCATTER_FRAC
        ):
            replace.extend(scatter)
            scatter = []
            rows_union = None
        if replace:
            self.stats["replaces"] += 1
            for f, host, ax in replace:
                ship = self._placed(f, host)
                self._rewrite(f, ship, ax, host)
                self.count_h2d(ship.nbytes, table=True)
        if scatter:
            self._scatter(scatter, rows_union)

    def _tensors(self, f: str) -> List[torch.Tensor]:
        return self._carry[f] if f in CARRY_FIELDS else self._static[f]

    def _owners(self, ax: Optional[int]) -> Sequence[int]:
        """The shards holding distinct tensors of a field on axis ax."""
        return (range(self.mesh.size) if ax is not None
                else self.mesh.first_shard_of())

    def _rewrite(self, f: str, ship: np.ndarray, ax: Optional[int],
                 host: np.ndarray) -> None:
        """Re-place field f wholesale, into its resident tensors."""
        fresh = place_field(self.mesh, ship, ax,
                            f not in CARRY_FIELDS and self._narrow(f, host))
        old = self._tensors(f)
        for s in self._owners(ax):
            old[s].copy_(fresh[s])
        self._mirror(f, host)

    def _mirror(self, f: str, host: np.ndarray) -> None:
        if f in CARRY_FIELDS:
            self._m_carry[f] = np.array(host, copy=True)
            blk = self._block_of(f)
            if blk is not None:
                self._valid[blk] = True
        else:
            self._m_static[f] = np.array(host, copy=True)

    def _scatter(self, fields, rows: np.ndarray) -> None:
        """Ship ONLY the changed rows: one packed buffer (one transfer a
        distinct device) and one K8 launch for each distinct device
        holding a shard that owns a changed row (RK.launch_plan), every
        such shard and every changed field in it, in place."""
        from kubernetes_tpu_torch.models.pack import pack_arrays
        from kubernetes_tpu_torch.snapshot.pad import next_pow2

        self.stats["scatters"] += 1
        M = next_pow2(len(rows), floor=64)
        idx = np.full(M, -1, np.int64)
        idx[: len(rows)] = rows
        packed = {"__idx__": idx}
        names, axes, narrowed = [], [], set()
        for f, host, ax in fields:
            # scatter rows ship at the resident tensor's placed dtype
            r = np.moveaxis(host, ax, 0)[rows]
            pdt = self._placed_dtype(f, host)
            if pdt != r.dtype:
                r = r.astype(pdt)
            pad = np.zeros((M - len(rows),) + r.shape[1:], r.dtype)
            packed[f] = np.concatenate([r, pad]) if M > len(rows) else r
            names.append(f)
            axes.append(ax)
            if self._narrow(f, host):
                narrowed.add(f)
        layout, buf = pack_arrays(packed)
        n_per_shard = self._m_carry["port_mask"].shape[0] // self.mesh.size
        bufs = {d: upload(buf, d) for d in self.mesh.distinct_devices()}
        for launch in RK.launch_plan(self.mesh.devices,
                                     (rows // n_per_shard).tolist(),
                                     n_per_shard):
            RK.scatter_shipment(
                layout, bufs[launch.device], names, axes,
                [[self._tensors(f)[s] for f in names]
                 for s in launch.shards],
                launch.shards, n_per_shard, narrowed=frozenset(narrowed),
                table=self._dest_tables[launch.device])
        for f, host, _ax in fields:
            self._mirror(f, host)
        self.count_h2d(buf.nbytes, table=True)

    # -- mirror maintenance (the wave driver's commit reports) ---------------

    def _set_last(self, last: int) -> None:
        if int(last) == self._last:
            return
        for t in {id(t): t for t in self._carry["__last__"]}.values():
            t.fill_(int(last))
        self._last = int(last)
        self.count_h2d(8)

    def note_commit(self, pod: Dict[str, np.ndarray],
                    counts: np.ndarray) -> None:
        """Fold one run's commits into the pure-channel mirrors with the
        device fold's exact arithmetic."""
        from kubernetes_tpu_torch.models.hosttab import commit_vector

        res = self._m_carry["__res__"]
        res += np.outer(commit_vector(pod), counts)
        touched = counts > 0
        pm = np.asarray(pod["port_mask"])
        if pm.any():
            port = self._m_carry["port_mask"]
            port[touched] |= pm[None, :]
        cls = int(pod["class_id"])
        cc = self._m_carry["class_count"]
        if cls < cc.shape[1]:
            cc[:, cls] += counts.astype(cc.dtype)
        self._last += int(counts.sum())

    def note_scan(self, pods: Sequence[Dict[str, np.ndarray]],
                  chosen: Sequence[int]) -> None:
        """Fold the scan fallback's per-pod commits (host-visible via
        the returned chosen ids) into the pure-channel mirrors."""
        from kubernetes_tpu_torch.models.hosttab import commit_vector

        res = self._m_carry["__res__"]
        port = self._m_carry["port_mask"]
        cc = self._m_carry["class_count"]
        n = port.shape[0]
        for pod, c in zip(pods, chosen):
            self._last += 1 if 0 <= c < n else 0
            if not (0 <= c < n):
                continue
            res[:, c] += commit_vector(pod)
            pm = np.asarray(pod["port_mask"])
            if pm.any():
                port[c] |= pm
            cls = int(pod["class_id"])
            if cls < cc.shape[1]:
                cc[c, cls] += 1

    def invalidate(self, *blocks: str) -> None:
        """Mark carry blocks the host cannot mirror as unknown: the next
        wave resyncs them from the snapshot."""
        for b in blocks:
            if self._valid.get(b, False) and self._m_carry.get(
                    CARRY_BLOCKS[b][0]) is not None:
                self._valid[b] = False

    def finish_wave(self, last: int) -> None:
        """The wave's final round-robin counter (the resident carry was
        folded in place)."""
        self._last = int(last)

    def usage(self) -> np.ndarray:
        """The resource block at this instant (the grouped replay's
        `usage` input — exact, so the mesh group probe need not ship the
        carry's res block device->host)."""
        return np.array(self._m_carry["__res__"], copy=True)

    def invalidate_all(self) -> None:
        """Drop residency entirely (tests; provenance change)."""
        self._key = None
        self._carry = None
        self._static = {}
