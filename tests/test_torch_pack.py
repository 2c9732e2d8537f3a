"""The single-transfer shipment (models/pack) against the JAX package's,
on the CPU: pack_arrays byte for byte, the port's device unpack (with its
int64 placement rule and the narrowed tables' exception) equal to the
JAX unpack and to the host arrays, and the Packer's byte counts."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.models import pack as JPK
from kubernetes_tpu.models import wave as JW
from kubernetes_tpu.oracle import ClusterState as JaxState
from kubernetes_tpu.snapshot.encode import SnapshotEncoder
import kubernetes_tpu.api.types as JT

from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.models import pack as PK
from kubernetes_tpu_torch.models import wave as TW
from kubernetes_tpu_torch.models.batch import BatchScheduler
from kubernetes_tpu_torch.snapshot.carry import batch_from_arrays, place

from tests.test_torch_ops import fields_of


def _batch(seed):
    """A JAX-encoded pod batch with every POD_FIELDS dtype populated."""
    from tests.test_torch_ops import scenario

    state, pods = scenario(seed)
    enc = SnapshotEncoder(state, pods)
    enc.encode_nodes()
    return enc.encode_pods()


def _odd_arrays(seed):
    """Every dtype and shape the packer meets, and the edge shapes."""
    rng = np.random.default_rng(seed)
    return {
        "i8": rng.integers(-128, 128, (5, 3)).astype(np.int8),
        "i16": rng.integers(-2**15, 2**15, 7).astype(np.int16),
        "i32": rng.integers(-2**31, 2**31, (3, 2)).astype(np.int32),
        "i64": rng.integers(-2**62, 2**62, 4).astype(np.int64),
        "u8": rng.integers(0, 256, 9).astype(np.uint8),
        "u32": rng.integers(0, 2**32, (2, 3), dtype=np.uint64)
        .astype(np.uint32),
        "f32": rng.standard_normal(5).astype(np.float32),
        "f64": np.array([np.nan, -0.0, 1e300, 3.5]),
        "flag": rng.random(6) < 0.5,
        "scalar": np.int64(-7),
        "scalar32": np.int32(12),
        "empty": np.zeros((0, 4), np.int32),
        "empty_bool": np.zeros((3, 0), bool),
    }


@pytest.mark.parametrize("seed", range(3))
def test_pack_arrays_matches_jax_byte_for_byte(seed):
    arrays = _odd_arrays(seed)
    batch = _batch(seed)
    arrays.update({f: np.asarray(getattr(batch, f))[seed % batch.num_pods]
                   for f in BatchScheduler.POD_FIELDS})
    layout, buf = PK.pack_arrays(arrays)
    jlayout, jbuf = JPK.pack_arrays(arrays)
    assert layout == jlayout
    assert buf.dtype == jbuf.dtype == np.uint8
    assert np.array_equal(buf, jbuf)
    assert all(off % 8 == 0 for _n, _d, _s, off, _nb in layout)


def _expected(a: np.ndarray, narrow: bool) -> np.ndarray:
    """The port's placement rule on the host: ints to int64 unless a
    narrowed int8/int16 table."""
    if a.dtype.kind in "iu" and not (narrow and a.dtype.kind == "i"
                                     and a.dtype.itemsize <= 2):
        return a.astype(np.int64)
    return a


@pytest.mark.parametrize("narrowed", [False, True])
def test_unpack_round_trip_every_dtype(narrowed):
    arrays = _odd_arrays(5)
    batch = _batch(1)
    arrays.update({f"pod_{f}": np.asarray(getattr(batch, f))
                   for f in BatchScheduler.POD_FIELDS})
    layout, buf = PK.pack_arrays(arrays)
    names = frozenset(arrays) if narrowed else frozenset()
    out = PK.unpack(layout, torch.from_numpy(buf), names)
    assert set(out) == set(arrays)
    for name, a in arrays.items():
        a = np.asarray(a)
        t = out[name]
        want = _expected(a, narrowed)
        assert tuple(t.shape) == a.shape, name
        assert t.dtype == PK.placed_dtype(a.dtype, narrowed), name
        got = t.numpy()
        assert got.dtype == want.dtype, name
        if a.dtype.kind == "f":
            assert np.array_equal(got, want, equal_nan=True), name
        else:
            assert np.array_equal(got, want), name
    # the unsigned bitsets widen to their values, as carry.place does
    assert out["u32"].tolist() == place(arrays["u32"], "cpu").tolist()
    # 0-d stays 0-d, a zero-size axis is an empty tensor of the rule's dtype
    assert out["scalar"].dim() == 0 and int(out["scalar"]) == -7
    assert out["empty"].shape == (0, 4) and out["empty"].dtype == torch.int64
    assert out["empty_bool"].dtype == torch.bool


def test_unpack_equals_the_jax_unpack():
    batch = _batch(2)
    arrays = {f: np.asarray(getattr(batch, f)) for f in
              BatchScheduler.POD_FIELDS}
    layout, buf = JPK.pack_arrays(arrays)
    want = JPK.unpack(layout, buf)
    got = PK.unpack(layout, torch.from_numpy(buf))
    for f in BatchScheduler.POD_FIELDS:
        w = np.asarray(want[f])
        assert np.array_equal(w.astype(np.int64) if w.dtype.kind in "iu"
                              else w, got[f].numpy()), f


def test_packer_counts_bytes_and_never_pins_on_the_cpu():
    packer = PK.Packer(device="cpu")
    arrays = _odd_arrays(0)
    before = PK.Packer.total_h2d_bytes
    out = packer.ship(arrays, narrowed=frozenset({"i8"}))
    _layout, buf = PK.pack_arrays(arrays)
    assert packer.h2d_bytes == buf.nbytes
    assert PK.Packer.total_h2d_bytes == before + buf.nbytes
    assert out["i8"].dtype == torch.int8 and out["i16"].dtype == torch.int64
    for t in out.values():
        assert t.device.type == "cpu" and not t.is_pinned()
    dev = packer.upload(buf)
    assert dev.dtype == torch.uint8 and not dev.is_pinned()
    assert packer.h2d_bytes == 2 * buf.nbytes


@pytest.mark.parametrize("reps", [[0], [3, 0, 4], list(range(5)) * 2,
                                  [2] * 9])
def test_group_buffer_equals_the_jax_buffer(reps):
    """The port's group_buffer is the JAX package's (a verbatim copy): the
    same bucket, layout and bytes; its unpacked rows repeat the last
    representative into the padded slots."""
    state = JaxState.build(S.density_nodes(JT, 4))
    enc = SnapshotEncoder(state, S.template_pods(JT, 5, 1))
    batch = enc.encode_pods()
    G, layout, buf = JW.group_buffer(batch, reps)
    G2, layout2, buf2 = TW.group_buffer(batch_from_arrays(fields_of(batch)),
                                        reps)
    assert (G2, layout2) == (G, layout) and np.array_equal(buf2, buf)
    rows = PK.unpack(layout2, torch.from_numpy(buf2))
    padded = list(reps) + [reps[-1]] * (G - len(reps))
    assert rows["req_mcpu"].tolist() == np.asarray(
        batch.req_mcpu)[padded].tolist()
