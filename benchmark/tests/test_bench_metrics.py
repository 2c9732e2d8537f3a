"""Each per-layer reader on a made-up window: the value it should give,
and nothing where the window gave it nothing to read; the trace
arithmetic of benchmark/roofline.py."""

import pytest

from benchmark import roofline, run
from conftest import BENCH_DIR, ROOT

MS = 1_000_000  # ns


def ctx(**kw):
    base = {"window_s": 2.0, "calls": 4, "pods": 400, "zreplay_pods": 400,
            "node_picks": 400 * 1000,
            "phases": {"encode": 1.0, "replay": 0.5},
            "dispatches": {"zreplay": 4, "scan_pods": 0},
            "k1": 4, "k3": 4,
            "k1_shapes": {(128, 1024, "i64"): 4},
            "k3_shapes": {(1024, 128, 3): 4},
            "events": [("resource_probe_kernel", 0, 10_000),
                       ("zreplay_kernel<1>", 5_000, 5_000 + 40 * MS),
                       ("Memcpy HtoD", 100 * MS, 101 * MS)],
            "busy_ns": 41 * MS}
    base.update(kw)
    return base


def read(name, c):
    return run.load_metric(BENCH_DIR, name).read(c)


def test_every_listed_metric_has_a_reader():
    for m in run.load_manifest(ROOT)["per_layer"]:
        assert callable(run.load_metric(BENCH_DIR, m["name"]).read)


def test_shares_of_the_window():
    c = ctx()
    assert read("encode_share", c) == pytest.approx(50.0)
    assert read("replay_share", c) == pytest.approx(25.0)
    assert read("device_idle_share", c) == pytest.approx(
        100 * (1 - 0.041 / 2.0))
    assert read("dispatches_per_call", c) == 1.0
    assert read("encode_share", ctx(phases={})) is None


def test_kernel_metrics():
    c = ctx()
    assert read("k3_us_per_pick", c) == pytest.approx(40_000 / 400)
    bound = 4 * roofline.zreplay_bound_ms(1024, 128, 100_000)[0]
    assert read("k3_roofline", c) == pytest.approx(100 * bound / 40.0)
    k1 = 4 * roofline.probe_bound_ms(128, 1024)[0]
    assert read("k1_roofline", c) == pytest.approx(100 * k1 / 0.01)
    assert read("k3_us_per_pick", ctx(zreplay_pods=None)) is None
    assert read("k1_roofline", ctx(events=[])) is None
    assert read("k3_roofline", ctx(k3_shapes={})) is None


def test_union_and_sums():
    ev = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 32, 35)]
    assert roofline.union_ns(ev) == 30
    assert roofline.kernel_ns(ev, "a") == (10, 1)
    assert roofline.top_ops(ev, 2) == [["b", 15e-9], ["a", 10e-9]]


def test_bounds_are_the_frozen_copies():
    # chip_smoke.py's arithmetic, at the density shapes
    ms, by = roofline.probe_bound_ms(128, 8192)
    assert by == "bytes"
    assert ms == pytest.approx((72 + 80 * 8192 + 8 * 8192 + 1024 * 8192)
                               / 3.35e12 * 1e3)
    ms, by = roofline.zreplay_bound_ms(8192, 65536, 50_000 * 5_000)
    assert by == "operations"
    assert ms == pytest.approx((2 / 67e12 + 4 / 33.5e12) * 2.5e8 * 1e3)
