"""The continuous telemetry pipeline (round 17): TSDB storage/query
semantics, the collector over in-process registries AND live fleet
replicas, SLO burn-rate alerting, the breach-triggered flight
recorder, the kill switch, and the witness invocations (race + lock
sanitizers) over the whole pipeline.

The cases of tests/test_telemetry.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there.
The scheduler daemon runs with device="cpu" (the port's entry points take
the card unless asked)."""

import json
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

from kubernetes_tpu_torch.client.record import FakeRecorder
from kubernetes_tpu_torch.metrics.metrics import registry
from kubernetes_tpu_torch.telemetry import expo
from kubernetes_tpu_torch.telemetry import scrape as tscrape
from kubernetes_tpu_torch.telemetry.flight import FlightRecorder
from kubernetes_tpu_torch.telemetry.slo import (
    BurnRateRule,
    Engine,
    ThresholdRule,
)
from kubernetes_tpu_torch.telemetry.tsdb import (
    TSDB,
    QueryError,
    Ring,
    eval_query,
    sum_by,
)

_SANITIZED = bool(os.environ.get("KUBERNETES_TPU_RACE_SANITIZER")) or \
    bool(os.environ.get("KUBERNETES_TPU_LOCK_SANITIZER"))


@pytest.fixture
def no_default_collector():
    """Isolate the process-default collector slot: tests that register
    one must not leak it into (or inherit it from) other tests."""
    prev = tscrape.default()
    tscrape.set_default(None)
    yield
    tscrape.set_default(prev)


# -- the ring -----------------------------------------------------------------


def test_ring_round_trip_and_retention():
    r = Ring(interval=1.0, capacity=10)
    for i in range(25):
        r.append(100.0 + i, float(i * 3))
    assert len(r) == 10
    samples = r.samples()
    # newest sample exact, timestamps on the interval grid
    assert samples[-1] == (124.0, 72.0)
    assert samples[0] == (115.0, 45.0)
    assert [t for t, _ in samples] == [115.0 + i for i in range(10)]
    assert [v for _, v in samples] == [45.0 + 3 * i for i in range(10)]


def test_ring_counter_deltas_are_exact_ints():
    # large counters with small steps: int delta encoding must not
    # accumulate float error over eviction folding
    r = Ring(interval=1.0, capacity=4)
    base = 10**15
    for i in range(50):
        r.append(1.0 + i, float(base + i))
    assert [v for _, v in r.samples()] == [
        float(base + i) for i in range(46, 50)]


def test_ring_since_trims():
    r = Ring(interval=1.0, capacity=16)
    for i in range(8):
        r.append(100.0 + i, float(i))
    assert [t for t, _ in r.samples(since=105.0)] == [105.0, 106.0,
                                                      107.0]


# -- the store ----------------------------------------------------------------


def _fill(db, name, labels, values, t0=1000.0, step=1.0):
    for i, v in enumerate(values):
        db.append(name, labels, v, t=t0 + i * step)


def test_tsdb_range_rate_and_label_matchers():
    db = TSDB(interval=1.0, retention_samples=64)
    _fill(db, "reqs_total", {"verb": "GET"}, [0, 2, 4, 6, 8])
    _fill(db, "reqs_total", {"verb": "PUT"}, [0, 1, 2, 3, 4])
    now = 1004.0
    assert db.series_count() == 2
    assert db.metric_names() == ["reqs_total"]
    got = db.range("reqs_total", {"verb": "GET"}, window=10.0, now=now)
    assert len(got) == 1 and got[0][0] == {"verb": "GET"}
    rates = dict((lb["verb"], v) for lb, v in
                 db.rate("reqs_total", window=10.0, now=now))
    assert rates == {"GET": 2.0, "PUT": 1.0}


def test_tsdb_rate_survives_counter_reset():
    db = TSDB(interval=1.0)
    # process restart: 0,5,10, reset to 0, 5 -> increases 5+5+5 over 4s
    _fill(db, "c_total", {}, [0, 5, 10, 0, 5])
    [(_, rate)] = db.rate("c_total", window=10.0, now=1004.0)
    assert rate == pytest.approx(15.0 / 4.0)


def test_tsdb_quantile_interpolates():
    db = TSDB(interval=1.0)
    # 10 obs <= 0.1s, 10 more in (0.1, 1.0]
    _fill(db, "lat_seconds_bucket", {"le": "0.1"}, [0, 10])
    _fill(db, "lat_seconds_bucket", {"le": "1.0"}, [0, 20])
    _fill(db, "lat_seconds_bucket", {"le": "+Inf"}, [0, 20])
    now = 1001.0
    assert db.quantile(0.5, "lat_seconds", window=10.0, now=now) == \
        pytest.approx(0.1)
    assert db.quantile(0.75, "lat_seconds", window=10.0, now=now) == \
        pytest.approx(0.55)
    # bare name and explicit _bucket name agree
    assert db.quantile(0.75, "lat_seconds_bucket", window=10.0,
                       now=now) == pytest.approx(0.55)
    assert db.quantile(0.5, "no_such_seconds", window=10.0,
                       now=now) is None


def test_sum_by_aggregation():
    rows = [({"verb": "GET", "code": "200"}, 3.0),
            ({"verb": "GET", "code": "500"}, 1.0),
            ({"verb": "PUT", "code": "200"}, 2.0)]
    assert sum_by(rows, ()) == [({}, 6.0)]
    assert sum_by(rows, ("verb",)) == [
        ({"verb": "GET"}, 4.0), ({"verb": "PUT"}, 2.0)]


def test_cardinality_cap_drops_and_counts(no_default_collector):
    db = TSDB(interval=1.0, max_series_per_metric=64)
    db.set_metric_bound("capped_total", 2)
    from kubernetes_tpu_torch.metrics import telemetry_series_dropped_total

    before = telemetry_series_dropped_total.get(metric="capped_total")
    stored = [db.append("capped_total", {"flow": f"f{i}"}, 1.0,
                        t=1000.0) for i in range(5)]
    assert stored == [True, True, False, False, False]
    assert db.series_count() == 2
    assert db.dropped() == {"capped_total": 3}
    assert telemetry_series_dropped_total.get(
        metric="capped_total") == before + 3
    # existing series keep appending under the cap
    assert db.append("capped_total", {"flow": "f0"}, 2.0, t=1001.0)


# -- the query language -------------------------------------------------------


def _query_db():
    db = TSDB(interval=1.0)
    _fill(db, "reqs_total", {"verb": "GET", "job": "a"}, [0, 2, 4])
    _fill(db, "reqs_total", {"verb": "GET", "job": "b"}, [0, 1, 2])
    _fill(db, "lat_seconds_bucket", {"le": "0.1"}, [0, 0, 10])
    _fill(db, "lat_seconds_bucket", {"le": "+Inf"}, [0, 0, 10])
    return db, 1002.0


def test_eval_query_matrix_vector_scalar():
    db, now = _query_db()
    m = eval_query(db, 'reqs_total{job="a"}[10s]', now=now)
    assert m["kind"] == "matrix"
    assert m["result"][0]["samples"][-1] == [1002.0, 4.0]

    v = eval_query(db, "rate(reqs_total[10s])", now=now)
    assert v["kind"] == "vector" and len(v["result"]) == 2

    # job a rate 2.0/s + job b rate 1.0/s
    s = eval_query(db, "sum(rate(reqs_total[10s]))", now=now)
    assert s["kind"] == "vector"
    assert s["result"] == [{"labels": {}, "value": pytest.approx(3.0)}]

    by = eval_query(db, "sum_by(verb, rate(reqs_total[10s]))", now=now)
    assert by["result"] == [
        {"labels": {"verb": "GET"}, "value": pytest.approx(3.0)}]

    # all 10 obs landed in (0, 0.1]; the median interpolates halfway
    q = eval_query(db, "quantile(0.5, lat_seconds[10s])", now=now)
    assert q["kind"] == "scalar"
    assert q["result"] == pytest.approx(0.05)


def test_eval_query_rejects_junk():
    db, now = _query_db()
    for bad in ("", "}{", "rate(", "sum(reqs_total[10s])",
                "quantile(zz, lat_seconds[10s])",
                'reqs_total{job}'):
        with pytest.raises(QueryError):
            eval_query(db, bad, now=now)


# -- the shared exposition parser (satellite: procs.py dedupe) ----------------


def test_procs_reexports_the_shared_parser():
    from kubernetes_tpu_torch.harness import procs

    assert procs.series_sum is expo.series_sum
    assert procs.scrape_metrics is expo.scrape_metrics
    assert procs.scrape_raw is expo.scrape_raw
    assert procs.healthz is expo.healthz


def test_parse_text_round_trips_the_registry():
    from kubernetes_tpu_torch.metrics import apiserver_request_latency

    apiserver_request_latency.labels("GET").observe(123.0)
    rows = expo.parse_text(registry.render())
    names = {name for name, _, _ in rows}
    # counters, gauges, and full histogram families all survive
    assert "apiserver_request_latencies_microseconds_bucket" in names
    assert "apiserver_request_latencies_microseconds_sum" in names
    assert "apiserver_request_latencies_microseconds_count" in names
    for name, labels, value in rows:
        assert isinstance(labels, dict)
        float(value)


# -- the collector ------------------------------------------------------------


def test_collector_scrapes_registry_with_job_label():
    db = TSDB(interval=0.1)
    coll = tscrape.Collector(db, interval=0.1)
    coll.add_registry("driver")
    registry.render()  # ensure lazily-registered metrics exist
    stored = coll.tick(now=2000.0)
    assert stored > 0
    assert coll.ticks() == 1
    assert coll.jobs() == ["driver"]
    got = db.range("apiserver_requests_total", {"job": "driver"})
    # every scraped series carries the stamped job label
    for labels, _samples in got:
        assert labels["job"] == "driver"


def test_collector_installs_declared_bounds():
    db = TSDB(interval=1.0)
    tscrape.Collector(db)
    # the lint-enforced label_bound declarations became ingest caps
    # (x8 jobs headroom; histograms fan out per bucket)
    assert db._bounds["workqueue_depth"] == 32 * 8
    assert db._bounds[
        "apiserver_request_latencies_microseconds_sum"] == 16 * 8
    assert db._bounds[
        "apiserver_request_latencies_microseconds_bucket"] >= 16 * 8


def test_collector_scrape_error_counts_not_raises(no_default_collector):
    from kubernetes_tpu_torch.metrics import telemetry_scrape_errors_total

    coll = tscrape.Collector(TSDB(interval=0.1), interval=0.1)
    coll.add_url("ghost", "http://127.0.0.1:1/")  # nothing listens
    before = telemetry_scrape_errors_total.get(job="ghost")
    coll.tick()
    assert telemetry_scrape_errors_total.get(job="ghost") == before + 1


# -- SLO engine ---------------------------------------------------------------


def test_threshold_rule_fires_resolves_and_emits():
    db = TSDB(interval=1.0)
    level = {"v": 10.0}
    rec = FakeRecorder()
    fired = []
    eng = Engine(
        db,
        rules=[ThresholdRule("probe-alert",
                             lambda _db, _now: level["v"], 5.0,
                             description="probe threshold")],
        recorder=rec,
        on_fire=fired.append,
    )
    states = eng.evaluate(now=1000.0)
    assert states[0]["firing"] and states[0]["since"] == 1000.0
    assert [a["alert"] for a in eng.active()] == ["probe-alert"]
    assert len(fired) == 1 and fired[0]["alert"] == "probe-alert"
    assert any("TelemetrySLOBreach" in e for e in rec.events)

    from kubernetes_tpu_torch.metrics import telemetry_alerts_firing

    assert telemetry_alerts_firing.values()["probe-alert"] == 1.0

    # refire while already firing: no duplicate event, no second hook
    eng.evaluate(now=1001.0)
    assert len(fired) == 1 and len(rec.events) == 1

    level["v"] = 1.0
    eng.evaluate(now=1002.0)
    assert eng.active() == []
    assert telemetry_alerts_firing.values()["probe-alert"] == 0.0
    timeline = eng.history()
    assert [e["state"] for e in timeline] == ["firing", "resolved"]


def _burn_db(bad_per_tick, ticks=130):
    """total grows 10/tick, bad grows bad_per_tick/tick."""
    db = TSDB(interval=1.0, retention_samples=200)
    for i in range(ticks):
        t = 1000.0 + i
        db.append("bad_total", {}, float(i * bad_per_tick), t=t)
        db.append("all_total", {}, float(i * 10), t=t)
    return db, 1000.0 + ticks - 1


def test_burn_rate_fires_only_on_both_windows():
    rule = BurnRateRule("burn", bad="bad_total", total="all_total",
                        budget=0.01, short_window=30.0,
                        long_window=120.0)
    # 50% error ratio -> burn 50x budget: over 14.4 AND 6 -> fires
    db, now = _burn_db(bad_per_tick=5)
    firing, value = rule.evaluate(db, now)
    assert firing and value == pytest.approx(50.0, rel=0.05)

    # 0.05% ratio -> burn 0.5x: under both factors -> quiet
    db2 = TSDB(interval=1.0, retention_samples=200)
    for i in range(130):
        t = 1000.0 + i
        db2.append("bad_total", {}, float(i) * 0.005, t=t)
        db2.append("all_total", {}, float(i * 10), t=t)
    firing, _ = rule.evaluate(db2, 1129.0)
    assert not firing

    # no data at all -> not firing, never raises
    firing, _ = rule.evaluate(TSDB(), 1000.0)
    assert not firing


# -- flight recorder ----------------------------------------------------------

BUNDLE_FILES = {"meta.json", "series.jsonl", "alerts.json",
                "traces.json", "audit.json", "procs.json"}


def test_flight_bundle_contents_and_debounce(tmp_path):
    db = TSDB(interval=1.0)
    # fill at real wall times: _write_series windows against now
    _fill(db, "reqs_total", {"verb": "GET"}, [0, 1, 2],
          t0=time.time() - 2.0)
    eng = Engine(db, rules=[])
    fl = FlightRecorder(db, str(tmp_path), engine=eng,
                        min_interval=60.0)
    fl.add_state_source("probe", lambda: {"ok": True})
    fl.add_state_source("broken", lambda: 1 / 0)

    bundle = fl.record("first breach!")
    assert bundle is not None
    assert set(os.listdir(bundle)) == BUNDLE_FILES
    meta = json.load(open(os.path.join(bundle, "meta.json")))
    assert meta["reason"] == "first breach!"
    lines = [json.loads(ln) for ln in
             open(os.path.join(bundle, "series.jsonl"))]
    assert any(ln["name"] == "reqs_total" and
               ln["samples"][-1][1] == 2.0 for ln in lines)
    procs = json.load(open(os.path.join(bundle, "procs.json")))
    assert procs["probe"] == {"ok": True}
    assert "error" in procs["broken"]

    # debounced within min_interval; force bypasses
    assert fl.record("storm") is None
    assert fl.record("gate breach", force=True) is not None
    idx = fl.index()
    assert idx["kind"] == "FlightRecorderIndex"
    assert len(idx["bundles"]) == 2
    assert idx["bundles"][0]["reason"] == "first breach!"


def test_flight_prunes_oldest_past_max_bundles(tmp_path):
    fl = FlightRecorder(TSDB(), str(tmp_path), max_bundles=2,
                        min_interval=0.0)
    dirs = [fl.record(f"r{i}", force=True) for i in range(4)]
    kept = [b["dir"] for b in fl.index()["bundles"]]
    assert kept == dirs[2:]
    assert not os.path.exists(dirs[0])
    assert not os.path.exists(dirs[1])


def test_alert_fire_triggers_flight_dump(tmp_path):
    db = TSDB(interval=1.0)
    eng = Engine(db, rules=[ThresholdRule(
        "hot", lambda _db, _now: 9.0, 1.0)])
    fl = FlightRecorder(db, str(tmp_path), engine=eng)
    eng.on_fire = lambda alert: fl.record("alert-" + alert["alert"])
    eng.evaluate(now=1000.0)
    [bundle] = [b["dir"] for b in fl.index()["bundles"]]
    assert "alert-hot" in bundle
    meta = json.load(open(os.path.join(bundle, "meta.json")))
    assert [a["alert"] for a in meta["firing"]] == ["hot"]


# -- process-default plumbing + HTTP endpoints --------------------------------


def test_kill_switch_disables_attach(monkeypatch, no_default_collector):
    from kubernetes_tpu_torch import telemetry

    monkeypatch.setenv("KUBERNETES_TPU_TELEMETRY", "0")
    assert not telemetry.enabled()
    assert tscrape.ensure_default("probe") is None
    assert tscrape.default() is None
    code, body = telemetry.handle_query({})
    assert code == 503 and "message" in body
    assert telemetry.handle_alerts({})[0] == 503
    assert telemetry.handle_flight({})[0] == 503

    monkeypatch.setenv("KUBERNETES_TPU_TELEMETRY", "1")
    assert telemetry.enabled()


def test_ensure_default_is_idempotent_and_owned(tmp_path,
                                                no_default_collector):
    c1 = tscrape.ensure_default("probe", interval=5.0,
                                flight_dir=str(tmp_path))
    try:
        assert c1 is not None and tscrape.default() is c1
        assert c1.engine is not None and c1.flight is not None
        # second attach joins the first
        assert tscrape.ensure_default("other") is c1
        # a non-owner releasing someone else's collector is a no-op
        tscrape.release_default(None)
        assert tscrape.default() is c1
    finally:
        tscrape.release_default(c1)
    assert tscrape.default() is None


def test_component_mux_serves_telemetry(tmp_path, no_default_collector):
    from kubernetes_tpu_torch.trace.httpd import start_component_server

    db = TSDB(interval=0.2)
    eng = Engine(db, rules=[])
    fl = FlightRecorder(db, str(tmp_path), engine=eng)
    coll = tscrape.Collector(db, interval=0.2, engine=eng, flight=fl)
    coll.add_registry("driver")
    coll.tick(now=3000.0)
    coll.tick(now=3001.0)
    tscrape.set_default(coll)
    server, port = start_component_server(port=0, name="probe")
    base = f"http://127.0.0.1:{port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=5) as r:
            return r.status, json.loads(r.read())

    try:
        code, idx = get("/debug/telemetry/query")
        assert code == 200 and idx["kind"] == "TelemetryIndex"
        assert idx["ticks"] == 2 and idx["series"] > 0

        code, res = get("/debug/telemetry/query?q="
                        + urllib.parse.quote(
                            "sum(rate(apiserver_requests_total[30s]))"))
        assert code == 200
        assert res["kind"] == "TelemetryQueryResult"
        assert res["resultType"] == "vector"

        with pytest.raises(urllib.error.HTTPError) as ei:
            get("/debug/telemetry/query?q=%7Bjunk")
        assert ei.value.code == 400

        code, alerts = get("/debug/telemetry/alerts")
        assert code == 200 and alerts["kind"] == "TelemetryAlertList"

        code, fidx = get("/debug/flightrecorder")
        assert code == 200 and fidx["kind"] == "FlightRecorderIndex"

        code, dump = get("/debug/flightrecorder?dump=operator")
        assert code == 200 and dump["bundle"]
        assert os.path.isdir(dump["bundle"])
    finally:
        server.shutdown()


# -- fleet scraping (live replica processes) ----------------------------------


def test_collector_scrapes_live_fleet(tmp_path, no_default_collector):
    from kubernetes_tpu_torch.harness.procs import ApiserverFleet

    fleet = ApiserverFleet(2, str(tmp_path / "procs"),
                           election_timeout=0.3).start()
    try:
        db = TSDB(interval=0.2)
        coll = tscrape.Collector(db, interval=0.2)
        coll.attach_fleet(fleet)
        assert coll.jobs() == [r.node_id for r in fleet.replicas]
        deadline = time.time() + 10.0
        stored = 0
        while time.time() < deadline:
            stored = coll.tick()
            if stored > 0 and len(coll.proc_state()) == 2:
                state = coll.proc_state()
                if all("healthz" in s for s in state.values()):
                    break
            time.sleep(0.2)
        assert stored > 0
        jobs_seen = set()
        for labels, _ in db.range("apiserver_requests_total"):
            jobs_seen.add(labels["job"])
        assert jobs_seen  # at least one replica answered /metrics
        assert jobs_seen <= {r.node_id for r in fleet.replicas}
        state = coll.proc_state()
        assert set(state) == {r.node_id for r in fleet.replicas}
        assert any("healthz" in s for s in state.values())
    finally:
        fleet.stop()


# -- soak integration: gate breach leaves a bundle ----------------------------


@pytest.mark.skipif(
    _SANITIZED,
    reason="perf-gated soak smokes are not valid under armed sanitizers",
)
def test_soak_gate_breach_writes_flight_bundle(tmp_path):
    from kubernetes_tpu_torch.harness.soak import SoakConfig, run_wire_soak

    cfg = SoakConfig(
        device="cpu",
        seconds=8, num_nodes=16, rate=5.0,
        slo=1e-4,  # impossibly tight: the p99 gate must breach
        params={"churn_floor": 64, "flight_dir": str(tmp_path)},
    )
    rec = run_wire_soak(cfg)
    assert not rec["ok"]
    tel = rec["telemetry"]
    assert tel["ticks"] >= 1 and tel["series"] > 0
    bundle = rec["flight_bundle"]
    assert bundle and os.path.isdir(bundle)
    assert BUNDLE_FILES <= set(os.listdir(bundle))
    meta = json.load(open(os.path.join(bundle, "meta.json")))
    assert meta["reason"] == "soak-gate-breach"
    assert meta["extra"]["failed"]
    # the bundle's series really cover the run (queryable post-mortem)
    lines = [json.loads(ln) for ln in
             open(os.path.join(bundle, "series.jsonl"))]
    assert any(ln["labels"].get("job") == "driver" for ln in lines)


# -- witness invocations ------------------------------------------------------


def test_telemetry_race_witness(tmp_path):
    from kubernetes_tpu_torch.analysis import races

    with races.instrumented(reset=True):
        db = TSDB(interval=0.05)
        eng = Engine(db, rules=[])
        fl = FlightRecorder(db, str(tmp_path), engine=eng,
                            min_interval=0.0)
        coll = tscrape.Collector(db, interval=0.05, engine=eng,
                                 flight=fl)
        coll.add_registry("driver")
        fl.add_state_source("fleet", coll.proc_state)
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                coll.tick()
                eng.evaluate()
                db.range("apiserver_requests_total", window=60.0)
                db.rate("apiserver_requests_total", window=60.0)

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.6)
        fl.record("probe", force=True)
        fl.index()
        stop.set()
        for t in threads:
            t.join()
        bad = [f for f in races.findings() if not f.suppressed]
        assert not bad, bad


def test_telemetry_lock_order_witness(tmp_path):
    from kubernetes_tpu_torch.analysis import locks

    with locks.instrumented(reset=True):
        db = TSDB(interval=0.05)
        eng = Engine(db)
        fl = FlightRecorder(db, str(tmp_path), engine=eng,
                            min_interval=0.0)
        coll = tscrape.Collector(db, interval=0.05, engine=eng,
                                 flight=fl)
        coll.add_registry("driver")
        coll.tick()
        eng.evaluate()
        eval_query(db, "sum(rate(apiserver_requests_total[30s]))")
        fl.record("probe", force=True)
        locks.assert_no_cycles("(telemetry)")
