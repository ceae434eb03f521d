"""Load generation, the fleet observability plane and the compressor's
stage timers on the port (``repro_torch.serving.loadgen``,
``repro_torch.obs.{collect,slo}``, the timers of ``core/{sz,she,hybrid}``
and ``io/reader``) against the reference's, on the CPU.

* ``ZipfWorkload`` draws the reference's population and request sequence
  for the same seeds; ``_percentile`` and ``LoadReport.to_dict()`` equal
  the reference's on the same latencies;
* both packages' ``FleetCollector``s, fed the same exposition texts
  through an injected ``fetch``/``clock`` (the reference tests'
  ``FakeFleet``), read the same deltas, rates, quantiles, gauges, fleet
  families and snapshots; both ``SLOEngine``s walk the same states and
  give the same verdicts and reports;
* the reference's collector scraping a live port endpoint sees the
  families and labels it sees on a reference endpoint; an open-loop run
  against a port fleet verifies with zero mismatches, and the fleet
  counters add up;
* the five stage timers fire on a small ``compress_amr`` and ``read``;
  with the registry disabled nothing is recorded, no stream is
  synchronized and the kernels' wrappers are called as often.

Servers bind port 0 on 127.0.0.1 with client timeouts of 2 s; the port's
servers run on ``device="cpu"`` and are warmed in process first.  The
reference is imported inside fixtures and test bodies only; the ``cuda``
test imports no JAX (``pytest --noconftest -m cuda``).
"""
import contextlib
import json
import math
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import io as tio
from repro_torch import obs
from repro_torch.convert import dataset_from_arrays
from repro_torch.core import amr, hybrid
from repro_torch.kernels import ops
from repro_torch.obs import expo
from repro_torch.obs import metrics as obsm
from repro_torch.obs.collect import FleetCollector
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.slo import RULE_TYPES, STATE_CODES, SLOEngine, SLORule
from repro_torch.serving import (LoadGenerator, LoadReport, RegionClient,
                                 ShardedRegionRouter, ShardMap, ZipfWorkload,
                                 client_fetch, serve)
from repro_torch.serving import loadgen

BOXES = [((0, 12), (0, 12), (0, 12)), ((8, 24), (4, 20), (10, 26)),
         ((20, 32), (20, 32), (20, 32))]
WHOLE = ((0, 32), (0, 32), (0, 32))
TIMEOUT = 2.0
STAGES = ("prequant", "branch_score", "entropy")


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (imported here, not at module level)."""
    from repro import io as rio
    from repro.core import amr as ramr
    from repro.obs import collect as rcollect
    from repro.obs import expo as rexpo
    from repro.obs import metrics as rmetrics
    from repro.obs import slo as rslo
    from repro.obs.registry import MetricsRegistry as RRegistry
    from repro.serving import loadgen as rloadgen
    from repro.serving import serve as rserve
    return SimpleNamespace(io=rio, amr=ramr, collect=rcollect, expo=rexpo,
                           metrics=rmetrics, slo=rslo, loadgen=rloadgen,
                           serve=rserve, MetricsRegistry=RRegistry)


@pytest.fixture(scope="module")
def snap(ref, tmp_path_factory):
    """The reference tests' 32³ dataset, compressed and written by the
    port (``payload_codec="none"``)."""
    rds = ref.amr.synthetic_amr((32, 32, 32), densities=[0.35, 0.65],
                                refine_block=4, seed=5)
    ds = dataset_from_arrays([(l.data, l.mask, l.ratio) for l in rds.levels])
    eb = 1e-3 * float(rds.levels[0].data.max() - rds.levels[0].data.min())
    res = hybrid.compress_amr(ds, eb=eb, device="cpu")
    path = str(tmp_path_factory.mktemp("fleet") / "fleet.tacz")
    tio.write(path, res, payload_codec="none", device="cpu")
    return SimpleNamespace(path=path, ds=ds, eb=eb)


@pytest.fixture()
def metrics_enabled():
    was = obs.is_enabled()
    obs.set_enabled(True)
    yield
    obs.set_enabled(was)


@contextlib.contextmanager
def _endpoint(serve_fn, src, *, warm=BOXES, **kw):
    httpd = serve_fn(src, port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    if warm:
        httpd.region_server.get_regions(warm)
    try:
        yield httpd, f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.region_server.close()


def _port_serve(src, **kw):
    return serve(src, device="cpu", **kw)


# --------------------------------- loadgen ----------------------------------


@pytest.mark.parametrize("shape,population,s,seed,fracs", [
    ((32, 32, 32), 30, 1.1, 7, (0.125, 0.25, 0.5)),
    ((512, 512, 512), 32, 1.1, 11, (0.125, 0.25, 0.5)),
    ((64, 48, 40), 16, 0.8, 3, (0.3, 0.05)),
])
def test_zipf_workload_equals_reference(ref, shape, population, s, seed,
                                        fracs):
    kw = dict(levels=(0, 1), population=population, s=s, size_fracs=fracs,
              seed=seed)
    mine, theirs = ZipfWorkload(shape, **kw), \
        ref.loadgen.ZipfWorkload(shape, **kw)
    assert [(q.box, q.levels, q.rank) for q in mine.queries] == \
        [(q.box, q.levels, q.rank) for q in theirs.queries]
    assert mine._weights == theirs._weights
    assert [q.rank for q in mine.sequence(300)] == \
        [q.rank for q in theirs.sequence(300)]
    assert [q.box for q in mine.sequence(50)] == \
        [q.box for q in theirs.sequence(50)]


def test_zipf_workload_shape_and_determinism():
    wl1 = ZipfWorkload((32, 32, 32), population=30, seed=7)
    wl2 = ZipfWorkload((32, 32, 32), population=30, seed=7)
    assert [q.box for q in wl1.queries] == [q.box for q in wl2.queries]
    assert wl1.sequence(50) == wl2.sequence(50)
    sizes = {hi - lo for q in wl1.queries for lo, hi in q.box}
    assert {4, 8, 16} <= sizes
    counts: dict = {}
    for q in wl1.sequence(500):
        counts[q.rank] = counts.get(q.rank, 0) + 1
    assert counts.get(0, 0) > counts.get(9, 0)
    with pytest.raises(ValueError):
        ZipfWorkload((8, 8, 8), population=0)


@pytest.mark.parametrize("seed", range(6))
def test_percentile_and_report_equal_reference(ref, seed):
    rng = random.Random(seed)
    n = rng.choice([0, 1, 2, 17, 250])
    lats = sorted(rng.lognormvariate(-4.0, 1.0) for _ in range(n))
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert loadgen._percentile(lats, q) == \
            ref.loadgen._percentile(lats, q)
    fields = dict(
        offered_rate=rng.choice([50.0, 100.0]),
        achieved_rate=rng.uniform(1.0, 120.0), duration_s=rng.uniform(1, 9),
        requests=n, errors=rng.randrange(3), verified=rng.randrange(n + 1),
        mismatches=0, p50_s=loadgen._percentile(lats, 0.5),
        p90_s=loadgen._percentile(lats, 0.9),
        p99_s=loadgen._percentile(lats, 0.99),
        mean_s=(sum(lats) / n) if n else None,
        max_s=lats[-1] if lats else None, max_lag_s=rng.uniform(0, 0.2))
    mine, theirs = LoadReport(**fields), ref.loadgen.LoadReport(**fields)
    assert mine.to_dict() == theirs.to_dict()
    assert mine.saturated == theirs.saturated


def test_loadgen_open_loop_error_isolation_and_saturation():
    calls = []

    def fetch(query):
        calls.append(query)
        if len(calls) == 5:
            raise RuntimeError("injected failure")
        time.sleep(0.001)
        return []

    wl = ZipfWorkload((32, 32, 32), population=8, seed=3)
    report = LoadGenerator(fetch, wl, rate=500.0, concurrency=4).run(40)
    assert report.requests == 40 and len(calls) == 40
    assert report.errors == 1
    assert "injected failure" in report.error_messages[0]
    assert report.p50_s <= report.p99_s <= report.max_s
    assert report.verified == 0
    ran = []
    report = LoadGenerator(lambda q: [], wl, rate=500.0).run(
        10, actions={3: lambda: ran.append(1),
                     6: lambda: 1 / 0})
    assert ran == [1] and report.errors == 1
    assert report.error_messages[0].startswith("action@6")

    def slow_fetch(query):
        time.sleep(0.01)
        return []

    rep = LoadGenerator(slow_fetch, wl, rate=10_000.0,
                        concurrency=2).run(30)
    assert rep.achieved_rate < rep.offered_rate and rep.saturated
    with pytest.raises(ValueError):
        LoadGenerator(fetch, wl, rate=0.0)


def test_verify_compares_exact_float32_on_the_host(snap):
    """``_verify`` brings the reader's tensor and the response to the host
    and wants the same float32 values: one ulp off is a mismatch."""
    with tio.TACZReader(snap.path, device="cpu") as rd:
        gen = LoadGenerator(lambda q: [], ZipfWorkload((32, 32, 32)),
                            verify_reader=rd)
        box = rd.level_box(0, ((0, 8), (0, 8), (0, 8)))
        crop = rd.read_level_box(0, box).numpy()
        roi = SimpleNamespace(level=0, box=box, data=crop.copy())
        assert gen._verify(None, [roi])
        roi.data = torch.from_numpy(crop.copy())
        assert gen._verify(None, [roi])
        bumped = crop.copy()
        i = np.unravel_index(np.argmax(np.abs(bumped)), bumped.shape)
        bumped[i] = np.nextafter(bumped[i], np.float32(np.inf))
        roi.data = bumped
        assert not gen._verify(None, [roi])
        roi.data = crop.astype(np.float64)
        assert not gen._verify(None, [roi])


# ------------------------ collector (injected fetch) -------------------------


class FakeFleet:
    """Injectable fetch/clock: each endpoint serves the render of a fresh
    port ``MetricsRegistry`` built by a mutable builder function; the
    texts are recorded so a second collector can be fed the same ones."""

    def __init__(self, names=("a", "b")):
        self.builders = {n: (lambda reg: None) for n in names}
        self.health = {n: {"status": "ok"} for n in names}
        self.raising = set()
        self.now = 0.0

    def clock(self):
        return self.now

    def fetch(self, url, timeout):
        name = url.rsplit("/", 1)[-1]
        if name in self.raising:
            raise ConnectionError("injected outage")
        reg = MetricsRegistry()
        self.builders[name](reg)
        return reg.render(), self.health.get(name)

    def collectors(self, ref, **kw):
        eps = {n: f"fake://{n}" for n in self.builders}
        return (FleetCollector(eps, fetch=self.fetch, clock=self.clock, **kw),
                ref.collect.FleetCollector(eps, fetch=self.fetch,
                                           clock=self.clock, **kw))


def _poll(cols):
    for c in cols:
        c.poll()


def _strip_ts(snap: dict) -> dict:
    out = json.loads(json.dumps(snap))
    for ep in out["endpoints"].values():
        ep.pop("ts", None)
    return out


def _same(cols, fn):
    """``fn(collector)`` on both collectors; equal results (a histogram
    compared by its fields), returned."""
    a, b = (fn(c) for c in cols)
    if hasattr(a, "counts"):
        assert (a.bounds, a.counts, a.count, a.sum) == \
            (b.bounds, b.counts, b.count, b.sum)
    else:
        assert a == b
    return a


def test_collector_counters_rates_and_reset_equal_reference(ref):
    fleet = FakeFleet(names=("a", "b"))
    cols = fleet.collectors(ref)
    vals = {"a": 10.0, "b": 100.0}
    for n in vals:
        fleet.builders[n] = (
            lambda reg, n=n: reg.counter("x_total", "X").inc(vals[n]))
    _poll(cols)
    assert _same(cols, lambda c: c.counter_delta("x_total")) is None
    fleet.now = 10.0
    vals["a"], vals["b"] = 25.0, 140.0
    _poll(cols)
    assert _same(cols, lambda c: c.counter_delta("x_total")) == 55.0
    assert _same(cols, lambda c: c.counter_delta("x_total",
                                                 endpoint="a")) == 15.0
    assert _same(cols, lambda c: c.counter_rate("x_total")) == 5.5
    fleet.now = 20.0
    vals["a"], vals["b"] = 3.0, 150.0                 # a restarted
    _poll(cols)
    assert _same(cols, lambda c: c.counter_delta("x_total",
                                                 window=11.0)) == 13.0
    _same(cols, lambda c: c.counter_deltas_by_series("x_total"))
    assert _same(cols, lambda c: c.counter_delta("nope_total")) is None
    _same(cols, lambda c: _strip_ts(c.snapshot()))


def test_collector_windowed_quantiles_equal_reference(ref):
    fleet = FakeFleet(names=("a",))
    cols = fleet.collectors(ref)
    observed: list = []

    def build(reg):
        h = reg.histogram("lat_seconds", "L", buckets=(0.01, 0.05, 0.1),
                          labels=("route",))
        for v in observed:
            h.labels("/v1/regions").observe(v)

    fleet.builders["a"] = build
    readings = []
    for t, extra in ((0.0, []), (10.0, [0.002] * 10), (20.0, [0.09] * 10),
                     (40.0, [0.002] * 20), (50.0, [])):
        observed += extra
        fleet.now = t
        _poll(cols)
        for q in (0.5, 0.9, 0.99):
            readings.append(_same(cols, lambda c: c.quantile(
                "lat_seconds", q, window=30.0)))
            _same(cols, lambda c: c.quantile(
                "lat_seconds", q, {"route": "/v1/regions"}, window=30.0))
        _same(cols, lambda c: c.histogram_delta("lat_seconds", window=None))
    assert readings[-1] <= 0.01 and max(r for r in readings if r) > 0.05
    assert _same(cols, lambda c: c.histogram_delta(
        "lat_seconds", window=None)).count == 40


def test_collector_gauges_families_and_up_equal_reference(ref, tmp_path):
    fleet = FakeFleet(names=("a", "b", "c"))
    fleet.builders["a"] = lambda reg: (
        reg.gauge("occ", "O").set(5), reg.counter("c_total", "C").inc(7))
    fleet.builders["b"] = lambda reg: (
        reg.gauge("occ", "O").set(11), reg.counter("c_total", "C").inc(9),
        reg.histogram("h", "H", buckets=(1.0,)).observe(0.5))
    fleet.builders["c"] = lambda reg: reg.counter("c_total", "C").inc(4)
    fleet.health["c"] = {"status": "down"}
    cols = fleet.collectors(ref)
    _poll(cols)
    for agg in ("max", "min", "sum"):
        _same(cols, lambda c: c.gauge("occ", agg=agg))
    for c in cols:
        with pytest.raises(ValueError):
            c.gauge("occ", agg="avg")
    fam = _same(cols, lambda c: c.fleet_families())
    assert fam["c_total"]["series"]["_"] == 16.0
    assert fam["occ"]["series"]["_"] == {"max": 11.0, "min": 5.0}
    assert _same(cols, lambda c: [c.up(n) for n in "abc"]) == \
        [True, True, False]
    fleet.raising.add("b")
    fleet.now = 5.0
    _poll(cols)
    assert _same(cols, lambda c: c.up_fraction()) == pytest.approx(1 / 3)
    snap = _same(cols, lambda c: _strip_ts(c.snapshot()))
    assert "injected outage" in snap["endpoints"]["b"]["error"]
    paths = [c.dump_json(str(tmp_path / f"f{i}.json"))
             for i, c in enumerate(cols)]
    dumps = [_strip_ts(json.loads(open(p).read())) for p in paths]
    assert dumps[0] == dumps[1] and dumps[0]["polls"] == 2


def test_background_polling_thread():
    fleet = FakeFleet(names=("a",))
    fleet.builders["a"] = lambda reg: reg.counter("c_total", "C").inc(1)
    col = FleetCollector({"a": "fake://a"}, fetch=fleet.fetch,
                         clock=fleet.clock)
    col.start(interval=0.01)
    deadline = time.monotonic() + 5.0
    while col.polls < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    col.stop()
    assert col.polls >= 3
    polls = col.polls
    time.sleep(0.05)
    assert col.polls == polls
    with pytest.raises(ValueError):
        FleetCollector({})


# -------------------------------- SLO engine ---------------------------------


def test_rule_types_and_validation_equal_reference(ref):
    assert RULE_TYPES == ref.slo.RULE_TYPES
    assert STATE_CODES == ref.slo.STATE_CODES
    assert set(RULE_TYPES) == {"quantile", "quantile_ratio", "rate", "ratio",
                               "error_rate", "gauge", "up"}
    for mod in (None, ref.slo):
        Rule = SLORule if mod is None else mod.SLORule
        with pytest.raises(ValueError):
            Rule("r", "nope", "<", 1.0)
        with pytest.raises(ValueError):
            Rule("r", "gauge", "!=", 1.0)
    fleet = FakeFleet(names=("a",))
    with pytest.raises(ValueError):
        SLOEngine(fleet.collectors(ref)[0],
                  [SLORule("r", "up", ">=", 1.0),
                   SLORule("r", "up", ">=", 0.5)])


def _engines(ref, fleet, rules_spec, **kw):
    cols = fleet.collectors(ref)
    engines = (
        SLOEngine(cols[0], [SLORule(*a, **k) for a, k in rules_spec],
                  clock=fleet.clock, **kw),
        ref.slo.SLOEngine(cols[1], [ref.slo.SLORule(*a, **k)
                                    for a, k in rules_spec],
                          clock=fleet.clock, **kw))
    return cols, engines


def _step(cols, engines):
    _poll(cols)
    for e in engines:
        e.evaluate()
    states = [{n: (s.state, s.value, s.ever_fired)
               for n, s in e.states.items()} for e in engines]
    assert states[0] == states[1]
    return states[0]


def test_slo_state_machine_equals_reference(ref, metrics_enabled):
    """ok → pending → ok (a blip) → pending → firing → (no data) firing →
    resolved → ok, step for step in both packages, with the port's gauges
    exported into the port's registry."""
    fleet = FakeFleet(names=("a",))
    value, present = [5.0], [True]

    def build(reg):
        if present[0]:
            reg.gauge("queue_depth", "Q").set(value[0])

    fleet.builders["a"] = build
    cols, engines = _engines(
        ref, fleet, [(("queue", "gauge", "<", 10.0),
                      {"for_seconds": 5.0,
                       "params": {"metric": "queue_depth"}})])
    walk = []
    for t, v, p in ((0.0, 5.0, True), (10.0, 50.0, True), (12.0, 5.0, True),
                    (20.0, 50.0, True), (26.0, 50.0, True),
                    (30.0, 50.0, False), (40.0, 3.0, True)):
        fleet.now, value[0], present[0] = t, v, p
        walk.append(_step(cols, engines)["queue"][0])
        if walk[-1] == "firing":
            assert obsm.SLO_FIRING.labels("queue").value == 1.0
            assert obsm.SLO_STATE.labels("queue").value == 2.0
    for e in engines:
        e.evaluate()
    walk.append(engines[0].states["queue"].state)
    assert walk == ["ok", "pending", "ok", "pending", "firing", "firing",
                    "resolved", "ok"]
    assert engines[0].states["queue"].state == \
        engines[1].states["queue"].state
    assert engines[0].verdict() == engines[1].verdict()
    assert engines[0].report() == engines[1].report()
    assert engines[0].passed() and "overall: PASS" in engines[0].report()
    assert obsm.SLO_FIRING.labels("queue").value == 0.0
    assert obsm.SLO_VALUE.labels("queue").value == 3.0


def test_slo_rule_kinds_equal_reference(ref):
    fleet = FakeFleet(names=("a", "b"))
    http = {"200": 0.0, "500": 0.0}
    cache = {"hits": 0.0, "misses": 0.0}
    lat: list = []

    def build(reg):
        fam = reg.counter("tacz_http_requests_total", "H",
                          labels=("route", "status"))
        for status, v in http.items():
            fam.labels("/v1/regions", status).inc(v)
        reg.gauge("tacz_cache_hits", "h").set(cache["hits"])
        reg.gauge("tacz_cache_misses", "m").set(cache["misses"])
        h = reg.histogram("tacz_server_request_seconds", "S")
        for v in lat:
            h.observe(v)

    fleet.builders = {"a": build, "b": build}
    spec = [
        (("errors", "error_rate", "<", 0.001),
         {"params": {"metric": "tacz_http_requests_total"}}),
        (("cache_hit_ratio", "ratio", ">", 0.8),
         {"params": {"metric_a": "tacz_cache_hits",
                     "metric_b": "tacz_cache_misses"}}),
        (("fleet_up", "up", ">=", 1.0), {}),
        (("throughput", "rate", ">", 1.0),
         {"params": {"metric": "tacz_http_requests_total"}}),
        (("tail_spread", "quantile_ratio", "<=", 150.0),
         {"params": {"metric": "tacz_server_request_seconds",
                     "q_hi": 0.99, "q_lo": 0.50}}),
        (("p99", "quantile", "<", 0.05),
         {"params": {"metric": "tacz_server_request_seconds", "q": 0.99,
                     "window": 25.0}}),
    ]
    cols, engines = _engines(ref, fleet, spec, export=False)
    _step(cols, engines)
    http.update({"200": 900.0})
    cache.update({"hits": 90.0, "misses": 5.0})
    lat += [0.002] * 50 + [0.03] * 2
    fleet.now = 10.0
    st = _step(cols, engines)
    assert st["errors"][1] == 0.0 and st["fleet_up"][1] == 1.0
    assert engines[0].passed() == engines[1].passed() is True
    http["500"] += 100.0
    lat += [0.4] * 20
    fleet.raising.add("b")
    fleet.now = 20.0
    st = _step(cols, engines)
    assert st["errors"][1] == pytest.approx(100.0 / 1000.0)
    assert st["fleet_up"][1] == 0.5
    fleet.now = 40.0
    _step(cols, engines)
    assert engines[0].verdict() == engines[1].verdict()
    assert engines[0].report() == engines[1].report()
    assert not engines[0].passed()


# --------------------------- live port endpoints -----------------------------


def test_reference_collector_reads_port_endpoint_alike(ref, snap,
                                                       metrics_enabled):
    """The reference's collector scraping a port endpoint and a reference
    endpoint over the same file: the same family names, kinds and label
    names wherever both carry series."""
    was = ref.metrics.is_enabled()
    ref.metrics.set_enabled(True)
    try:
        with _endpoint(_port_serve, snap.path) as (_, purl), \
                _endpoint(ref.serve, snap.path) as (_, rurl):
            for url, cls in ((purl, RegionClient),
                             (rurl, RegionClient)):
                cls(url, timeout=TIMEOUT).regions(BOXES)
            col = ref.collect.FleetCollector({"port": purl, "ref": rurl},
                                             timeout=TIMEOUT)
            col.poll()
            assert col.up("port") and col.up("ref")
            pf = col.latest("port").families
            rf = col.latest("ref").families
            assert set(pf) == set(rf)
            for name in pf:
                assert pf[name].kind == rf[name].kind, name
                if pf[name].series and rf[name].series:
                    assert pf[name].label_names == rf[name].label_names, \
                        name
            h = col.latest("port").health
            assert h["status"] == "ok" and h["role"] == "server"
    finally:
        ref.metrics.set_enabled(was)


def test_port_catalog_equals_reference(ref):
    """Every family of the reference's catalog, by name, kind, help,
    label names and buckets, in the port's registry."""
    mine = {f.name: f for f in obsm.REGISTRY.families()}
    theirs = {f.name: f for f in ref.metrics.REGISTRY.families()}
    assert set(mine) == set(theirs)
    for name, f in theirs.items():
        g = mine[name]
        assert (g.kind, g.help, g.label_names, g._bounds) == \
            (f.kind, f.help, f.label_names, f._bounds), name
    assert set(obsm.__all__) == set(ref.metrics.__all__)
    assert set(expo.parse(obsm.REGISTRY.render())) == \
        set(ref.expo.parse(ref.metrics.REGISTRY.render()))


def test_packages_export_the_reference_names():
    """``repro_torch.serving`` and ``repro_torch.obs`` export every name
    of ``repro.serving.__all__`` and ``repro.obs.__all__``."""
    import repro.obs as robs
    import repro.serving as rserving
    import repro_torch.obs as pobs
    import repro_torch.serving as pserving
    assert set(rserving.__all__) <= set(pserving.__all__)
    assert set(robs.__all__) == set(pobs.__all__)
    for mod, names in ((pserving, rserving.__all__), (pobs, robs.__all__)):
        assert all(hasattr(mod, n) for n in names)


@pytest.fixture()
def fleet(snap):
    """Two port shard endpoints and a mounted port router, one process."""
    m = ShardMap(["s0", "s1"], seed=7)
    stack = contextlib.ExitStack()
    servers, urls = {}, {}
    for sid in m.shards:
        httpd, url = stack.enter_context(_endpoint(
            _port_serve, snap.path, warm=[WHOLE], cache_bytes=8 << 20,
            shard_map=m, shard_id=sid))
        servers[sid], urls[sid] = httpd, url
    router = ShardedRegionRouter(snap.path, m, urls, device="cpu",
                                 timeout=TIMEOUT)
    rhttpd, rurl = stack.enter_context(_endpoint(serve, router, warm=None))
    urls["router"] = rurl
    with stack:
        yield SimpleNamespace(urls=urls, servers=servers, router=router)


def test_fleet_collector_under_port_load(ref, snap, fleet,
                                        metrics_enabled):
    """A collector over a live port fleet under Zipf traffic through the
    mounted router: every sampled response verifies, fleet counter
    totals are the per-endpoint sums, and a shard going down degrades
    the router's health."""
    col = FleetCollector(fleet.urls, window=16, timeout=TIMEOUT)
    col.poll()
    assert col.up_fraction() == 1.0
    wl = ZipfWorkload((32, 32, 32), levels=(0, 1), population=8, seed=11)
    client = RegionClient(fleet.urls["router"], timeout=TIMEOUT)
    for q in wl.queries:                       # warm pass
        client.regions([q.box], levels=list(q.levels))
    # the reference's reader verifies (numpy decode: the port's plain
    # decoder would set the pace on the CPU)
    with ref.io.TACZReader(snap.path) as rd:
        report = LoadGenerator(client_fetch(client), wl, rate=100.0,
                               concurrency=4, verify_reader=rd,
                               verify_fraction=0.5, seed=1).run(30)
    assert report.errors == 0, report.error_messages
    assert report.verified > 0 and report.mismatches == 0
    col.poll()
    assert col.counter_delta("tacz_router_batches_total",
                             endpoint="router") >= 30
    assert col.quantile("tacz_router_batch_seconds", 0.5) is not None
    fam = col.fleet_families()
    reg_snap = obsm.REGISTRY.snapshot()
    for metric in ("tacz_server_regions_total", "tacz_router_batches_total"):
        per_endpoint = [expo.to_snapshot(col.latest(n).families)[metric][
            "series"]["_"] for n in fleet.urls]
        assert fam[metric]["series"]["_"] == pytest.approx(sum(per_endpoint))
        assert per_endpoint == [pytest.approx(
            reg_snap[metric]["series"]["_"])] * len(fleet.urls)
    h = client.health()
    assert h["status"] == "ok" and h["role"] == "router"
    fleet.servers["s0"].shutdown()
    fleet.servers["s0"].server_close()
    assert client.health()["status"] == "degraded"
    col.poll()
    assert col.up("router") and col.up("s1") and not col.up("s0")


def test_slo_latency_rule_fires_and_resolves_on_port_endpoint(
        snap, metrics_enabled):
    fake = [0.0]
    with _endpoint(_port_serve, snap.path, cache_bytes=8 << 20) as (
            httpd, url):
        client = RegionClient(url, timeout=TIMEOUT)
        col = FleetCollector({"s0": url}, window=32, timeout=TIMEOUT,
                             clock=lambda: fake[0])
        rule = SLORule("latency_p99", "quantile", "<", 0.05,
                       for_seconds=5.0,
                       params={"metric": "tacz_server_request_seconds",
                               "q": 0.99, "window": 25.0})
        eng = SLOEngine(col, [rule], clock=lambda: fake[0])
        st = eng.states["latency_p99"]
        col.poll()
        for _ in range(5):
            client.regions(BOXES[:1])
        fake[0] = 10.0
        col.poll()
        eng.evaluate()
        assert st.state == "ok" and st.value < 0.05
        httpd.region_server.fault_hook = lambda: time.sleep(0.08)
        for _ in range(6):
            client.regions(BOXES[:1])
        fake[0] = 20.0
        col.poll()
        eng.evaluate()
        assert st.state == "pending" and st.value > 0.05
        fake[0] = 26.0
        eng.evaluate()
        assert st.state == "firing"
        assert obsm.SLO_FIRING.labels("latency_p99").value == 1.0
        httpd.region_server.fault_hook = None
        for _ in range(12):
            client.regions(BOXES[:1])
        fake[0] = 40.0
        col.poll()
        fake[0] = 45.0
        col.poll()
        eng.evaluate()
        assert st.state == "resolved", (st.state, st.value)
        eng.evaluate()
        assert st.state == "ok" and st.ever_fired
        assert obsm.SLO_FIRING.labels("latency_p99").value == 0.0


# ------------------------------- stage timers --------------------------------


def _timer_counts() -> dict:
    snap = obsm.REGISTRY.snapshot()
    out = {}
    for stage in STAGES:
        s = snap["tacz_compress_stage_seconds"]["series"].get(
            f"stage={stage}")
        out[stage] = (s["count"], s["sum"]) if s else (0, 0.0)
    lv = snap["tacz_compress_level_seconds"]["series"]
    out["compress_level"] = (sum(v["count"] for v in lv.values()),
                             sum(v["sum"] for v in lv.values()))
    ed = snap["tacz_entropy_decode_seconds"]["series"].get("_")
    out["entropy_decode"] = (ed["count"], ed["sum"]) if ed else (0, 0.0)
    return out


def _small_run(path: str, device: str = "cpu") -> None:
    ds = amr.synthetic_amr((16, 16, 16), densities=[0.4, 0.6],
                           refine_block=4, seed=2)
    res = hybrid.compress_amr(ds, eb=1e-2, device=device)
    tio.write(path, res, payload_codec="none", device=device)
    tio.read(path, device=device)


def test_stage_timers_fire_on_compress_and_read(tmp_path, metrics_enabled):
    """The five timers of the reference's sites, each observed at least
    once by a small ``compress_amr`` + ``read``, and the spans nest under
    a root span as the reference's do."""
    before = _timer_counts()
    with obs.root_span("run") as root:
        _small_run(str(tmp_path / "t.tacz"))
    after = _timer_counts()
    for name in STAGES + ("compress_level", "entropy_decode"):
        assert after[name][0] > before[name][0], name
        assert after[name][1] >= before[name][1], name
    names = set()

    def walk(span):
        names.add(span.name)
        for child in span.children:
            walk(child)

    walk(root)
    assert {"compress_level", "prequant", "branch_score", "entropy",
            "entropy_decode"} <= names


def test_disabled_registry_records_nothing_and_adds_no_work(
        tmp_path, monkeypatch):
    """With ``obs.set_enabled(False)`` the timers record nothing, never
    synchronize a stream and leave the kernels' wrapper calls as they
    were with the registry on."""
    calls = {}

    def counting(name):
        orig = getattr(ops, name)

        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return orig(*a, **k)
        return wrapper

    for name in ("lorenzo3d_codes_batched", "lorenzo3d_recon_batched",
                 "hist", "huffdec"):
        monkeypatch.setattr(ops, name, counting(name))
    was = obs.is_enabled()
    try:
        obs.set_enabled(True)
        _small_run(str(tmp_path / "on.tacz"))
        on = dict(calls)
        calls.clear()
        obs.set_enabled(False)
        before = _timer_counts()
        _small_run(str(tmp_path / "off.tacz"))
        assert _timer_counts() == before
        assert calls == on

        synced = []
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda dev=None: SimpleNamespace(
                                synchronize=lambda: synced.append(dev)))
        card = torch.device("cuda")
        hist = obsm.ENTROPY_DECODE_SECONDS.labels()
        with obsm.timed(hist, "entropy_decode", sync=card):
            pass
        assert synced == []                      # disabled: no synchronize
        obs.set_enabled(True)
        with obsm.timed(hist, "entropy_decode", sync=card):
            pass
        assert synced == [card]                  # enabled: one
        with pytest.raises(RuntimeError):
            with obsm.timed(hist, "entropy_decode", sync=card):
                raise RuntimeError("stage failed")
        assert synced == [card]                  # not while raising
        with obsm.timed(hist, "entropy_decode", sync=torch.device("cpu")):
            pass
        assert synced == [card]                  # a CPU stage never waits
    finally:
        obs.set_enabled(was)


@pytest.mark.cuda
def test_card_stage_timers_cover_the_work(tmp_path):
    """On the card each timer closes after its stage's work: the observed
    sums are at least the CUDA-event time of the kernels the stages
    launch (kernel 1 under ``prequant``, kernel 4 under
    ``entropy_decode``, the whole level under ``compress_level``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    events = {"lorenzo3d_codes_batched": [], "lorenzo3d_recon_batched": [],
              "hist": [], "huffdec": []}

    def timed_kernel(name):
        orig = getattr(ops, name)

        def wrapper(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*a, **k)
            end.record()
            events[name].append((start, end))
            return out
        return wrapper

    was = obs.is_enabled()
    obs.set_enabled(True)
    saved = {n: getattr(ops, n) for n in events}
    try:
        for name in events:
            setattr(ops, name, timed_kernel(name))
        ds = amr.synthetic_amr((64, 64, 64), densities=[0.35, 0.65],
                               refine_block=4, seed=5)
        torch.cuda.synchronize()
        before = _timer_counts()
        res = hybrid.compress_amr(ds, eb=1e-2, device="cuda")
        compress_events = {n: list(v) for n, v in events.items()}
        path = str(tmp_path / "card.tacz")
        tio.write(path, res, payload_codec="none", device="cuda")
        n_huffdec = len(events["huffdec"])
        tio.read(path, device="cuda")
        torch.cuda.synchronize()
        after = _timer_counts()
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
        obs.set_enabled(was)

    def ev_s(pairs):
        return sum(a.elapsed_time(b) for a, b in pairs) / 1e3

    def observed(stage):
        return after[stage][1] - before[stage][1]

    for stage in STAGES + ("compress_level", "entropy_decode"):
        assert after[stage][0] > before[stage][0], stage
    k1 = ev_s(compress_events["lorenzo3d_codes_batched"])
    k3 = ev_s(compress_events["hist"])
    k4 = ev_s(events["huffdec"][n_huffdec:])
    assert k1 > 0 and k3 > 0 and k4 > 0
    assert observed("prequant") >= k1
    assert observed("entropy") >= k3
    assert observed("entropy_decode") >= k4
    assert observed("compress_level") >= k1 + k3 + ev_s(
        compress_events["lorenzo3d_recon_batched"])
    assert math.isfinite(observed("branch_score"))
