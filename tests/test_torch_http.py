"""Distortion-aware serving and the HTTP surface on the port
(``repro_torch.serving.{variants,core,http_api,client}``,
``repro_torch.obs.expo``) against the reference's, on the CPU.

* ``VariantServer`` on one variant set, beside the reference's: the same
  selections, crops, errors, counters and ``fault_hook`` forwarding;
* ``AsyncServingCore``: per-level units re-merged in request order, the
  hot-swap retry, 429/503 admission semantics, as the reference's
  ``test_async_serving.py`` holds its own;
* cross-wire: the reference's ``RegionClient`` against the port's
  ``serve(...)`` on a single file, a multi-part directory and a variant
  set, and the port's client against the reference's server, on the same
  files: the same ``variant`` header, crops equal to ``read_roi`` bit for
  bit, and byte-equal 400 bodies from both servers;
* exposition: the port server's scrape parses to the same families with
  both ``expo`` modules, and the reference's round-trip property holds on
  the port's registry + ``expo``, with label values holding the line
  separators that ``str.splitlines()`` breaks at (``\\r``, ``\\x0b``,
  ``\\u2028``, ...) pinned as cases: the reference's parser splits those
  lines, the port's does not.

Servers bind port 0 on 127.0.0.1 and are shut down in ``finally``.  The
reference is imported inside fixtures and test bodies only.  The
``cuda`` test serves a tuned set over HTTP on the card and imports no
JAX (``pytest --noconftest -m cuda``).
"""
import contextlib
import functools
import json
import math
import os
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
from repro_torch.io import frontier as frt
from repro_torch.obs import expo
from repro_torch.obs import metrics as obsm
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serving import (AsyncServingCore, RegionAPIError,
                                 RegionClient, RegionServer, ServerBusy,
                                 VariantServer, serve)
from repro_torch.serving.http_api import format_box, parse_box
from repro_torch.tuning import write_variant_set

BOX = ((0, 20), (4, 28), (8, 24))
BOXES = [((0, 8), (0, 8), (0, 8)),
         ((5, 23), (11, 30), (2, 9)),
         ((24, 32), (16, 32), (0, 32))]
VARIANTS = {"hi": "psnr>=70", "lo": "psnr>=50"}
SOURCES = ["single", "multipart", "variant_set"]


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (imported here, not at module level)."""
    from repro import io as rio
    from repro.core import amr as ramr
    from repro.obs import expo as rexpo
    from repro.obs import registry as rregistry
    from repro.serving import client as rclient
    from repro.serving import http_api as rhttp
    from repro.serving import variants as rvariants
    return SimpleNamespace(io=rio, amr=ramr, expo=rexpo,
                           MetricsRegistry=rregistry.MetricsRegistry,
                           RegionClient=rclient.RegionClient,
                           RegionAPIError=rclient.RegionAPIError,
                           serve=rhttp.serve,
                           VariantServer=rvariants.VariantServer)


@pytest.fixture(scope="module")
def snaps(ref, tmp_path_factory):
    """Port-written snapshots of the reference tuning tests' 32³ dataset:
    a single file, a two-part directory and a ``hi``/``lo`` variant set,
    all with ``payload_codec="none"``."""
    rds = ref.amr.synthetic_amr((32, 32, 32), densities=[0.35, 0.65],
                                refine_block=4, seed=5)
    ds = dataset_from_arrays([(l.data, l.mask, l.ratio) for l in rds.levels])
    eb = 1e-3 * float(rds.levels[0].data.max() - rds.levels[0].data.min())
    root = str(tmp_path_factory.mktemp("http"))
    res = hybrid.compress_amr(ds, eb=eb, device="cpu")
    single = os.path.join(root, "snap.tacz")
    tio.write(single, res, payload_codec="none", device="cpu")
    multi = os.path.join(root, "snap.taczd")
    tio.write_multipart(multi, res, parts=2, payload_codec="none",
                        device="cpu")
    vset = write_variant_set(os.path.join(root, "snap.taczv"), ds, VARIANTS,
                             default="lo", payload_codec="none",
                             steps_down=4, steps_up=4, device="cpu")
    return SimpleNamespace(single=single, multipart=multi, variant_set=vset,
                           ds=ds)


@contextlib.contextmanager
def _serve(serve_fn, src, **kw):
    httpd = serve_fn(src, port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield httpd, f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.region_server.close()


def _port_serve(src, **kw):
    return serve(src, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _direct(path: str, box) -> list[np.ndarray]:
    """``read_roi`` of ``path`` (a file or a snapshot directory); the
    snapshots are never rewritten, so each box is decoded once."""
    with tio.open_snapshot(path, device="cpu") as rd:
        return [c.data.numpy() for c in rd.read_roi(box)]


# ----------------------------- variant server ------------------------------


def test_box_format_roundtrip():
    assert format_box(BOX) == "0:20,4:28,8:24"
    assert parse_box(format_box(BOX)) == BOX
    with pytest.raises(ValueError):
        parse_box("0:1,2:3")


def test_variant_server_matches_reference(ref, snaps):
    vdir = snaps.variant_set
    with VariantServer(vdir, device="cpu") as vs, \
            ref.VariantServer(vdir) as rvs:
        assert vs.default_variant == rvs.default_variant == "lo"
        assert vs.variant_names() == rvs.variant_names()
        assert vs.variants_meta() == rvs.variants_meta()
        for kw in ({"target": "psnr>=60"}, {"target": "psnr>=20"},
                   {"variant": "hi"}, {"variant": "lo"}, {}):
            crc, name, res = vs.get_regions_ex(BOXES, **kw)
            rcrc, rname, rres = rvs.get_regions_ex(BOXES, **kw)
            assert (crc, name) == (rcrc, rname)
            for per, rper in zip(res, rres):
                for c, rc in zip(per, rper):
                    assert (c.level, c.ratio, c.box) == \
                        (rc.level, rc.ratio, rc.box)
                    np.testing.assert_array_equal(c.data.numpy(), rc.data)
        assert vs.resolve("psnr>=60") == "hi"
        assert vs.snapshot_crc == rvs.snapshot_crc
        assert vs.n_levels == rvs.n_levels
        assert vs.stats()["variants"]["built"] == \
            rvs.stats()["variants"]["built"]
        assert vs.health()["role"] == "variant-server"
        assert vs.health()["checks"]["variants"] == \
            rvs.health()["checks"]["variants"]
        got = vs.get_roi(BOX)
        want = _direct(os.path.join(vdir, "lo.tacz"), BOX)
        for c, w in zip(got, want):
            np.testing.assert_array_equal(c.data.numpy(), w)
        np.testing.assert_array_equal(vs.get_region(1, BOX).data.numpy(),
                                      want[1])


def test_variant_server_unknown_variant(ref, snaps):
    with VariantServer(snaps.variant_set, device="cpu") as vs, \
            ref.VariantServer(snaps.variant_set) as rvs:
        with pytest.raises(ValueError, match="unknown variant") as got:
            vs.get_regions_ex([BOX], variant="nope")
        with pytest.raises(ValueError) as want:
            rvs.get_regions_ex([BOX], variant="nope")
        assert str(got.value) == str(want.value)


def test_variant_server_unsatisfiable_counts(ref, snaps):
    before = obsm.VARIANT_UNSATISFIED.labels().value
    with VariantServer(snaps.variant_set, device="cpu") as vs, \
            ref.VariantServer(snaps.variant_set) as rvs:
        with pytest.raises(frt.TargetUnsatisfiable) as got:
            vs.get_regions_ex([BOX], target="psnr>=500")
        with pytest.raises(ValueError) as want:
            rvs.get_regions_ex([BOX], target="psnr>=500")
        assert got.value.best == want.value.best
        assert str(got.value) == str(want.value)
    assert obsm.VARIANT_UNSATISFIED.labels().value == before + 1


def test_variant_server_fault_hook_forwards(snaps):
    with VariantServer(snaps.variant_set, device="cpu") as vs:
        vs.server("lo")                  # built before the hook is set
        calls = []

        def boom():
            calls.append(1)
            raise RuntimeError("injected fault")

        vs.fault_hook = boom
        for kw in ({"target": "psnr>=60"}, {"variant": "lo"}):
            with pytest.raises(RuntimeError, match="injected fault"):
                vs.get_regions_ex([BOX], **kw)
        assert len(calls) == 2
        vs.fault_hook = None
        _, name, _ = vs.get_regions_ex([BOX], target="psnr>=60")
        assert name == "hi"


# ------------------------------ serving core -------------------------------


class _FakeServer:
    """Levels-aware stand-in recording which unit calls the core makes."""

    n_levels = 3

    def __init__(self, crcs=(7,)):
        self.calls = []
        self._crcs = list(crcs)
        self._lock = threading.Lock()

    def get_regions_with_crc(self, boxes, levels=None):
        with self._lock:
            self.calls.append(tuple(levels))
            crc = self._crcs[0] if len(self._crcs) == 1 \
                else self._crcs.pop(0)
        return crc, [[f"L{li}" for li in levels] for _ in boxes]


@pytest.fixture()
def metrics_enabled():
    """Leave the process-wide registry the way we found it."""
    was = obs.is_enabled()
    obs.set_enabled(True)
    yield
    obs.set_enabled(was)


def test_core_splits_per_level_and_merges_in_request_order():
    core = AsyncServingCore(_FakeServer(), decode_workers=2)
    try:
        crc, vname, results = core.execute([0, 1], levels=[2, 0, 1])
        assert (crc, vname) == (7, None)
        assert results == [["L2", "L0", "L1"], ["L2", "L0", "L1"]]
        assert sorted(core.server.calls) == [(0,), (1,), (2,)]
        _, _, results = core.execute([0])
        assert results == [["L0", "L1", "L2"]]
        assert core.stats() == {"decode_workers": 2, "queue_depth": 16,
                                "capacity": 18, "pending": 0,
                                "draining": False}
    finally:
        core.close()


def test_core_crc_race_retries_once_then_raises():
    core = AsyncServingCore(_FakeServer(crcs=[1, 2, 2]), decode_workers=1)
    try:
        crc, _, _ = core.execute([0], levels=[0, 1])
        assert crc == 2
    finally:
        core.close()
    core = AsyncServingCore(_FakeServer(crcs=[1, 2, 3, 4, 5]),
                            decode_workers=1)
    try:
        with pytest.raises(IOError, match="hot-swap"):
            core.execute([0], levels=[0, 1])
    finally:
        core.close()


def test_core_queue_full_rejects_with_429_semantics(metrics_enabled):
    release = threading.Event()
    entered = threading.Event()

    class _Blocking(_FakeServer):
        def get_regions_with_crc(self, boxes, levels=None):
            entered.set()
            release.wait(5)
            return super().get_regions_with_crc(boxes, levels=levels)

    core = AsyncServingCore(_Blocking(), decode_workers=1, queue_depth=0,
                            retry_after_s=0.2)
    t = threading.Thread(target=core.execute, args=([0],),
                         kwargs={"levels": [0]}, daemon=True)
    t.start()
    assert entered.wait(5)
    before = obsm.SERVER_BACKPRESSURE.labels("queue_full").value
    with pytest.raises(ServerBusy) as exc_info:
        core.execute([0], levels=[1])
    exc = exc_info.value
    assert (exc.status, exc.reason) == (429, "queue_full")
    assert exc.retry_after >= 1
    assert obsm.SERVER_BACKPRESSURE.labels("queue_full").value == before + 1
    assert obsm.SERVER_QUEUE_DEPTH.labels().value == 1
    release.set()
    t.join(timeout=5)
    assert core.pending == 0
    core.close()


def test_core_draining_rejects_with_503_semantics():
    core = AsyncServingCore(_FakeServer(), decode_workers=1)
    core.close()
    with pytest.raises(ServerBusy) as exc_info:
        core.execute([0], levels=[0])
    assert (exc_info.value.status, exc_info.value.reason) == \
        (503, "draining")


def test_core_rejects_targets_without_distortion_support():
    core = AsyncServingCore(_FakeServer(), decode_workers=1)
    try:
        with pytest.raises(ValueError, match="distortion targets"):
            core.execute([0], target="psnr>=60")
    finally:
        core.close()


def test_http_backpressure_429_retry_after_header(snaps, metrics_enabled):
    with _serve(_port_serve, snaps.single, decode_workers=1, queue_depth=0,
                retry_after_s=0.25) as (httpd, url):
        httpd.region_server.fault_hook = lambda: time.sleep(0.4)
        cli = RegionClient(url, busy_retries=0)
        before = obsm.SERVER_BACKPRESSURE.labels("queue_full").value
        results, failures = [], []
        barrier = threading.Barrier(4)

        def request():
            barrier.wait()
            try:
                results.append(cli.regions(BOXES[:1], levels=[0]))
            except RegionAPIError as exc:
                failures.append(exc)

        threads = [threading.Thread(target=request) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results and failures
        for exc in failures:
            assert exc.code == 429
            assert int(exc.headers["Retry-After"]) >= 1
            assert json.loads(exc.body_excerpt)["reason"] == "queue_full"
        assert obsm.SERVER_BACKPRESSURE.labels("queue_full").value \
            >= before + len(failures)


def test_client_busy_retry_waits_out_saturation(snaps):
    with _serve(_port_serve, snaps.single, decode_workers=1, queue_depth=0,
                retry_after_s=0.1) as (httpd, url):
        httpd.region_server.fault_hook = lambda: time.sleep(0.05)
        cli = RegionClient(url, busy_retries=20, busy_backoff_cap=0.1)
        results, failures = [], []
        barrier = threading.Barrier(4)

        def request():
            barrier.wait()
            try:
                results.append(cli.regions(BOXES[:1], levels=[0]))
            except Exception as exc:  # noqa: BLE001 — any failure fails
                failures.append(exc)

        threads = [threading.Thread(target=request) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not failures, failures
        assert len(results) == 4


def test_oversized_batch_split_is_bit_identical(snaps, metrics_enabled):
    with _serve(_port_serve, snaps.single) as (_httpd, url), \
            RegionServer(snaps.single, device="cpu") as direct:
        before = obsm.SERVER_DECODE_UNITS.labels().value
        got = RegionClient(url).regions(BOXES)
        want = direct.get_regions(BOXES)
        assert obsm.SERVER_DECODE_UNITS.labels().value \
            == before + direct.n_levels
        for per_got, per_want in zip(got, want):
            for g, w in zip(per_got, per_want):
                assert g.level == w.level and g.box == w.box
                assert isinstance(g.data, np.ndarray)
                np.testing.assert_array_equal(g.data, w.data.numpy())


# -------------------------------- cross wire -------------------------------


def _client_pass(client_cls, err_cls, url: str, src: str, path: str):
    """One client's requests against one endpoint; returns the headers,
    the crops and the 400 bodies it saw."""
    cli = client_cls(url)
    out = {"meta_levels": cli.meta()["levels"], "bodies": []}
    is_set = src == "variant_set"
    kw = {"target": "psnr>=60"} if is_set else {}
    header, crops = cli.regions_ex(BOXES, **kw)
    out["variant"] = header["variant"]
    out["snapshot_crc"] = header["snapshot_crc"]
    chosen = os.path.join(path, "hi.tacz") if is_set else path
    for box, per in zip(BOXES, crops):
        for c, w in zip(per, _direct(chosen, box)):
            assert isinstance(c.data, np.ndarray)
            np.testing.assert_array_equal(c.data, w)
    one = cli.region(1, BOX, **kw)
    np.testing.assert_array_equal(one.data, _direct(chosen, BOX)[1])
    if is_set:
        header, crops = cli.regions_ex([BOX], variant="lo")
        out["pinned"] = header["variant"]
        np.testing.assert_array_equal(
            crops[0][0].data, _direct(os.path.join(path, "lo.tacz"), BOX)[0])
        out["default"] = cli.regions_ex([BOX])[0]["variant"]
        out["meta_variants"] = cli.meta()["variants"]
    # a single snapshot without a frontier serves any well-formed target
    # (counted as a fallback); only a variant set refuses psnr>=500
    unmet = "psnr>=500" if is_set else "psnr==60"
    for bad in ({"target": unmet}, {"target": "psnr==60"},
                {"variant": "nope"}, {"levels": [9]}):
        with pytest.raises(err_cls) as ei:
            cli.regions([BOX], **bad)
        assert ei.value.code == 400
        out["bodies"].append(ei.value.body_excerpt)
    with pytest.raises(err_cls) as ei:
        cli.region(0, BOX, target=unmet)
    out["bodies"].append((ei.value.code, ei.value.body_excerpt))
    return out


@pytest.mark.parametrize("src", SOURCES)
def test_reference_client_against_port_server(ref, snaps, src):
    path = getattr(snaps, src)
    with _serve(_port_serve, path, cache_bytes=16 << 20) as (_, url):
        got = _client_pass(ref.RegionClient, ref.RegionAPIError, url, src,
                           path)
    with _serve(ref.serve, path, cache_bytes=16 << 20) as (_, url):
        want = _client_pass(ref.RegionClient, ref.RegionAPIError, url, src,
                            path)
    assert got == want
    if src == "variant_set":
        assert (got["variant"], got["pinned"], got["default"]) == \
            ("hi", "lo", None)
        assert json.loads(got["bodies"][0])["best"] is not None
    else:
        assert got["variant"] is None


@pytest.mark.parametrize("src", SOURCES)
def test_port_client_against_reference_server(ref, snaps, src):
    path = getattr(snaps, src)
    with _serve(ref.serve, path, cache_bytes=16 << 20) as (_, url):
        got = _client_pass(RegionClient, RegionAPIError, url, src, path)
        want = _client_pass(ref.RegionClient, ref.RegionAPIError, url, src,
                            path)
    assert got == want


def test_port_client_surface(snaps):
    with _serve(_port_serve, snaps.single) as (_httpd, url):
        cli = RegionClient(url + "/")
        assert cli.health()["status"] == "ok"
        assert cli.stats()["misses"] >= 0
        crc, crops = cli.regions_meta([BOX], levels=[0], request_id="rid-1")
        with tio.TACZReader(snaps.single, device="cpu") as rd:
            assert crc == rd.index_crc
        header, _ = cli.regions_ex([BOX], request_id="rid-1")
        assert header["request_id"] == "rid-1"
        with pytest.raises(RegionAPIError) as ei:
            cli._get("/v1/nope")
        assert ei.value.code == 404 and "unknown path" in str(ei.value)
    with pytest.raises(ValueError, match="base_url"):
        RegionClient("ftp://x")


# ------------------------------- exposition --------------------------------


def test_port_scrape_parses_alike_in_both_packages(ref, snaps,
                                                   metrics_enabled):
    with _serve(_port_serve, snaps.variant_set) as (_, url):
        cli = RegionClient(url)
        cli.regions(BOXES, target="psnr>=60")
        with pytest.raises(RegionAPIError):
            cli.regions([BOX], target="psnr>=500")
        text = cli.metrics_text()
        fams = cli.metrics()
    assert expo.to_snapshot(expo.parse(text)) == \
        ref.expo.to_snapshot(ref.expo.parse(text))
    for name in ("tacz_http_requests_total", "tacz_http_request_seconds",
                 "tacz_server_decode_units_total",
                 "tacz_variant_requests_total"):
        assert name in fams
    assert fams["tacz_variant_requests_total"].get(variant="hi") >= 1
    assert fams["tacz_http_requests_total"].get(
        route="/v1/regions", status="400") >= 1


def _roundtrip(reg: MetricsRegistry) -> None:
    parsed = expo.parse(reg.render())
    assert expo.to_snapshot(parsed) == reg.snapshot()


def _build(registry_cls, spec):
    reg = registry_cls()
    for name, kind, labels, children, bounds in spec:
        if kind == "counter":
            fam = reg.counter(name, f"help for {name}", labels=labels)
            for values, samples in children:
                child = fam.labels(*values)
                for v in samples:
                    child.inc(abs(v))
        elif kind == "gauge":
            fam = reg.gauge(name, f"help\nfor \\ {name}", labels=labels)
            for values, samples in children:
                child = fam.labels(*values)
                for v in samples:
                    child.set(v)
        else:
            fam = reg.histogram(name, f"help for {name}", labels=labels,
                                buckets=bounds)
            for values, samples in children:
                child = fam.labels(*values)
                for v in samples:
                    child.observe(abs(v))
    return reg


# the reference test's corpus, plus every character str.splitlines()
# breaks at besides "\n"
_LINE_BREAKS = ["\r", "\x0b", "\x0c", "\x1c", "\x1d", "\x1e", "\x85",
                "\u2028", "\u2029", "\r\n"]
_TRICKY = ['', 'a', 'with"quote', 'back\\slash', 'new\nline', 'trailing\\',
           '\\', '\\n', 'le="1"', '{b,r=a}', ' ', 'unié☃'] + \
    [f"x{c}y" for c in _LINE_BREAKS]


def _random_spec(rng: random.Random):
    fams = []
    names = rng.sample([f"fam_{chr(97 + i)}" for i in range(8)],
                       rng.randint(1, 4))
    for name in names:
        kind = rng.choice(["counter", "gauge", "histogram"])
        labels = tuple(rng.sample(["alpha", "beta", "gamma"],
                                  rng.randint(0, 2)))
        children, seen = [], set()
        for _ in range(rng.randint(0, 3)):
            values = tuple(rng.choice(_TRICKY) if rng.random() < 0.7
                           else str(rng.random()) for _ in labels)
            if values in seen:
                continue
            seen.add(values)
            samples = [rng.uniform(-1e6, 1e6) * 10 ** rng.randint(-9, 9)
                       for _ in range(rng.randint(0, 4))]
            if rng.random() < 0.2:
                samples.append(float("inf"))
            children.append((values, samples))
        bounds = tuple(sorted({abs(rng.gauss(0, 10)) + 1e-6
                               for _ in range(rng.randint(0, 4))}))
        fams.append((name, kind, labels, children, bounds))
    return fams


@pytest.mark.parametrize("seed", range(40))
def test_property_roundtrip_random(seed):
    _roundtrip(_build(MetricsRegistry, _random_spec(random.Random(seed))))


@pytest.mark.parametrize("value", ["\r", "\x0b", "\u2028"]
                         + _LINE_BREAKS[2:7] + _LINE_BREAKS[8:]
                         + ["a\rb\nc", "\r\r", "end\u2029"])
def test_label_value_with_line_separator_roundtrips(value):
    spec = [("d", "gauge", ("a",), [((value,), [1.5])], ()),
            ("h", "histogram", ("a",), [((value,), [0.5, 2.0])], (1.0,)),
            ("c", "counter", ("a", "b"), [((value, "x"), [3.0])], ())]
    reg = _build(MetricsRegistry, spec)
    _roundtrip(reg)
    assert expo.parse(reg.render())["d"].get(a=value) == 1.5


@pytest.mark.parametrize("value", ["\r", "\x0b", "\u2028"])
def test_reference_parser_splits_line_separators(ref, value):
    """The divergence the port does not copy: the reference's parser cuts
    such a sample line in two (``str.splitlines()``)."""
    reg = _build(ref.MetricsRegistry,
                 [("d", "gauge", ("a",), [((value,), [1.0])], ())])
    with pytest.raises(ValueError, match="malformed"):
        ref.expo.parse(reg.render())
    # the port's parser reads the reference's own rendering
    assert expo.to_snapshot(expo.parse(reg.render())) == reg.snapshot()


def test_port_parses_reference_bodies_alike(ref):
    """Every body the reference parses, the port parses to the same
    families: the reference registry's renders, "\\r\\n" line ends,
    timestamps, untyped samples and unknown comments."""
    for seed in range(20):
        spec = _random_spec(random.Random(1000 + seed))
        spec = [(n, k, lb, [(tuple(v.replace("\r", "").replace("\x0b", "")
                                   for v in vals), s)
                            for vals, s in ch], b)
                for n, k, lb, ch, b in spec]
        text = _build(ref.MetricsRegistry, spec).render()
        for body in (text, text.replace("\n", "\r\n")):
            try:
                want = ref.expo.to_snapshot(ref.expo.parse(body))
            except ValueError:
                continue        # a separator the reference cannot parse
            assert expo.to_snapshot(expo.parse(body)) == want
    body = ("# HELP up Up.\n# TYPE up gauge\nup 1 1700000000\n"
            "# EOF-ish comment\n\nloose{a=\"b\"} 2\n")
    assert expo.to_snapshot(expo.parse(body)) == \
        ref.expo.to_snapshot(ref.expo.parse(body))


def test_property_roundtrip_hypothesis():
    """The reference's hypothesis property, on the port's registry and
    parser, over the full unicode label alphabet."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")
    name_st = st.from_regex(r"[a-z][a-z0-9_]{0,15}", fullmatch=True)
    value_st = st.text(alphabet=st.characters(blacklist_categories=("Cs",)),
                       max_size=12)
    finite = st.floats(allow_nan=False, allow_infinity=False)

    @st.composite
    def spec_st(draw):
        n = draw(st.integers(1, 4))
        names = draw(st.lists(name_st, min_size=n, max_size=n, unique=True))
        fams = []
        for name in names:
            kind = draw(st.sampled_from(["counter", "gauge", "histogram"]))
            labels = draw(st.lists(name_st.filter(lambda s: s != "le"),
                                   min_size=0, max_size=2, unique=True))
            children = draw(st.lists(
                st.tuples(st.lists(value_st, min_size=len(labels),
                                   max_size=len(labels)).map(tuple),
                          st.lists(finite, min_size=0, max_size=4)),
                min_size=0, max_size=3, unique_by=lambda t: t[0]))
            bounds = tuple(sorted(set(draw(st.lists(
                st.floats(min_value=1e-6, max_value=1e6, allow_nan=False,
                          allow_infinity=False), min_size=0, max_size=4)))))
            fams.append((name, kind, tuple(labels), children, bounds))
        return fams

    @hyp.settings(max_examples=60, deadline=None, derandomize=True)
    @hyp.given(spec=spec_st())
    def check(spec):
        _roundtrip(_build(MetricsRegistry, spec))

    check()


def test_parser_errors_and_quantiles():
    with pytest.raises(ValueError, match="malformed"):
        expo.parse('x{a="1"\n')
    with pytest.raises(ValueError, match="Inf"):
        expo.parse('# TYPE h histogram\nh_bucket{le="1"} 1\n')
    reg = MetricsRegistry()
    h = reg.histogram("lat", "Latency.", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 0.5, 5.0):
        h.observe(v)
    got = expo.parse(reg.render())["lat"].get()
    assert got.counts == [1, 2, 1] and got.count == 4
    assert math.isinf(got.quantile(1.0)) or got.quantile(1.0) >= 1.0


# ---------------------------------- card -----------------------------------


@pytest.mark.cuda
def test_variant_set_served_over_http_on_card(tmp_path):
    """A set tuned and written on the card, served over HTTP on the card:
    the target picks ``hi`` and every crop equals ``read_roi`` of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ds = amr.synthetic_amr((32, 32, 32), densities=[0.35, 0.65],
                           refine_block=4, seed=5)
    vset = write_variant_set(str(tmp_path / "snap.taczv"), ds, VARIANTS,
                             default="lo", payload_codec="none",
                             steps_down=4, steps_up=4, device="cuda")
    with _serve(serve, vset, device="cuda") as (httpd, url):
        assert httpd.region_server.server("hi").device.type == "cuda"
        cli = RegionClient(url)
        header, crops = cli.regions_ex(BOXES, target="psnr>=60")
        assert header["variant"] == "hi"
        for box, per in zip(BOXES, crops):
            want = tio.read_roi(os.path.join(vset, "hi.tacz"), box,
                                device="cuda")
            for c, w in zip(per, want):
                np.testing.assert_array_equal(c.data, w.data.cpu().numpy())
        header, _ = cli.regions_ex([BOX], variant="lo")
        assert header["variant"] == "lo"
        for bad in ("psnr>=500", "psnr==60"):
            with pytest.raises(RegionAPIError) as ei:
                cli.regions([BOX], target=bad)
            assert ei.value.code == 400
