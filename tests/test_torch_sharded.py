"""Sharded region serving on the port (``repro_torch.serving.sharded``:
``ShardedRegionRouter`` over shard-filtered ``RegionServer`` endpoints)
against the reference's, on the CPU.

Each test mirrors one of the reference's ``tests/test_sharded_serving.py``
on a 32³ snapshot the port writes (``payload_codec="none"``), with port
servers on ``device="cpu"``:

* the router's crops equal a single unsharded server's (the port's and the
  reference's) bit for bit for 1–4 shards, with one shard unreachable,
  with a dead primary and a live replica, with load balancing and
  demotion, and with a shard missing from the endpoint dict;
  ``local_fallback=False`` raises; bad levels raise; shards cache only
  their own keys; a hot swap goes through the router; a stale shard
  generation is routed around;
* cross-package fleets: the reference's router over port servers, the
  port's router over the reference's servers and over a mixed fleet (one
  shard of each), all against the reference's single server;
* the fallback decodes each (shard, level) group with one call of
  kernel 4's wrapper; a mounted port router answers ``/v1/meta``,
  ``/v1/stats``, ``/v1/metrics`` and ``/v1/health`` as a mounted
  reference router does; variant sets and snapshot directories route.

Port shard servers are warmed in process before traffic (the plain
decoder walks a payload at about 0.2 ms a symbol on the CPU), so every
client socket keeps a timeout of 2 s; dead endpoints are closed loopback
ports that refuse at once.  The reference is imported inside fixtures and
test bodies only; the ``cuda`` tests import no JAX
(``pytest --noconftest -m cuda``).
"""
import contextlib
import os
import socket
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import io as tio
from repro_torch.convert import dataset_from_arrays
from repro_torch.core import amr, hybrid
from repro_torch.io import format as fmt
from repro_torch.io.reader import WHOLE_LEVEL
from repro_torch.kernels import ops
from repro_torch.serving import (RegionClient, RegionServer, ShardMap,
                                 ShardedRegionRouter, serve)
from repro_torch.serving import sharded
from repro_torch.tuning import write_variant_set

BOXES = [((0, 8), (0, 8), (0, 8)),
         ((5, 23), (11, 30), (2, 9)),
         ((24, 32), (16, 32), (0, 32)),
         ((0, 32), (0, 32), (0, 32)),
         ((14, 18), (14, 18), (14, 18)),
         ((40, 50), (0, 4), (0, 4))]          # beyond the extent
TIMEOUT = 2.0


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (imported here, not at module level)."""
    from repro import io as rio
    from repro.core import amr as ramr
    from repro.core import hybrid as rhybrid
    from repro.serving import RegionClient as RClient
    from repro.serving import RegionServer as RServer
    from repro.serving import ShardedRegionRouter as RRouter
    from repro.serving import ShardMap as RShardMap
    from repro.serving import serve as rserve
    return SimpleNamespace(io=rio, amr=ramr, hybrid=rhybrid,
                           RegionServer=RServer, RegionClient=RClient,
                           ShardedRegionRouter=RRouter, ShardMap=RShardMap,
                           serve=rserve)


@pytest.fixture(scope="module")
def snap(ref, tmp_path_factory):
    """The reference tests' 32³ dataset (two levels, seed 5), compressed
    and written by the port; ``want`` holds the reference single server's
    crops of :data:`BOXES` as numpy arrays."""
    rds = ref.amr.synthetic_amr((32, 32, 32), densities=[0.35, 0.65],
                                refine_block=4, seed=5)
    ds = dataset_from_arrays([(l.data, l.mask, l.ratio) for l in rds.levels])
    eb = 1e-3 * float(rds.levels[0].data.max() - rds.levels[0].data.min())
    res = hybrid.compress_amr(ds, eb=eb, device="cpu")
    path = os.path.join(str(tmp_path_factory.mktemp("sharded")), "s.tacz")
    tio.write(path, res, payload_codec="none", device="cpu")
    with ref.RegionServer(path) as single:
        want = [[(c.level, c.ratio, c.box, np.asarray(c.data)) for c in per]
                for per in single.get_regions(BOXES)]
    return SimpleNamespace(path=path, ds=ds, eb=eb, res=res, want=want)


def _port_serve(src, **kw):
    return serve(src, device="cpu", **kw)


@contextlib.contextmanager
def shard_fleet(serve_fns, path, shard_map, *, warm=BOXES,
                cache_bytes=16 << 20, auto_reload=True):
    """One HTTP endpoint per shard, ``serve_fns[sid]`` building it (the
    port's or the reference's ``serve``), each warmed in process on
    ``warm``; yields ``({shard_id: url}, {shard_id: httpd})``."""
    servers, urls = {}, {}
    try:
        for sid in shard_map.shards:
            httpd = serve_fns[sid](path, port=0, cache_bytes=cache_bytes,
                                   auto_reload=auto_reload,
                                   shard_map=shard_map, shard_id=sid)
            threading.Thread(target=httpd.serve_forever,
                             daemon=True).start()
            servers[sid] = httpd
            urls[sid] = f"http://127.0.0.1:{httpd.server_address[1]}"
            if warm:
                httpd.region_server.get_regions(warm)
        yield urls, servers
    finally:
        for httpd in servers.values():
            httpd.shutdown()
            httpd.server_close()
            httpd.region_server.close()


def port_fleet(path, shard_map, **kw):
    return shard_fleet({sid: _port_serve for sid in shard_map.shards},
                       path, shard_map, **kw)


def dead_url() -> str:
    """An endpoint URL that refuses connections at once."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return f"http://127.0.0.1:{port}"


def _host(data) -> np.ndarray:
    return data.numpy() if isinstance(data, torch.Tensor) else \
        np.asarray(data)


def _assert_regions(got, want):
    """``got`` (ROILevel lists, tensors or arrays) equals ``want``
    (``(level, ratio, box, array)`` tuples) bit for bit."""
    assert len(got) == len(want)
    for per_got, per_want in zip(got, want):
        assert len(per_got) == len(per_want)
        for g, (level, ratio, box, arr) in zip(per_got, per_want):
            assert (g.level, g.ratio, tuple(g.box)) == (level, ratio, box)
            data = _host(g.data)
            assert data.dtype == np.float32
            np.testing.assert_array_equal(data, arr)


def _router(path, m, urls, **kw):
    return ShardedRegionRouter(path, m, urls, device="cpu",
                               timeout=TIMEOUT, **kw)


# --------------------------- router vs single server ------------------------


def test_port_single_server_equals_reference(snap):
    with RegionServer(snap.path, device="cpu") as single:
        _assert_regions(single.get_regions(BOXES), snap.want)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_router_bit_identical_to_single_server(snap, n_shards):
    m = ShardMap([f"s{i}" for i in range(n_shards)], seed=2)
    with port_fleet(snap.path, m) as (urls, _), \
            _router(snap.path, m, urls) as router:
        got = router.get_regions(BOXES)
        _assert_regions(got, snap.want)
        assert all(c.data.device.type == "cpu" for per in got for c in per)
        _assert_regions(router.get_regions(BOXES), snap.want)   # again
        assert router.counters["local_fallbacks"] == 0
        assert router.counters["shard_requests"] > 0
        one = router.get_region(1, BOXES[1])
        np.testing.assert_array_equal(one.data.numpy(), snap.want[1][1][3])
        roi = router.get_roi(BOXES[3])
        _assert_regions([roi], [snap.want[3]])


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_router_with_one_shard_unreachable(snap, n_shards):
    """A dead shard costs throughput only: its rectangles decode from the
    local file, bit-identically."""
    m = ShardMap([f"s{i}" for i in range(n_shards)], seed=2)
    with port_fleet(snap.path, m) as (urls, _):
        urls = dict(urls, **{m.shards[0]: dead_url()})
        with _router(snap.path, m, urls) as router:
            _assert_regions(router.get_regions(BOXES), snap.want)
            assert router.counters["local_fallbacks"] > 0
            assert router.counters["endpoint_failures"] > 0


def test_router_replica_retry_avoids_fallback(snap):
    m = ShardMap(["s0", "s1"], seed=2)
    with port_fleet(snap.path, m) as (urls, _):
        routed = {"s0": [dead_url(), urls["s0"]], "s1": urls["s1"]}
        with _router(snap.path, m, routed) as router:
            _assert_regions(router.get_regions(BOXES), snap.want)
            assert router.counters["endpoint_failures"] > 0
            assert router.counters["local_fallbacks"] == 0
            assert router.counters["retries"] > 0


def test_router_load_balances_across_replicas(snap):
    """With ``load_balance=True`` both replicas of a shard see reads and
    the bytes are unchanged."""
    m = ShardMap(["s0", "s1"], seed=2)
    with port_fleet(snap.path, m) as (urls, _), \
            port_fleet(snap.path, ShardMap(["s0"], seed=2),
                       warm=BOXES[:3]) as (r_urls, r_servers):
        routed = {"s0": [urls["s0"], r_urls["s0"]], "s1": urls["s1"]}
        replica = r_servers["s0"].region_server.cache
        hits = replica.stats()["hits"]
        with _router(snap.path, m, routed, load_balance=True) as router:
            for _ in range(4):
                _assert_regions(router.get_regions(BOXES[:3]),
                                snap.want[:3])
            assert router.counters["local_fallbacks"] == 0
            assert router.counters["endpoint_failures"] == 0
            assert router.stats()["unhealthy_endpoints"] == []
            assert router._endpoint_order("s1") == [urls["s1"]]
        assert replica.stats()["hits"] > hits    # the replica saw reads


def test_router_load_balance_demotes_dead_endpoint(snap):
    m = ShardMap(["s0", "s1"], seed=2)
    with port_fleet(snap.path, m) as (urls, _):
        routed = {"s0": [dead_url(), urls["s0"]], "s1": urls["s1"]}
        with _router(snap.path, m, routed, load_balance=True) as router:
            for _ in range(3):
                _assert_regions(router.get_regions(BOXES), snap.want)
            assert router.counters["local_fallbacks"] == 0
            assert router.counters["endpoint_failures"] > 0
            assert router.counters["demotions"] == 1
            assert router.stats()["unhealthy_endpoints"] == \
                [routed["s0"][0]]
            # the demoted endpoint walks last, whatever the rotation
            for _ in range(3):
                assert router._endpoint_order("s0")[-1] == routed["s0"][0]


def test_router_missing_endpoint_uses_local_fallback(snap):
    m = ShardMap(["s0", "s1"], seed=2)
    with port_fleet(snap.path, m) as (urls, _):
        with _router(snap.path, m, {"s0": urls["s0"]}) as router:
            _assert_regions(router.get_regions(BOXES), snap.want)
            assert router.counters["local_fallbacks"] > 0
            assert router.counters["endpoint_failures"] == 0


def test_router_without_local_fallback_raises(snap):
    m = ShardMap(["s0", "s1"], seed=2)
    with port_fleet(snap.path, m) as (urls, _):
        bad = dict(urls, s0=dead_url())
        with _router(snap.path, m, bad, local_fallback=False) as router:
            with pytest.raises(RuntimeError, match="unreachable"):
                router.get_regions([((0, 32), (0, 32), (0, 32))])


def test_router_rejects_bad_levels(snap):
    m = ShardMap(["s0"], seed=0)
    with _router(snap.path, m, {}) as router:
        with pytest.raises(ValueError, match="out of range"):
            router.get_regions([BOXES[0]], levels=[99])
        with pytest.raises(ValueError, match="out of range"):
            router.get_regions([BOXES[0]], levels=[-1])
        assert router.counters["batches"] == 0


def test_shard_servers_cache_only_owned_keys(snap):
    m = ShardMap(["s0", "s1", "s2"], seed=9)
    with tio.TACZReader(snap.path, device="cpu") as rd:
        owned = {sid: {k for k in rd.subblock_keys() if m.owner(k) == sid}
                 for sid in m.shards}
    with port_fleet(snap.path, m) as (urls, servers), \
            _router(snap.path, m, urls) as router:
        _assert_regions(router.get_regions(BOXES), snap.want)
        cached = []
        for sid, httpd in servers.items():
            for key in httpd.region_server.cache._od:
                assert (key[1], key[2]) in owned[sid], (sid, key)
                cached.append((key[1], key[2]))
        assert cached and len(cached) == len(set(cached))


# -------------------------- the fallback's decode ---------------------------


def test_fallback_decodes_a_group_with_one_kernel4_call(snap, monkeypatch):
    """With no endpoint at all every (shard, level) group falls back, and
    each decodes its sub-blocks with one call of kernel 4's wrapper and
    one of kernel 2's a shape group — not one a part."""
    calls = {"huffdec": 0, "recon": 0}
    huffdec, recon = ops.huffdec, ops.lorenzo3d_recon_batched

    def counting_huffdec(*a, **k):
        calls["huffdec"] += 1
        return huffdec(*a, **k)

    def counting_recon(*a, **k):
        calls["recon"] += 1
        return recon(*a, **k)

    monkeypatch.setattr(ops, "huffdec", counting_huffdec)
    monkeypatch.setattr(ops, "lorenzo3d_recon_batched", counting_recon)
    m = ShardMap(["s0", "s1", "s2"], seed=2)
    with _router(snap.path, m, {}) as router:
        rd = router.reader
        plans = router._planner.plan([(li, b) for b in BOXES[:3]
                                      for li in range(rd.n_levels)])
        groups: dict = {}
        for p in plans:
            for sbi, _ in p.tasks:
                groups.setdefault((m.owner((p.level, sbi)), p.level),
                                  set()).add(sbi)
        parts = sum(len(p.tasks) for p in plans)
        huffman_groups = sum(
            any(rd.levels[li].subblocks[s].codec == fmt.CODEC_HUFFMAN
                for s in sbis) for (_, li), sbis in groups.items())
        shape_groups = sum(len({(rd.subblock_shape(li, s),
                                 rd.levels[li].subblocks[s].branch)
                                for s in sbis})
                           for (_, li), sbis in groups.items())
        _assert_regions(router.get_regions(BOXES[:3]), snap.want[:3])
        assert router.counters["local_fallbacks"] == len(groups)
    assert 0 < calls["huffdec"] == huffman_groups <= len(groups) < parts
    assert 0 < calls["recon"] <= shape_groups


def test_local_crops_equal_read_level_box(snap):
    """Each fallback crop equals ``read_level_box`` of its rectangle and
    the slice of the whole decoded level (assembled by the placement,
    not by the one-sub-block path the crops take), also for a sub-block
    several boxes cut at different corners."""
    with tio.TACZReader(snap.path, device="cpu") as rd:
        li = 0
        small = rd.intersecting_subblocks(li, rd.level_box(li, BOXES[1]))
        whole = dict(rd.intersecting_subblocks(li, rd.level_box(li,
                                                                BOXES[3])))
        parts = [sharded._Part(0, isect, sbi) for sbi, isect in small]
        parts += [sharded._Part(1, whole[sbi], sbi) for sbi, _ in small]
        crops = sharded.ShardedRegionRouter._local_crops(rd, li, parts)
        assert len(crops) == len(parts)
        level = rd.read_level(li)
        for part, crop in zip(parts, crops):
            assert torch.equal(crop, rd.read_level_box(li, part.isect))
            assert torch.equal(crop, level[tuple(slice(lo, hi)
                                                 for lo, hi in part.isect)])
            assert crop.is_contiguous()
        # the same sub-block cut at two corners decodes once, to the
        # further one
        assert any(p.isect != q.isect
                   for p, q in zip(parts, parts[len(small):]))


def _scan(rd, li, lbox):
    """Every sub-block of level ``li`` meeting ``lbox``, by a plain scan
    of the index: the reference for the reader's unit-block map."""
    out = []
    for i, sb in enumerate(rd.levels[li].subblocks):
        lo = tuple(max(b0, o) for (b0, _), o in zip(lbox, sb.origin))
        hi = tuple(min(b1, o + n) for (_, b1), o, n
                   in zip(lbox, sb.origin, sb.size))
        if all(h > l for l, h in zip(lo, hi)):
            out.append((i, tuple(zip(lo, hi))))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_intersecting_subblocks_map_equals_scan(snap, seed):
    """The unit-block map the reader answers small boxes from gives the
    scan's sub-blocks and intersections, in index order, for small and
    large boxes, boxes past the extent and every part a router asks."""
    rng = np.random.default_rng(seed)
    with tio.TACZReader(snap.path, device="cpu") as rd:
        for li in range(rd.n_levels):
            shape = rd.levels[li].shape
            boxes = []
            for _ in range(60):
                lo = [int(rng.integers(-2, s)) for s in shape]
                ext = [int(rng.integers(1, rng.choice([3, 9, s + 3])))
                       for s in shape]
                boxes.append(tuple((l, l + e) for l, e in zip(lo, ext)))
            boxes += [isect for _, isect in _scan(rd, li, tuple(
                (0, s) for s in shape))]
            small = 0
            for box in boxes:
                got = rd.intersecting_subblocks(li, box)
                assert got == _scan(rd, li, box), box
                small += all(hi - lo <= 4 * rd.levels[li].unit
                             for lo, hi in box)
            assert small > 0
            assert rd._extents[li][2] is not None   # the map was built


# ------------------------------- hot swap -----------------------------------


@pytest.fixture(scope="module")
def two_snapshots(ref):
    """Two 16³ single-level results (seeds 3 and 4), as the reference's
    hot-swap tests build them."""
    out = []
    for seed in (3, 4):
        rds = ref.amr.synthetic_amr((16, 16, 16), densities=[1.0],
                                    refine_block=4, seed=seed)
        ds = dataset_from_arrays([(l.data, l.mask, l.ratio)
                                  for l in rds.levels])
        out.append(hybrid.compress_amr(ds, eb=1e-2, device="cpu"))
    return out


def test_hot_swap_propagates_through_router(tmp_path, two_snapshots):
    res_a, res_b = two_snapshots
    path = str(tmp_path / "hot.tacz")
    tio.write(path, res_a, device="cpu")
    box = ((0, 16), (0, 16), (0, 16))
    m = ShardMap(["s0", "s1"], seed=0)
    with port_fleet(path, m, warm=[box]) as (urls, servers), \
            _router(path, m, urls) as router:
        assert torch.equal(router.get_roi(box)[0].data, res_a.levels[0].recon)
        old_crc = router.snapshot_crc
        tio.write(path, res_b, device="cpu")         # atomic republish
        for httpd in servers.values():               # shards reload warm
            httpd.region_server.maybe_reload()
            httpd.region_server.get_regions([box])
        assert torch.equal(router.get_roi(box)[0].data, res_b.levels[0].recon)
        assert router.snapshot_crc != old_crc
        assert router.counters["local_fallbacks"] == 0


def test_stale_shard_generation_is_routed_around(tmp_path, two_snapshots):
    """A shard that has not adopted a republish answers with the old
    index CRC: the router treats it as failed, never mixes generations."""
    res_a, res_b = two_snapshots
    path = str(tmp_path / "lag.tacz")
    tio.write(path, res_a, device="cpu")
    box = ((0, 16), (0, 16), (0, 16))
    m = ShardMap(["s0"], seed=0)
    with port_fleet(path, m, warm=[box], auto_reload=False) as (urls, _), \
            _router(path, m, urls) as router:
        router.get_roi(box)
        tio.write(path, res_b, device="cpu")
        roi = router.get_roi(box)[0]                 # router reloads first
        assert torch.equal(roi.data, res_b.levels[0].recon)
        assert router.counters["local_fallbacks"] > 0
        assert router.counters["endpoint_failures"] > 0


def test_retired_reader_drains_after_its_last_batch(tmp_path, two_snapshots):
    res_a, res_b = two_snapshots
    path = str(tmp_path / "drain.tacz")
    tio.write(path, res_a, device="cpu")
    m = ShardMap(["s0"], seed=0)
    with _router(path, m, {}) as router:
        old = router.reader
        router._inflight[id(old)] = 1            # a batch in flight on it
        tio.write(path, res_b, device="cpu")
        assert router.maybe_reload() and not router.maybe_reload()
        assert router._retired == {id(old): old}
        with router._lock:                       # the batch's finally
            router._inflight.pop(id(old))
            router._retired.pop(id(old)).close()
        assert router.reader is not old


# ------------------------------ cross-package -------------------------------


@pytest.mark.parametrize("router_pkg,fleet_pkgs", [
    ("reference", ("port", "port")),
    ("port", ("reference", "reference")),
    ("port", ("port", "reference")),
    ("reference", ("reference", "port")),
])
def test_cross_package_fleets(ref, snap, router_pkg, fleet_pkgs):
    """Either package's router over either package's shard servers gives
    the reference single server's crops bit for bit, with no fallback."""
    fns = {"port": _port_serve, "reference": ref.serve}
    m = ShardMap(["s0", "s1"], seed=2)
    serve_fns = dict(zip(m.shards, (fns[p] for p in fleet_pkgs)))
    with shard_fleet(serve_fns, snap.path, m) as (urls, servers):
        assert {type(h.region_server).__module__.split(".")[0]
                for h in servers.values()} == {
            {"port": "repro_torch", "reference": "repro"}[p]
            for p in fleet_pkgs}
        if router_pkg == "port":
            router = _router(snap.path, m, urls)
        else:
            router = ref.ShardedRegionRouter(
                snap.path, ref.ShardMap(["s0", "s1"], seed=2), urls,
                timeout=TIMEOUT)
        with router:
            _assert_regions(router.get_regions(BOXES), snap.want)
            assert router.counters["local_fallbacks"] == 0
            assert router.counters["endpoint_failures"] == 0


def test_shard_maps_agree_across_packages(ref, snap):
    with tio.TACZReader(snap.path, device="cpu") as rd:
        keys = rd.subblock_keys() + [(7, WHOLE_LEVEL)]
    for seed in (0, 2, 11):
        a = ShardMap(["x", "y", "z"], seed=seed)
        b = ref.ShardMap.from_json(a.to_json())
        assert [a.owner(k) for k in keys] == [b.owner(k) for k in keys]


# ------------------------- mounted router, metadata -------------------------


def _mounted(router_obj, serve_fn):
    httpd = serve_fn(router_obj, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def test_mounted_router_answers_as_the_reference(ref, snap):
    """``/v1/meta``, ``/v1/stats``, ``/v1/metrics``, ``/v1/health`` and
    ``/v1/regions`` of a mounted port router against a mounted reference
    router over the same two port shards."""
    m = ShardMap(["s0", "s1"], seed=2)
    with port_fleet(snap.path, m) as (urls, _):
        prouter = _router(snap.path, m, urls)
        rrouter = ref.ShardedRegionRouter(
            snap.path, ref.ShardMap(["s0", "s1"], seed=2), urls,
            timeout=TIMEOUT)
        phttpd, purl = _mounted(prouter, serve)
        rhttpd, rurl = _mounted(rrouter, ref.serve)
        try:
            pc, rc = RegionClient(purl, timeout=TIMEOUT), \
                ref.RegionClient(rurl, timeout=TIMEOUT)
            # the reference's endpoint cannot frame an empty crop (the
            # last box lies beyond the extent); the port's can
            _assert_regions(pc.regions(BOXES), snap.want)
            _assert_regions(rc.regions(BOXES[:-1]), snap.want[:-1])
            assert pc.meta() == rc.meta()
            assert "cache" not in pc.meta()
            ps, rs = pc.stats(), rc.stats()
            assert set(ps) == set(rs)
            for key in ("batches", "shard_requests", "endpoint_failures",
                        "local_fallbacks", "retries", "demotions",
                        "snapshot_crc", "shard_map", "load_balance"):
                assert ps[key] == rs[key], key
            assert set(ps["latency"]) == set(rs["latency"])
            pm, rm = pc.metrics(), rc.metrics()
            assert set(pm) == set(rm)
            for name in pm:
                assert pm[name].kind == rm[name].kind, name
                assert pm[name].help == rm[name].help, name
            ph, rh = pc.health(), rc.health()
            assert ph["status"] == rh["status"] == "ok"
            assert ph["role"] == rh["role"] == "router"
            assert ph["checks"] == rh["checks"]
            hdr_p, _ = pc.regions_ex(BOXES[:2])
            hdr_r, _ = rc.regions_ex(BOXES[:2])
            assert set(hdr_p) == set(hdr_r)
            assert hdr_p["snapshot_crc"] == hdr_r["snapshot_crc"]
            # a batch of one empty crop: the port frames an empty payload
            _assert_regions(pc.regions(BOXES[-1:]), snap.want[-1:])
        finally:
            for httpd in (phttpd, rhttpd):
                httpd.shutdown()
                httpd.server_close()
                httpd.region_server.close()


def test_regions_meta_and_stats(snap, monkeypatch):
    from repro_torch.obs import metrics as obsm
    from repro_torch.obs.registry import MetricsRegistry
    fresh = MetricsRegistry().histogram(
        "tacz_router_batch_seconds", "fresh", buckets=(0.1,))
    monkeypatch.setattr(obsm, "ROUTER_BATCH_SECONDS", fresh)
    m = ShardMap(["s0", "s1"], seed=2)
    with port_fleet(snap.path, m) as (urls, _), \
            _router(snap.path, m, {"s0": urls["s0"]}) as router:
        assert router.stats()["latency"] == {
            "count": 0, "p50_ms": None, "p90_ms": None, "p99_ms": None,
            "mean_ms": None}
        out, meta = router.get_regions_meta(BOXES)
        _assert_regions(out, snap.want)
        assert len(meta["request_id"]) == 16
        assert meta["snapshot_crc"] == router.snapshot_crc
        assert meta["variant"] is None and meta["ms"] > 0
        ends = {(i["shard"], i["endpoint"]) for i in meta["shards"]}
        assert ("s1", "local") in ends and ("s0", urls["s0"]) in ends
        ms = [i["ms"] for i in meta["shards"]]
        assert ms == sorted(ms, reverse=True)
        s = router.stats()
        assert s["latency"]["count"] == 1 and s["latency"]["p50_ms"] >= 0
        assert s["shard_map"] == m.to_dict() and not s["load_balance"]
        h = router.health()
        assert h["status"] == "degraded"
        assert h["checks"]["shards"]["s1"]["reachable"] is False
    with _router(snap.path, m, {}, local_fallback=False) as router:
        assert router.health()["status"] == "down"


def test_apply_shard_map_grows_the_fleet(snap):
    """Grow two shards to three with the cache handoff, then swap the
    router: crops unchanged, the new shard serves, the old owners drop
    the moved keys on ``reshard``."""
    m = ShardMap(["s0", "s1"], seed=2)
    with port_fleet(snap.path, m) as (urls, servers):
        with tio.TACZReader(snap.path, device="cpu") as rd:
            new_map, moved = m.grow("s2", rd.subblock_keys())
        assert moved
        with _router(snap.path, m, urls) as router, \
                port_fleet(snap.path, new_map, warm=None) as (u2, s2):
            new_url = u2["s2"]
            imported = 0
            for sid in m.shards:
                blob = RegionClient(urls[sid],
                                    timeout=TIMEOUT).cache_export(moved)
                imported += RegionClient(new_url, timeout=TIMEOUT
                                         ).cache_import(blob)["imported"]
            assert imported > 0
            router.apply_shard_map(new_map, {**urls, "s2": new_url})
            _assert_regions(router.get_regions(BOXES), snap.want)
            assert router.counters["local_fallbacks"] == 0
            assert s2["s2"].region_server.cache.stats()["hits"] > 0
            dropped = sum(servers[sid].region_server.reshard(new_map)
                          for sid in m.shards)
            assert dropped > 0
            _assert_regions(router.get_regions(BOXES), snap.want)


# --------------------------- snapshot directories ---------------------------


def test_router_over_a_snapshot_directory(ref, snap, tmp_path):
    path = str(tmp_path / "snap.taczd")
    tio.write_multipart(path, snap.res, parts=2, payload_codec="none",
                        device="cpu")
    m = ShardMap(["s0", "s1"], seed=2)
    with port_fleet(path, m) as (urls, _), \
            _router(path, m, {"s0": urls["s0"]}) as router:
        _assert_regions(router.get_regions(BOXES), snap.want)
        assert router.counters["local_fallbacks"] > 0


def test_router_over_a_variant_set(ref, snap, tmp_path):
    """A variant-set directory routes per selected variant: the target
    picks ``hi`` locally, every shard is asked for ``hi``, and the crops
    equal ``read_roi`` of ``hi.tacz``; unknown names and unsatisfiable
    targets raise."""
    from repro_torch.io import frontier as frt
    vset = write_variant_set(str(tmp_path / "snap.taczv"), snap.ds,
                             {"hi": "psnr>=70", "lo": "psnr>=50"},
                             default="lo", payload_codec="none",
                             steps_down=4, steps_up=4, device="cpu")
    m = ShardMap(["s0", "s1"], seed=2)
    want = {}
    for name in ("hi", "lo"):
        with tio.TACZReader(os.path.join(vset, f"{name}.tacz"),
                            device="cpu") as rd:
            want[name] = [[(c.level, c.ratio, c.box, c.data.numpy())
                           for c in rd.read_roi(b)] for b in BOXES[:3]]
    with port_fleet(vset, m, warm=None) as (urls, servers), \
            _router(vset, m, urls) as router:
        for httpd in servers.values():
            for name in ("hi", "lo"):
                httpd.region_server.get_regions_ex(BOXES[:3], variant=name)
        crc, name, out = router.get_regions_ex(BOXES[:3], target="psnr>=60")
        assert name == "hi"
        _assert_regions(out, want["hi"])
        _, name, out = router.get_regions_ex(BOXES[:3], variant="lo")
        assert name == "lo"
        _assert_regions(out, want["lo"])
        crc, name, out = router.get_regions_ex(BOXES[:3])
        assert name is None and crc == router.snapshot_crc
        _assert_regions(out, want["lo"])
        assert router.counters["local_fallbacks"] == 0
        assert router.stats()["variants"]["opened"] == ["hi"]
        with pytest.raises(ValueError, match="unknown variant"):
            router.get_regions_ex(BOXES[:1], variant="nope")
        with pytest.raises(frt.TargetUnsatisfiable):
            router.get_regions_ex(BOXES[:1], target="psnr>=500")
    with _router(snap.path, m, {}) as router:
        with pytest.raises(ValueError, match="single snapshot"):
            router.get_regions_ex(BOXES[:1], variant="hi")


# ---------------------------------- card -----------------------------------


@contextlib.contextmanager
def _card_fleet(tmp_path):
    """A seeded 64³ TAC+ snapshot written on the card, two card shard
    servers behind ``serve`` and a card router over them."""
    ds = amr.synthetic_amr((64, 64, 64), densities=[0.35, 0.65],
                           refine_block=4, seed=5)
    vals = ds.levels[0].data[ds.levels[0].mask]
    res = hybrid.compress_amr(ds, eb=1e-3 * float(vals.max() - vals.min()),
                              device="cuda")
    path = str(tmp_path / "card.tacz")
    tio.write(path, res, payload_codec="none", device="cuda")
    m = ShardMap(["s0", "s1"], seed=2)
    servers, urls = {}, {}
    try:
        for sid in m.shards:
            httpd = serve(path, port=0, shard_map=m, shard_id=sid,
                          device="cuda")
            threading.Thread(target=httpd.serve_forever,
                             daemon=True).start()
            servers[sid] = httpd
            urls[sid] = f"http://127.0.0.1:{httpd.server_address[1]}"
        yield path, m, urls, servers
    finally:
        for httpd in servers.values():
            httpd.shutdown()
            httpd.server_close()
            httpd.region_server.close()


CARD_BOXES = [((0, 32), (0, 32), (0, 32)), ((10, 50), (20, 64), (5, 40)),
              ((0, 64), (0, 64), (0, 64))]


@pytest.mark.cuda
def test_router_over_card_shards_equals_read_roi(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    with _card_fleet(tmp_path) as (path, m, urls, servers):
        with ShardedRegionRouter(path, m, urls, device="cuda") as router:
            got = router.get_regions(CARD_BOXES)
            assert router.counters["local_fallbacks"] == 0
        for s in servers.values():
            assert all(b.is_cuda for b in s.region_server.cache._od.values())
        with tio.TACZReader(path, device="cuda") as rd:
            for box, per in zip(CARD_BOXES, got):
                for c, w in zip(per, rd.read_roi(box)):
                    assert c.data.is_cuda and torch.equal(c.data, w.data)


@pytest.mark.cuda
def test_card_fallback_launches_kernel4_once_a_group(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    with _card_fleet(tmp_path) as (path, m, urls, _):
        with ShardedRegionRouter(path, m, {"s0": urls["s0"]},
                                 device="cuda") as router:
            router.get_regions(CARD_BOXES)           # s0 warm
            before = router.counters["local_fallbacks"]
            ops.reset_launches()
            got = router.get_regions(CARD_BOXES)
            torch.cuda.synchronize()
            groups = router.counters["local_fallbacks"] - before
            assert groups > 0
            assert 0 < ops.launches["huffdec"] <= groups
            assert ops.launches["lorenzo3d_recon_batched"] > 0
        with tio.TACZReader(path, device="cuda") as rd:
            for box, per in zip(CARD_BOXES, got):
                for c, w in zip(per, rd.read_roi(box)):
                    assert torch.equal(c.data, w.data)
