"""Region serving on the port (``repro_torch.serving``) against the
reference's ``repro.serving``, on the CPU.

Both packages serve the same seeded snapshots: the reference's
``run1_z10`` preset (64³) written by the reference, a 32³ two-level
dataset written by the port, a 16³ GSP level written by the port (a
``WHOLE_LEVEL`` key), and a fully covered 32³ SHE level that stores no
mask.  Every crop, cold and warm, equals the port's and
the reference's ``read_roi`` bit for bit; cache statistics, planner keys,
``subblock_keys``, ``level_signature``, ``probe_index_crc``, shard owners
and ``cache_export`` blobs equal the reference's.  Also here: the batched
placement against a per-brick loop, the prefix-limited decode in one
kernel-4 launch against the padding it replaced, the staged upload, and
the decode split made from host counts.

The ``cuda`` tests import no JAX (the reference is imported inside the
CPU tests' bodies and fixtures), so they run on the card's machine with
``pytest --noconftest -m cuda``: they serve the golden v1 fixture and
``tests/card_reference/gsp_lorenzo.tacz`` (kernel 6) on the card.
"""
import json
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import io as tio
from repro_torch.convert import dataset_from_arrays
from repro_torch.core import entropy, huffman, hybrid
from repro_torch.io import reader as treader
from repro_torch.serving import (DecodePlanner, RegionServer, ShardMap,
                                 SubBlockCache)
from repro_torch.serving.regions import resolve_single_target

HERE = os.path.dirname(os.path.abspath(__file__))

BOXES = [((0, 8), (0, 8), (0, 8)),
         ((5, 23), (11, 40), (2, 9)),
         ((56, 64), (48, 64), (0, 64)),
         ((0, 64), (0, 64), (0, 64)),
         ((30, 34), (30, 34), (30, 34))]
FULL = ((0, 64), (0, 64), (0, 64))
SNAPSHOTS = ["ref_run1_z10", "port_32", "port_gsp", "port_nomask"]


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (imported here, not at module level)."""
    from repro import io as rio
    from repro.core import amr as ramr
    from repro.core import hybrid as rhybrid
    from repro.io import reader as rreader
    from repro.serving import regions as rregions
    from repro.serving import sharded as rsharded
    return SimpleNamespace(io=rio, amr=ramr, hybrid=rhybrid, reader=rreader,
                           RegionServer=rregions.RegionServer,
                           DecodePlanner=rregions.DecodePlanner,
                           ShardMap=rsharded.ShardMap)


def _port_write_32(path: str, ref) -> None:
    rds = ref.amr.synthetic_amr((32, 32, 32), densities=[0.35, 0.65],
                                refine_block=4, seed=5)
    eb = 1e-3 * float(rds.levels[0].data.max() - rds.levels[0].data.min())
    ds = dataset_from_arrays([(l.data, l.mask, l.ratio) for l in rds.levels])
    tio.write(path, hybrid.compress_amr(ds, eb=eb, device="cpu"),
              device="cpu")


def _port_write_nomask(path: str) -> None:
    """A fully covered SHE level: the file stores no mask, so crops come
    straight from the placement accumulator."""
    rng = np.random.default_rng(3)
    x = np.cumsum(rng.standard_normal((32, 32, 32)), axis=0).astype(
        np.float32)
    ds = dataset_from_arrays([(x, np.ones(x.shape, dtype=bool), 1)])
    tio.write(path, hybrid.compress_amr(ds, eb=1e-2, device="cpu"),
              device="cpu")


def _port_write_gsp(path: str) -> None:
    rng = np.random.default_rng(17)
    data = np.cumsum(rng.normal(size=(16, 16, 16)), axis=0).astype(np.float32)
    mask = np.ones_like(data, dtype=bool)
    mask[:, :, 12:] = False
    with tio.TACZWriter(path, eb=1e-2, algorithm="lorenzo", she=False,
                        strategy="gsp", device="cpu") as w:
        w.add_level(data, mask, ratio=1)


@pytest.fixture(scope="module")
def snapshots(make_amr_snapshot, ref, tmp_path_factory):
    """Snapshot paths by name, with the reference's ``read_roi`` of every
    box in ``BOXES`` (each file is served by both packages)."""
    d = tmp_path_factory.mktemp("serve")
    paths = {"ref_run1_z10": make_amr_snapshot(preset="run1_z10",
                                               name="s").path,
             "port_32": str(d / "port32.tacz"),
             "port_gsp": str(d / "gsp.tacz"),
             "port_nomask": str(d / "nomask.tacz")}
    _port_write_32(paths["port_32"], ref)
    _port_write_gsp(paths["port_gsp"])
    _port_write_nomask(paths["port_nomask"])
    out = {}
    for name, path in paths.items():
        with ref.io.TACZReader(path) as rr:
            out[name] = SimpleNamespace(
                path=path, roi={b: rr.read_roi(b) for b in BOXES})
    return out


@pytest.fixture(params=SNAPSHOTS)
def snap(request, snapshots):
    return snapshots[request.param]


def _same_roi(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.level, g.ratio, g.box) == (w.level, w.ratio, w.box)
        assert g.data.dtype == torch.float32
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))


def _server(path, **kw):
    return RegionServer(path, device="cpu", **kw)


def _keys_of_cache(srv):
    return list(srv.cache._od)


# ------------------------------- cache --------------------------------------


def test_cache_lru_eviction_under_byte_budget():
    kb = torch.zeros(256)                          # 1 KiB per brick
    cache = SubBlockCache(budget_bytes=3 * 1024)
    for i in range(3):
        cache.put((0, i), kb.clone())
    assert len(cache) == 3 and cache.evictions == 0
    assert cache.get((0, 0)) is not None           # 0 is now MRU
    cache.put((0, 3), kb.clone())                  # evicts LRU = 1
    assert cache.evictions == 1
    assert (0, 1) not in cache
    assert (0, 0) in cache and (0, 2) in cache and (0, 3) in cache
    assert cache.nbytes <= cache.budget_bytes
    assert cache.get((0, 1)) is None
    assert cache.stats()["misses"] == 1
    assert cache.stats()["hits"] == 1


def test_cache_rejects_oversized_entry_and_replaces_in_place():
    small = torch.zeros(8)
    cache = SubBlockCache(budget_bytes=64)
    cache.put((0, 0), small)                       # 32 B, fits
    cache.put((0, 1), torch.zeros(1024))           # 4 KiB > budget
    assert (0, 1) not in cache                     # cannot be held ...
    assert (0, 0) in cache                         # ... and no hot-set flush
    assert cache.evictions == 0
    cache.put((0, 0), small)                       # same-key replace
    assert cache.nbytes == 32


def test_cache_stores_bricks_that_own_their_storage():
    stack = torch.arange(4 * 27, dtype=torch.float32).reshape(4, 3, 3, 3)
    cache = SubBlockCache(budget_bytes=1 << 20)
    stored = cache.put((0, 1), stack[1])           # a view into the batch
    assert stored.untyped_storage().nbytes() == 27 * 4
    assert torch.equal(stored, stack[1])
    stack[1] = -1.0                                # the batch moves on ...
    assert torch.equal(cache.peek((0, 1)),         # ... the entry does not
                       torch.arange(27, 54, dtype=torch.float32)
                       .reshape(3, 3, 3))
    own = torch.zeros(2, 2, 2)
    assert cache.put((0, 2), own) is own           # no copy when it owns it
    assert cache.nbytes == 27 * 4 + 8 * 4


def test_cache_swap_generation_unit():
    kb = torch.zeros(256)
    cache = SubBlockCache(budget_bytes=1 << 20)
    for li in (0, 1):
        for sbi in range(3):
            cache.put((111, li, sbi), kb.clone())
    cache.put((99, 0, 7), kb.clone())              # raced old-gen insert
    assert cache.swap_generation(111, 222, {0}) == 3
    assert len(cache) == 3 and cache.nbytes == 3 * 1024
    for sbi in range(3):
        assert (222, 0, sbi) in cache and (222, 1, sbi) not in cache
    assert (99, 0, 7) not in cache
    assert cache.swap_generation(222, 333, set()) == 0
    assert len(cache) == 0 and cache.nbytes == 0


# --------------------------- server vs read_roi -----------------------------


def test_get_roi_bit_identical_cold_and_warm(snap, ref):
    with tio.TACZReader(snap.path, device="cpu") as rd, \
            _server(snap.path, cache_bytes=64 << 20) as srv, \
            ref.RegionServer(snap.path, cache_bytes=64 << 20) as rsrv:
        for box in BOXES:                          # cold
            got = srv.get_roi(box)
            _same_roi(got, snap.roi[box])
            _same_roi(got, rd.read_roi(box))
            rsrv.get_roi(box)
        cold = srv.cache.stats()
        assert cold == rsrv.cache.stats()
        for box in BOXES:                          # warm
            _same_roi(srv.get_roi(box), snap.roi[box])
            rsrv.get_roi(box)
        warm = srv.cache.stats()
        assert warm == rsrv.cache.stats()
        assert warm["hits"] > cold["hits"]
        assert warm["misses"] == cold["misses"]    # nothing re-decoded
        assert _keys_of_cache(srv) == _keys_of_cache(rsrv)


def test_get_region_single_level(snap):
    with _server(snap.path) as srv:
        for li in range(srv.n_levels):
            roi = srv.get_region(li, BOXES[1])
            assert roi.level == li
            np.testing.assert_array_equal(
                roi.data.numpy(), snap.roi[BOXES[1]][li].data)


@pytest.mark.parametrize("box", [((200, 300), (0, 8), (0, 8)),
                                 ((3, 3), (0, 8), (0, 8)),
                                 ((-9, 70), (-1, 5), (60, 99))])
def test_empty_and_out_of_range_boxes(snapshots, ref, box):
    path = snapshots["ref_run1_z10"].path
    with _server(path) as srv, ref.io.TACZReader(path) as rr:
        _same_roi(srv.get_roi(box), rr.read_roi(box))
        _same_roi(tio.read_roi(path, box, device="cpu"), rr.read_roi(box))


def test_planner_dedupes_overlapping_boxes(snap, ref):
    boxes = [((0, 16), (0, 16), (0, 16)),
             ((8, 24), (8, 24), (8, 24)),
             ((4, 20), (4, 20), (4, 20))]          # heavy overlap
    with _server(snap.path, cache_bytes=64 << 20) as srv, \
            ref.io.TACZReader(snap.path) as rr:
        queries = [(li, b) for b in boxes for li in range(srv.n_levels)]
        plans = DecodePlanner(srv.reader).plan(queries)
        rplans = ref.DecodePlanner(rr).plan(queries)
        assert [p.keys() for p in plans] == [p.keys() for p in rplans]
        assert [(p.lbox, p.tasks, p.whole_level) for p in plans] == \
            [(p.lbox, p.tasks, p.whole_level) for p in rplans]
        unique = {k for p in plans for k in p.keys()}
        srv.get_regions(boxes)
        s = srv.cache.stats()
        assert s["misses"] == len(unique)          # one decode per key
        assert s["entries"] == len(unique)
        srv.get_regions(boxes)                     # a repeat is all hits
        assert srv.cache.stats()["misses"] == len(unique)


def test_batched_group_decode_matches_serial(snapshots, ref):
    path = snapshots["port_32"].path
    with tio.TACZReader(path, device="cpu") as rd, \
            ref.io.TACZReader(path) as rr, _server(path) as srv:
        srv.get_roi(FULL)                          # fills the cache by groups
        for li, e in enumerate(rd.levels):
            for sbi, sb in enumerate(e.subblocks):
                cached = srv.cache.get((srv.snapshot_crc, li, sbi))
                serial = rd._decode_subblock(li, sb, sb.size)
                assert torch.equal(cached, serial)
                np.testing.assert_array_equal(
                    cached.numpy(), rr._decode_subblock(li, sb, sb.size))


def test_tight_budget_still_bit_identical(snap, ref):
    with _server(snap.path, cache_bytes=4096) as srv, \
            ref.RegionServer(snap.path, cache_bytes=4096) as rsrv:
        for box in BOXES[:3]:
            _same_roi(srv.get_roi(box), snap.roi[box])
            rsrv.get_roi(box)
        assert srv.cache.stats() == rsrv.cache.stats()
        assert _keys_of_cache(srv) == _keys_of_cache(rsrv)


def test_tight_budget_evicts(snapshots):
    snap = snapshots["ref_run1_z10"]
    with _server(snap.path, cache_bytes=4096) as srv:
        for box in BOXES[:3]:
            _same_roi(srv.get_roi(box), snap.roi[box])
        assert srv.cache.stats()["evictions"] > 0


def test_threaded_get_region_stress(snapshots):
    """Eight threads serve overlapping boxes from one server, racing on
    the cache and on the decode of a few dropped keys.  (The port's plain
    decoder takes thousands of small torch calls a decode, which threads
    serialise on the interpreter lock, so most bricks are warmed first.)
    """
    import sys
    snap = snapshots["port_32"]
    rng = np.random.default_rng(0)
    boxes = []
    for _ in range(8):
        lo = rng.integers(0, 24, size=3)
        ext = rng.integers(1, 9, size=3)
        boxes.append(tuple((int(l), int(l + e)) for l, e in zip(lo, ext)))
    with tio.TACZReader(snap.path, device="cpu") as rd:
        refs = {b: rd.read_roi(b) for b in boxes}
    errors: list[BaseException] = []
    n_threads, interval = torch.get_num_threads(), sys.getswitchinterval()
    torch.set_num_threads(1)
    sys.setswitchinterval(1e-4)
    try:
        with _server(snap.path, cache_bytes=1 << 20) as srv:
            for box in boxes:
                srv.get_roi(box)
            cold = list(srv.cache._od)[:3]
            assert srv.cache.drop(lambda k: k in cold) == 3
            misses = srv.cache.misses

            def worker(seed):
                try:
                    order = np.random.default_rng(seed).permutation(
                        len(boxes))
                    for i in order:
                        _same_roi(srv.get_roi(boxes[i]), refs[boxes[i]])
                except BaseException as exc:   # surfaces in the main thread
                    errors.append(exc)

            threads = [threading.Thread(target=worker, args=(s,))
                       for s in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            assert srv.cache.misses - misses >= 3
            assert all((srv.snapshot_crc,) + k[1:] in srv.cache for k in cold)
            assert srv.cache.nbytes == sum(
                b.numel() * 4 for b in srv.cache._od.values())
    finally:
        torch.set_num_threads(n_threads)
        sys.setswitchinterval(interval)
    if errors:
        raise errors[0]


def test_get_regions_rejects_bad_levels(snapshots):
    with _server(snapshots["port_32"].path) as srv:
        with pytest.raises(ValueError, match="out of range"):
            srv.get_regions([BOXES[0]], levels=[srv.n_levels])
        with pytest.raises(ValueError, match="out of range"):
            srv.get_region(-1, BOXES[0])


def test_served_crops_do_not_alias_the_cache(snap):
    """A torch tensor cannot be made read-only: writing to a served crop,
    a whole-level crop included, must leave the next crop unchanged."""
    whole = ((0, 64), (0, 64), (0, 64))
    with _server(snap.path) as srv:
        first = srv.get_roi(whole)
        want = [c.data.clone() for c in first]
        for c in first:
            c.data.fill_(12345.0)
        for c, w in zip(srv.get_roi(whole), want):
            assert torch.equal(c.data, w)
        for li in range(srv.n_levels):             # one level, alone
            crop = srv.get_region(li, whole)
            crop.data.fill_(-1.0)
            assert torch.equal(srv.get_region(li, whole).data, want[li])


def _owns_its_storage(t: torch.Tensor) -> bool:
    return (t.is_contiguous()
            and t.untyped_storage().nbytes() == t.numel() * t.element_size())


def test_crops_and_levels_hold_only_their_own_bytes(snap):
    """A crop is cut from an accumulator over the bricks' bounding box;
    holding it must not keep that accumulator (or a cached level) alive."""
    with tio.TACZReader(snap.path, device="cpu") as rd, \
            _server(snap.path) as srv:
        for li in range(rd.n_levels):
            assert _owns_its_storage(rd.read_level(li))
        # the last box trims the accumulator in x alone, so its crop is a
        # contiguous slab of the accumulator
        for box in BOXES + [((5, 23), (0, 64), (0, 64))]:
            for crop in rd.read_roi(box) + srv.get_roi(box):
                assert _owns_its_storage(crop.data)


def test_subblock_codes_equal_the_reference(snap, ref):
    with tio.TACZReader(snap.path, device="cpu") as rd, \
            ref.io.TACZReader(snap.path) as rr:
        for li, sbi in rd.subblock_keys():
            sbi = max(sbi, 0)
            for limit in (None, 5):
                codes, betas = rd.subblock_codes(li, sbi, limit)
                rcodes, rbetas = rr.subblock_codes(li, sbi, limit)
                np.testing.assert_array_equal(codes.numpy(), rcodes)
                assert (betas is None) == (rbetas is None)
                if betas is not None:
                    np.testing.assert_array_equal(betas.numpy(), rbetas)


def test_whole_level_key_serves_the_gsp_level(snapshots, ref):
    snap = snapshots["port_gsp"]
    with _server(snap.path) as srv, ref.io.TACZReader(snap.path) as rr:
        assert srv.reader.subblock_keys() == [(0, tio.WHOLE_LEVEL)]
        got = srv.get_roi(((2, 11), (0, 16), (5, 14)))
        np.testing.assert_array_equal(
            got[0].data.numpy(), rr.read_level(0)[2:11, :, 5:14])
        assert srv.cache.stats()["entries"] == 1


# ------------------------------- hot swap -----------------------------------


def _ref_publish(ref, path, shape, densities, seed, eb):
    ds = ref.amr.synthetic_amr(shape, densities=densities, refine_block=4,
                               seed=seed)
    res = ref.hybrid.compress_amr(ds, eb=eb)
    ref.io.write(path, res)
    return res


def test_snapshot_hot_swap_via_footer_crc(tmp_path, ref):
    path = str(tmp_path / "hot.tacz")
    res_a = _ref_publish(ref, path, (32, 32, 32), [0.23, 0.77], 1, 1e-3)
    box = ((0, 16), (0, 16), (0, 16))
    sl = tuple(slice(lo, hi) for lo, hi in box)
    with _server(path, cache_bytes=64 << 20) as srv:
        np.testing.assert_array_equal(srv.get_roi(box)[0].data.numpy(),
                                      res_a.levels[0].recon[sl])
        assert srv.maybe_reload() is False         # unchanged file
        old_crc = srv.snapshot_crc
        res_b = _ref_publish(ref, path, (32, 32, 32), [0.4, 0.6], 9, 1e-3)
        assert srv.maybe_reload() is True
        assert srv.snapshot_crc != old_crc
        assert srv.snapshot_crc == treader.probe_index_crc(path)
        assert srv.cache.stats()["entries"] == 0   # cache dropped
        assert not srv._retired                    # idle reader closed
        np.testing.assert_array_equal(srv.get_roi(box)[0].data.numpy(),
                                      res_b.levels[0].recon[sl])
        for seed in (20, 21):                      # no readers pile up
            _ref_publish(ref, path, (32, 32, 32), [0.5, 0.5], seed, 1e-3)
            assert srv.maybe_reload() is True
            srv.get_roi(box)
        assert not srv._retired and not srv._inflight


def test_auto_reload_serves_new_snapshot_without_restart(tmp_path, ref):
    path = str(tmp_path / "auto.tacz")
    res_a = _ref_publish(ref, path, (16, 16, 16), [1.0], 3, 1e-2)
    box = ((0, 16), (0, 16), (0, 16))
    with _server(path, auto_reload=True) as srv:
        np.testing.assert_array_equal(srv.get_roi(box)[0].data.numpy(),
                                      res_a.levels[0].recon)
        res_b = _ref_publish(ref, path, (16, 16, 16), [1.0], 4, 1e-2)
        np.testing.assert_array_equal(srv.get_roi(box)[0].data.numpy(),
                                      res_b.levels[0].recon)


def test_hot_swap_preserves_cache_for_unchanged_levels(tmp_path, ref):
    """A republish that changed only some levels keeps the other levels'
    bricks warm; the port's writer publishes, both servers carry alike."""
    rng = np.random.default_rng(0)
    lvl0 = rng.normal(size=(16, 16, 16)).astype(np.float32)
    lvl1_a = rng.normal(size=(8, 8, 8)).astype(np.float32)
    lvl1_b = rng.normal(size=(8, 8, 8)).astype(np.float32)
    path = str(tmp_path / "carry.tacz")

    def publish(l0, l1):
        with tio.TACZWriter(path, eb=1e-2, device="cpu") as w:
            w.add_level(l0, np.ones_like(l0, bool), ratio=1)
            w.add_level(l1, np.ones_like(l1, bool), ratio=2)

    publish(lvl0, lvl1_a)
    box = ((0, 16), (0, 16), (0, 16))
    with _server(path, cache_bytes=64 << 20) as srv, \
            ref.RegionServer(path, cache_bytes=64 << 20) as rsrv:
        srv.get_roi(box)
        rsrv.get_roi(box)
        warm = srv.cache.stats()
        lvl0_keys = [k for k in srv.cache._od if k[1] == 0]
        assert lvl0_keys
        publish(lvl0, lvl1_b)                      # level 0 bytes unchanged
        assert srv.maybe_reload() is True and rsrv.maybe_reload() is True
        assert srv.cache.stats()["entries"] == len(lvl0_keys)
        assert _keys_of_cache(srv) == _keys_of_cache(rsrv)
        for key in srv.cache._od:
            assert key[0] == srv.snapshot_crc and key[1] == 0
        with ref.io.TACZReader(path) as rr:
            _same_roi(srv.get_roi(box), rr.read_roi(box))
        after = srv.cache.stats()
        assert after["hits"] - warm["hits"] == len(lvl0_keys)
        assert after["misses"] > warm["misses"]
        publish(rng.normal(size=(16, 16, 16)).astype(np.float32), lvl1_a)
        assert srv.maybe_reload() is True
        assert srv.cache.stats()["entries"] == 0   # everything changed


def test_level_signature_ignores_byte_placement(tmp_path, ref):
    rng = np.random.default_rng(1)
    small = rng.normal(size=(8, 8, 8)).astype(np.float32)
    big = rng.normal(size=(16, 16, 16)).astype(np.float32)
    shared = rng.normal(size=(8, 8, 8)).astype(np.float32)
    pa, pb = str(tmp_path / "a.tacz"), str(tmp_path / "b.tacz")
    for p, first in ((pa, small), (pb, big)):
        with tio.TACZWriter(p, eb=1e-2, device="cpu") as w:
            w.add_level(first, np.ones_like(first, bool), ratio=1)
            w.add_level(shared, np.ones_like(shared, bool), ratio=2)
    with tio.TACZReader(pa, device="cpu") as ra, \
            tio.TACZReader(pb, device="cpu") as rb, \
            ref.io.TACZReader(pa) as rra:
        assert ra.level_signature(1) == rb.level_signature(1)
        assert ra.level_signature(0) != rb.level_signature(0)
        assert (ra.levels[1].subblocks[0].payload_off
                != rb.levels[1].subblocks[0].payload_off)
        assert ra.level_signature(0) == rra.level_signature(0)


# ----------------------- identity against the reference ---------------------


def test_keys_signatures_and_probe_equal_the_reference(snap, ref):
    with tio.TACZReader(snap.path, device="cpu") as rd, \
            ref.io.TACZReader(snap.path) as rr:
        assert rd.subblock_keys() == rr.subblock_keys()
        assert rd.subblock_keys([rd.n_levels - 1]) == \
            rr.subblock_keys([rr.n_levels - 1])
        for li in range(rd.n_levels):
            assert rd.level_signature(li) == rr.level_signature(li)
        assert treader.probe_index_crc(snap.path) == \
            ref.reader.probe_index_crc(snap.path) == rd.index_crc


def test_probe_index_crc_bad_files_and_multipart(tmp_path, snapshots):
    assert treader.probe_index_crc(str(tmp_path / "missing.tacz")) is None
    short = tmp_path / "short.tacz"
    short.write_bytes(b"TACZ")
    assert treader.probe_index_crc(str(short)) is None
    with open(snapshots["port_32"].path, "rb") as f:
        body = f.read()
    cut = tmp_path / "cut.tacz"
    cut.write_bytes(body[:-7])
    assert treader.probe_index_crc(str(cut)) is None
    # a directory without a manifest is no snapshot; a multi-part one is
    # identified by its manifest's CRC
    assert treader.probe_index_crc(str(tmp_path)) is None
    with pytest.raises(OSError):
        RegionServer(str(tmp_path), device="cpu")
    gold = os.path.join(HERE, "golden", "multipart.taczd")
    with open(os.path.join(gold, "manifest.json")) as f:
        crc = json.load(f)["crc32"]
    assert treader.probe_index_crc(gold) == crc
    assert treader.probe_index_crc(os.path.join(gold, "manifest.json")) == crc
    with RegionServer(gold, device="cpu") as srv:
        assert srv.snapshot_crc == crc


@pytest.mark.parametrize("engine", ["auto", "numpy", "batched", "pallas"])
def test_every_engine_name_decodes_alike(snapshots, engine):
    snap = snapshots["port_32"]
    box = BOXES[1]
    with _server(snap.path, entropy_engine=engine) as srv:
        _same_roi(srv.get_roi(box), snap.roi[box])
    with tio.open_snapshot(snap.path, entropy_engine=engine,
                           device="cpu") as rd:
        _same_roi(rd.read_roi(box), snap.roi[box])


def test_unknown_engine_name_raises(snapshots):
    path = snapshots["port_32"].path
    for make in (lambda: tio.TACZReader(path, entropy_engine="zip",
                                        device="cpu"),
                 lambda: _server(path, entropy_engine="zip")):
        with pytest.raises(ValueError, match="unknown entropy engine"):
            make()


def test_region_server_defaults_to_the_card(snapshots):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RegionServer(snapshots["port_32"].path)


def test_stats_health_and_targets(snapshots, ref):
    path = snapshots["port_32"].path
    with _server(path) as srv:
        srv.get_roi(BOXES[0])
        s = srv.stats()
        assert s["snapshot_crc"] == srv.snapshot_crc and s["n_levels"] == 2
        assert s["latency"]["count"] >= 1
        assert s["entries"] == len(srv.cache)
        h = srv.health()
        assert h["status"] == "ok" and h["checks"]["snapshot"]["ok"]
        assert resolve_single_target(srv.reader, "psnr>=60") == "default"
        crc, name, out = srv.get_regions_ex([BOXES[0]], target="psnr>=60")
        assert (crc, name) == (srv.snapshot_crc, "default")
        with pytest.raises(ValueError, match="unknown variant"):
            srv.get_regions_ex([BOXES[0]], variant="hi")
        with pytest.raises(ValueError, match="bad distortion target"):
            srv.get_regions_ex([BOXES[0]], target="psnr=>60")
    with _server(path) as srv:
        os.replace(path, path + ".moved")
        try:
            assert srv.health()["status"] == "down"
        finally:
            os.replace(path + ".moved", path)


def test_frontier_targets_match_the_reference(ref):
    from repro.io import frontier as rfrt
    from repro_torch.io import frontier as tfrt
    pts = [dict(ebs=[1e-3], bits=900, metrics={"psnr": 71.0}),
           dict(ebs=[1e-2], bits=400, metrics={"psnr": 55.5}),
           dict(ebs=[3e-3], bits=600, metrics={"psnr": 63.2,
                                               "max_abs_error": 0.01})]
    t = tfrt.Frontier("psnr", [tfrt.FrontierPoint(**p) for p in pts], 1)
    r = rfrt.Frontier("psnr", [rfrt.FrontierPoint(**p) for p in pts], 1)
    for spec in ("psnr>=60", "psnr > 55", "max_abs_error<=0.05", "psnr>=80"):
        assert str(tio.parse_target(spec)) == str(rfrt.parse_target(spec))
        try:
            want = r.select(spec).bits
        except rfrt.TargetUnsatisfiable as exc:
            with pytest.raises(tio.TargetUnsatisfiable) as got:
                t.select(spec)
            assert got.value.best == exc.best and str(got.value) == str(exc)
        else:
            assert t.select(spec).bits == want
    for bad in ("psnr=>60", "ssim>=0.9", ""):
        with pytest.raises(ValueError):
            tio.parse_target(bad)
    reader = SimpleNamespace(frontier=t)
    assert resolve_single_target(reader, "psnr>=50") == "default"
    with pytest.raises(tio.TargetUnsatisfiable):
        resolve_single_target(reader, "psnr>=60")


# ------------------------------- shard map ----------------------------------


def _file_keys(snapshots):
    with tio.TACZReader(snapshots["ref_run1_z10"].path, device="cpu") as rd:
        return rd.subblock_keys()


@pytest.mark.parametrize("shards,seed", [(["s0", "s1", "s2"], 11),
                                         (["a", "b"], 0),
                                         ([f"n{i}" for i in range(5)], 3)])
def test_shard_map_owners_equal_the_reference(snapshots, ref, shards, seed):
    keys = _file_keys(snapshots) + [(2, tio.WHOLE_LEVEL), (7, 1234)]
    m = ShardMap(shards, seed=seed)
    rm = ref.ShardMap(shards, seed=seed)
    assert [m.owner(k) for k in keys] == [rm.owner(k) for k in keys]
    assert m.to_json() == rm.to_json()
    assert ShardMap.from_json(rm.to_json()) == m
    assert m.partition(keys) == rm.partition(keys)


def test_shard_map_client_server_agreement(snapshots):
    server_side = ShardMap(["s0", "s1", "s2"], seed=11)
    client_side = ShardMap.from_json(server_side.to_json())
    assert client_side == server_side
    for key in _file_keys(snapshots):
        assert client_side.owner(key) == server_side.owner(key)
    assert ShardMap.from_dict(server_side.to_dict()) == server_side


def test_shard_map_order_and_seed(snapshots):
    a = ShardMap(["x", "y", "z"], seed=3)
    b = ShardMap(["z", "x", "y"], seed=3)
    assert a == b and hash(a) == hash(b)
    assert all(a.owner(k) == b.owner(k) for k in _file_keys(snapshots))
    c = ShardMap(["x", "y", "z"], seed=4)
    keys = [(li, sbi) for li in range(4) for sbi in range(64)]
    assert any(a.owner(k) != c.owner(k) for k in keys)
    assert ShardMap(["a", "b"]).owner((2, tio.WHOLE_LEVEL)) in ("a", "b")


def test_shard_map_minimal_movement_on_add_and_remove():
    keys = [(li, sbi) for li in range(4) for sbi in range(128)]
    m = ShardMap([f"s{i}" for i in range(3)], seed=0)
    grown = m.with_shard("s3")
    moved = [k for k in keys if m.owner(k) != grown.owner(k)]
    assert all(grown.owner(k) == "s3" for k in moved)
    assert 0.10 * len(keys) < len(moved) < 0.45 * len(keys)
    m4 = ShardMap([f"s{i}" for i in range(4)], seed=0)
    shrunk = m4.without_shard("s1")
    for k in keys:
        if m4.owner(k) != "s1":
            assert shrunk.owner(k) == m4.owner(k)
        else:
            assert shrunk.owner(k) in shrunk.shards


def test_shard_map_partition_and_validation(snapshots):
    keys = _file_keys(snapshots)
    part = ShardMap(["a", "b", "c"], seed=1).partition(keys)
    assert sorted(k for ks in part.values() for k in ks) == sorted(keys)
    for bad in ([], ["a", "a"], ["a", ""]):
        with pytest.raises(ValueError):
            ShardMap(bad)
    with pytest.raises(ValueError):
        ShardMap(["a"]).with_shard("a")
    with pytest.raises(ValueError):
        ShardMap(["a"]).without_shard("z")
    with pytest.raises(ValueError):
        ShardMap.from_dict({"algorithm": "ring", "shards": ["a"]})


def test_shard_filtered_servers_zero_foreign_cells_and_cache_owned(
        snapshots):
    path = snapshots["ref_run1_z10"].path
    m = ShardMap(["s0", "s1"], seed=9)
    with _server(path) as full, \
            _server(path, shard_map=m, shard_id="s0") as s0, \
            _server(path, shard_map=m, shard_id="s1") as s1:
        want = full.get_roi(FULL)
        a, b = s0.get_roi(FULL), s1.get_roi(FULL)
        for w, ga, gb in zip(want, a, b):
            overlay = torch.where(ga.data != 0, ga.data, gb.data)
            assert torch.equal(overlay, w.data)
        cached = []
        for sid, srv in (("s0", s0), ("s1", s1)):
            for key in srv.cache._od:
                assert m.owner((key[1], key[2])) == sid
                cached.append((key[1], key[2]))
        assert len(cached) == len(set(cached)) > 0
        assert s0.stats()["shard"]["owned_keys"] + \
            s1.stats()["shard"]["owned_keys"] == len(full.reader.subblock_keys())
    with pytest.raises(ValueError, match="go together"):
        RegionServer(path, shard_map=m, device="cpu")


def test_shard_filter_on_a_whole_level_key(snapshots):
    path = snapshots["port_gsp"].path
    owner = ShardMap(["s0", "s1"], seed=2).owner((0, tio.WHOLE_LEVEL))
    other = "s1" if owner == "s0" else "s0"
    m = ShardMap(["s0", "s1"], seed=2)
    box = ((0, 16), (0, 16), (0, 16))
    with _server(path, shard_map=m, shard_id=owner) as mine, \
            _server(path, shard_map=m, shard_id=other) as theirs:
        assert not bool((theirs.get_roi(box)[0].data != 0).any())
        assert len(theirs.cache) == 0
        _same_roi(mine.get_roi(box), tio.read_roi(path, box, device="cpu"))


# ----------------------------- cache handoff ---------------------------------


def test_shard_map_grow_moves_only_to_new_shard(snapshots):
    keys = _file_keys(snapshots)
    m = ShardMap(["s0", "s1"], seed=7)
    new_map, moved = m.grow("s2", keys)
    assert new_map.shards == ("s0", "s1", "s2")
    assert 0 < len(moved) < len(keys)
    assert all(new_map.owner(k) == "s2" for k in moved)
    assert all(new_map.owner(k) == m.owner(k) for k in keys if k not in moved)


def test_cache_export_import_roundtrip(snapshots):
    path = snapshots["ref_run1_z10"].path
    m = ShardMap(["s0", "s1"], seed=7)
    with _server(path, shard_map=m, shard_id="s0") as old, \
            _server(path) as whole:
        old.get_regions([FULL])
        whole.get_regions([FULL])
        new_map, moved = m.grow("s2", old.reader.subblock_keys())
        blob = old.cache_export(moved)
        with _server(path, shard_map=new_map, shard_id="s2") as new:
            summary = new.cache_import(blob)
            assert summary["imported"] == sum(
                1 for k in moved if m.owner(k) == "s0") > 0
            assert summary["skipped_foreign"] == summary["skipped_stale"] == 0
            assert summary["snapshot_crc"] == new.snapshot_crc
            gen = new.snapshot_crc
            for li, sbi in moved:
                got = new.cache.peek((gen, li, sbi))
                if got is not None:
                    assert torch.equal(
                        got, whole.cache.peek((gen, li, sbi)))
            # the imported bricks serve: only keys moved from s1 decode
            before = new.cache.stats()["misses"]
            new.get_regions([FULL])
            assert new.cache.stats()["misses"] - before == sum(
                1 for k in moved if m.owner(k) == "s1")


def test_cache_import_rejects_corruption_and_stale(snapshots):
    import json
    import struct
    path = snapshots["ref_run1_z10"].path
    m = ShardMap(["s0", "s1"], seed=7)
    with _server(path, shard_map=m, shard_id="s0") as old:
        old.get_regions([FULL])
        new_map, moved = m.grow("s2", old.reader.subblock_keys())
        blob = old.cache_export(moved)
        with _server(path, shard_map=new_map, shard_id="s2") as new:
            bad = bytearray(blob)
            bad[-1] ^= 0xFF
            with pytest.raises(ValueError, match="CRC mismatch"):
                new.cache_import(bytes(bad))
            assert new.cache.stats()["entries"] == 0
            with pytest.raises(ValueError, match="truncated"):
                new.cache_import(blob[:-3])
            with pytest.raises(ValueError):
                new.cache_import(b"\x01")
            hlen = struct.unpack_from("<I", blob)[0]
            head = json.loads(blob[4:4 + hlen])
            head["snapshot_crc"] += 1
            hdr = json.dumps(head, sort_keys=True).encode()
            stale = struct.pack("<I", len(hdr)) + hdr + blob[4 + hlen:]
            summary = new.cache_import(stale)
            assert summary["imported"] == 0
            assert summary["skipped_stale"] == \
                sum(1 for k in moved if m.owner(k) == "s0")
        # a server that owns none of the moved keys skips them as foreign
        with _server(path, shard_map=new_map, shard_id="s1") as s1:
            assert s1.cache_import(blob)["skipped_foreign"] == \
                sum(1 for k in moved if m.owner(k) == "s0")


def test_reshard_drops_only_foreign_keys(snapshots):
    path = snapshots["ref_run1_z10"].path
    m = ShardMap(["s0", "s1"], seed=7)
    with _server(path, shard_map=m, shard_id="s0") as srv:
        srv.get_regions([FULL])
        before = srv.cache.stats()["entries"]
        new_map, moved = m.grow("s2", srv.reader.subblock_keys())
        dropped = srv.reshard(new_map)
        assert dropped == sum(1 for k in moved if m.owner(k) == "s0")
        assert srv.cache.stats()["entries"] == before - dropped
        gen = srv.snapshot_crc
        for li, sbi in srv.reader.subblock_keys():
            if srv.cache.peek((gen, li, sbi)) is not None:
                assert new_map.owner((li, sbi)) == "s0"
    with _server(path) as unsharded:
        assert unsharded.reshard(None) == 0


def test_cache_export_blobs_byte_identical_across_packages(snap, ref):
    """The port's blob is the reference's, byte for byte, and each
    package imports the other's."""
    with _server(snap.path) as srv, ref.RegionServer(snap.path) as rsrv:
        srv.get_regions(BOXES[:3])
        rsrv.get_regions(BOXES[:3])
        keys = srv.reader.subblock_keys() + [(0, 10 ** 6)]
        blob = srv.cache_export(keys)
        assert blob == rsrv.cache_export(keys)
        assert srv.cache_export([]) == rsrv.cache_export([])
        with _server(snap.path) as fresh, \
                ref.RegionServer(snap.path) as rfresh:
            assert fresh.cache_import(blob) == rfresh.cache_import(blob)
            assert fresh.cache_export(keys) == blob
            assert rfresh.cache_export(keys) == blob
            # the imported server serves the same crops with no miss
            for box in BOXES[:3]:
                _same_roi(fresh.get_roi(box), snap.roi[box])
            assert fresh.cache.stats()["misses"] == 0


# ----------------------- placement, staging, decode --------------------------


@pytest.mark.parametrize("chunk", [1 << 23, 100])
def test_batched_placement_equals_a_per_brick_loop(monkeypatch, chunk):
    """``_place`` (one scatter per shape group, in chunks of bricks) ==
    ``acc[slices] = brick`` brick by brick, on disjoint bricks."""
    monkeypatch.setattr(treader, "PLACE_CHUNK", chunk)
    rng = np.random.default_rng(4)
    dims, lo = (20, 24, 28), (2, 0, 4)
    bricks, origins = [], []
    for shape, cells in (((4, 4, 4), [(0, 0, 0), (4, 0, 4), (8, 12, 20)]),
                         ((2, 8, 4), [(12, 0, 0), (14, 8, 8)]),
                         ((6, 4, 2), [(0, 16, 24)])):
        for c in cells:
            bricks.append(torch.from_numpy(
                rng.normal(size=shape).astype(np.float32)))
            origins.append(tuple(o + l for o, l in zip(c, lo)))
    want = torch.zeros(dims)
    for brick, o in zip(bricks, origins):
        want[tuple(slice(a - l, a - l + s) for a, l, s
                   in zip(o, lo, brick.shape))] = brick
    groups: dict = {}
    for brick, o in zip(bricks, origins):
        g = groups.setdefault(tuple(brick.shape), ([], []))
        g[0].append(brick)
        g[1].append(o)
    got = torch.zeros(dims)
    with tio.TACZReader(os.path.join(HERE, "golden", "v1.tacz"),
                        device="cpu") as rd:
        rd._place(got, lo, [(torch.stack(bs), os_)
                            for bs, os_ in groups.values()])
    assert torch.equal(got, want)


def test_roi_and_level_box_match_the_reference(snap, ref):
    with tio.TACZReader(snap.path, device="cpu") as rd, \
            ref.io.TACZReader(snap.path) as rr:
        for li in range(rd.n_levels):
            for lbox in (((1, 9), (3, 30), (0, 5)), ((-4, 40), (2, 3),
                                                     (7, 99))):
                np.testing.assert_array_equal(
                    rd.read_level_box(li, lbox).numpy(),
                    rr.read_level_box(li, lbox))
        with pytest.raises(ValueError):
            rd.read_level_box(0, ((0, 1), (0, 1)))


def test_host_staging_packs_one_aligned_buffer():
    st = entropy.HostStaging()
    parts = [np.arange(5, dtype=np.uint8),
             np.arange(3, dtype=np.int64) - 7,
             np.linspace(0, 1, 6, dtype=np.float32).reshape(2, 3),
             np.zeros(0, dtype=np.int64)]
    idx = [st.add(a) for a in parts]
    views = st.upload("cpu")
    base = views[0].untyped_storage().data_ptr()
    for i, a in zip(idx, parts):
        v = views[i]
        assert v.untyped_storage().data_ptr() == base   # one buffer
        assert (v.storage_offset() * v.element_size()) % 8 == 0
        np.testing.assert_array_equal(v.numpy(), a)
    with pytest.raises(TypeError):
        st.add(np.zeros(2, dtype=np.float64))


def _streams(seed, n=6):
    rng = np.random.default_rng(seed)
    streams = [rng.integers(-9, 10, size=int(rng.integers(1, 300)))
               for _ in range(n)]
    cb = huffman.build_codebook(np.concatenate(streams))
    eng = entropy.TorchEngine("cpu")
    return cb, eng, streams, eng.encode_payloads(cb, streams)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_limited_decode_equals_the_padding_it_replaced(seed):
    """One launch with ``out_off`` spaced by the full code counts ==
    decoding the prefixes alone and padding each with zeros."""
    cb, eng, streams, pays = _streams(seed)
    rng = np.random.default_rng(100 + seed)
    limits = [int(rng.integers(0, s.size + 1)) for s in streams]
    triples = [(b, nb, lim) for (b, nb), lim in zip(pays, limits)]
    staging = entropy.HostStaging()
    batch = eng.stage(staging, cb, triples, spans=[s.size for s in streams])
    got = eng.decode_staged(batch, staging.upload("cpu"))
    short = eng.decode_payloads(cb, triples)
    for g, p, s, lim in zip(got, short, streams, limits):
        padded = torch.zeros(s.size, dtype=torch.int64)
        padded[:lim] = p
        assert torch.equal(g, padded)
        np.testing.assert_array_equal(g[:lim].numpy(), s[:lim])
    with pytest.raises(ValueError, match="span"):
        eng.stage(entropy.HostStaging(), cb,
                  [(pays[0][0], pays[0][1], streams[0].size)],
                  spans=[streams[0].size - 1])


def test_decode_split_reads_no_device_tensor(monkeypatch):
    """The decode splits by the host counts it was built from: no tensor
    is read back to the host on a clean decode."""
    cb, eng, streams, pays = _streams(5)
    triples = [(b, nb, s.size) for (b, nb), s in zip(pays, streams)]

    def refuse(self, *a, **k):
        raise AssertionError("a device tensor was read back")

    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    got = eng.decode_payloads(cb, triples)
    monkeypatch.undo()
    for g, s in zip(got, streams):
        np.testing.assert_array_equal(g.numpy(), s)


# ------------------------------- on the card ---------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_card_serves_the_golden_fixture():
    dev = _card()
    path = os.path.join(HERE, "golden", "v1.tacz")
    with np.load(os.path.join(HERE, "golden", "expected.npz")) as z:
        want = [z["level0"], z["level1"]]
    boxes = [((0, 16), (0, 16), (0, 16)), ((3, 11), (0, 5), (9, 16))]
    with RegionServer(path, device=dev, cache_bytes=1 << 20) as srv, \
            tio.TACZReader(path, device=dev) as rd:
        for rep in range(2):                       # cold, then warm
            for box in boxes:
                got = srv.get_roi(box)
                for g, r in zip(got, rd.read_roi(box)):
                    assert g.data.device.type == "cuda"
                    assert torch.equal(g.data, r.data)
                    np.testing.assert_array_equal(
                        g.data.cpu().numpy(),
                        want[g.level][tuple(slice(lo, hi)
                                            for lo, hi in g.box)])
        assert srv.cache.stats()["hits"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", [("golden", "v1.tacz"),
                                  ("card_reference", "gsp_lorenzo.tacz")])
def test_card_concurrent_cold_decodes(name):
    """Eight threads race on a cold device cache: concurrent pinned
    uploads, kernel-4/2/6 launches and cached device tensors shared
    across requests; every crop equals ``read_roi`` on the card."""
    dev = _card()
    path = os.path.join(HERE, *name)
    with tio.TACZReader(path, device=dev) as rd:
        shape = rd.levels[0].shape
        rng = np.random.default_rng(7)
        boxes = []
        for _ in range(12):
            lo = [int(rng.integers(0, s - 1)) for s in shape]
            boxes.append(tuple((l, int(rng.integers(l + 1, s + 1)))
                               for l, s in zip(lo, shape)))
        refs = {b: rd.read_roi(b) for b in boxes}
    errors: list[BaseException] = []
    with RegionServer(path, device=dev, cache_bytes=64 << 20) as srv:
        start = threading.Barrier(8)

        def worker(seed):
            try:
                order = np.random.default_rng(seed).permutation(len(boxes))
                start.wait()
                for i in order:
                    for g, r in zip(srv.get_roi(boxes[i]), refs[boxes[i]]):
                        assert g.data.device.type == "cuda"
                        assert torch.equal(g.data, r.data)
            except BaseException as exc:   # surfaces in the main thread
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert srv.cache.nbytes == sum(
            b.numel() * 4 for b in srv.cache._od.values())
    if errors:
        raise errors[0]


@pytest.mark.cuda
def test_card_serves_a_gsp_level_through_kernel_6():
    from repro_torch.kernels import ops
    dev = _card()
    path = os.path.join(HERE, "card_reference", "gsp_lorenzo.tacz")
    with np.load(os.path.join(HERE, "card_reference",
                              "gsp_lorenzo_recon.npz")) as z:
        recon = z["recon"]
    box = ((5, 47), (0, 64), (20, 33))
    sl = tuple(slice(lo, hi) for lo, hi in box)
    ops.reset_launches()
    with RegionServer(path, device=dev) as srv:
        assert srv.reader.subblock_keys() == [(0, tio.WHOLE_LEVEL)]
        cold = srv.get_roi(box)[0].data
        assert ops.launches["lorenzo3d_recon"] >= 1
        warm = srv.get_roi(box)[0].data
        assert srv.cache.stats()["hits"] == 1
    crop = tio.read_roi(path, box, device=dev)[0].data
    for got in (cold, warm):
        assert torch.equal(got, crop)
        np.testing.assert_array_equal(got.cpu().numpy(), recon[sl])
