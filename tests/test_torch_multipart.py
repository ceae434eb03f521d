"""Multi-part snapshots and the remaining compress options of the port
(``repro_torch.io.parallel``, ``io.manifest``, ``core.she``,
``core.hybrid``, ``core.adaptive_eb``, ``io.writer``) against the
reference, on the CPU.

The reference runs its numpy host path (``lorenzo_engine="numpy"``,
``entropy_engine="batched"``), the port ``device="cpu"`` (every kernel's
plain version), on seeded ``synthetic_amr`` inputs of up to 64³.  Every
comparison is exact: manifest bytes and CRCs, part files byte for byte,
level signatures, decoded levels and crops bit for bit, codes, branches,
bit counts and codebooks.  Covered: the manifest and its validation, the
payload-slice fan-out for 1-4 parts and two codecs, raw levels through
the parallel writer in thread mode and in spawned processes, cross reads
and the golden ``multipart.taczd``, a GSP level's single owner, crash
consistency (a killed worker, a failing worker, a re-run, an abort),
region serving over a directory (hot swap, part-aligned shards), and
``she_encode``/``compress_amr``/``TACZWriter`` options.

The ``cuda`` tests import no JAX (the reference is imported inside the CPU
tests' bodies and fixtures), so they run on the card's machine with
``pytest --noconftest -m cuda``.
"""
import json
import os
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import io as tio
from repro_torch.convert import dataset_from_arrays
from repro_torch.core import adaptive_eb, amr, huffman, hybrid, she
from repro_torch.io import manifest as mfst
from repro_torch.io import parallel as tpar
from repro_torch.io import reader as treader
from repro_torch.io import writer as twriter
from repro_torch.kernels import ops
from repro_torch.serving import RegionServer, ShardMap

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "golden")

BOXES = [((0, 8), (0, 8), (0, 8)),
         ((5, 23), (11, 30), (2, 9)),
         ((0, 32), (0, 32), (0, 32)),
         ((14, 18), (14, 18), (14, 18)),
         ((40, 50), (0, 4), (0, 4))]          # beyond the extent
REF_ENGINES = {"lorenzo_engine": "numpy", "entropy_engine": "batched"}


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (imported here, not at module level)."""
    from repro import io as rio
    from repro.core import adaptive_eb as radaptive
    from repro.core import amr as ramr
    from repro.core import huffman as rhuffman
    from repro.core import hybrid as rhybrid
    from repro.core import she as rshe
    from repro.io import frontier as rfrt
    from repro.io import manifest as rmfst
    from repro.io import parallel as rpar
    from repro.io import reader as rreader
    from repro.io import writer as rwriter
    from repro.serving import regions as rregions
    from repro.serving import sharded as rsharded
    return SimpleNamespace(io=rio, adaptive=radaptive, amr=ramr,
                           huffman=rhuffman, hybrid=rhybrid, she=rshe,
                           frt=rfrt, mfst=rmfst, par=rpar, reader=rreader,
                           writer=rwriter,
                           RegionServer=rregions.RegionServer,
                           ShardMap=rsharded.ShardMap)


def _dataset(ref, shape=(32, 32, 32), densities=(0.35, 0.65), seed=5):
    """A seeded dataset in both packages' types, with ``eb = 1e-3 ·
    range`` of the finest level."""
    rds = ref.amr.synthetic_amr(tuple(shape), densities=list(densities),
                                refine_block=4, seed=seed)
    eb = 1e-3 * float(rds.levels[0].data.max() - rds.levels[0].data.min())
    ds = dataset_from_arrays([(l.data, l.mask, l.ratio) for l in rds.levels])
    return rds, ds, eb


@pytest.fixture(scope="module")
def data(ref, tmp_path_factory):
    """The 32³ two-level dataset compressed by both packages, and the
    reference's single-file snapshot of it."""
    rds, ds, eb = _dataset(ref)
    rres = ref.hybrid.compress_amr(rds, eb=eb, lorenzo_engine="numpy")
    res = hybrid.compress_amr(ds, eb=eb, device="cpu")
    single = str(tmp_path_factory.mktemp("single") / "snap.tacz")
    ref.io.write(single, rres, payload_codec="zlib")
    return SimpleNamespace(rds=rds, ds=ds, eb=eb, rres=rres, res=res,
                           single=single)


def _files(path: str) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def _same_levels(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _same_roi(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.level, g.ratio, g.box) == (w.level, w.ratio, w.box)
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))


def _ref_raw(ref, path, rds, eb, parts, **kw):
    with ref.par.ParallelTACZWriter(path, parts=parts, mode="thread", eb=eb,
                                    **REF_ENGINES, **kw) as w:
        for lvl in rds.levels:
            w.add_level(lvl.data, lvl.mask, ratio=lvl.ratio)


def _port_raw(path, ds, eb, parts, mode="thread", **kw):
    with tpar.ParallelTACZWriter(path, parts=parts, mode=mode, eb=eb,
                                 device="cpu", **kw) as w:
        for lvl in ds.levels:
            w.add_level(lvl.data, lvl.mask, ratio=lvl.ratio)


# ------------------------------- manifest -----------------------------------


def _frontier(frt, res):
    dp = frt.FrontierPoint(ebs=tuple(lr.eb for lr in res.levels),
                           bits=res.total_bits,
                           metrics={"psnr": 72.0, "max_abs_error": 1e-3})
    return frt.Frontier(metric="psnr", points=[dp], default=0)


def test_manifest_bytes_and_crc_equal_the_reference(ref, tmp_path, data):
    body = {"magic": mfst.MANIFEST_MAGIC, "version": mfst.MANIFEST_VERSION,
            "n_levels": 2, "subblocks": [5, 1],
            "partition": {"algorithm": "rendezvous-blake2b64", "seed": 3,
                          "shards": ["part-0000", "part-0001"]},
            "parts": [{"name": "part-0000.tacz", "size": 10,
                       "index_crc": 7, "levels": [[0, 2, 4], [0]]},
                      {"name": "part-0001.tacz", "size": 11,
                       "index_crc": 4294967295, "levels": [[1, 3], []]}],
            "frontier": _frontier(ref.frt, data.rres).to_dict()}
    assert mfst.canonical_bytes(body) == ref.mfst.canonical_bytes(body)
    assert mfst.manifest_crc(body) == ref.mfst.manifest_crc(body)
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    mfst.write_atomic(str(a), body)
    ref.mfst.write_atomic(str(b), body)
    assert _files(str(a)) == _files(str(b))
    assert mfst.load(str(a)) == ref.mfst.load(str(a))
    assert mfst.probe_crc(str(a)) == ref.mfst.probe_crc(str(b))
    assert [mfst.part_name(i) for i in (0, 7, 12345)] == \
        [ref.mfst.part_name(i) for i in (0, 7, 12345)]
    (a / "part-0003.tacz.tmp").write_bytes(b"x")
    (a / "part-0003.tacz.tmpx").write_bytes(b"x")
    assert mfst.stale_parts(str(a)) == ref.mfst.stale_parts(str(a)) == \
        ["part-0003.tacz.tmp"]
    assert mfst.is_multipart(str(a)) and mfst.is_multipart(
        str(a / "manifest.json"))
    assert not mfst.is_multipart(str(tmp_path)) and not mfst.is_multipart(
        b"bytes")


def _raises_alike(ref, path):
    """Both packages refuse ``path`` with the same exception type."""
    with pytest.raises(Exception) as want:
        ref.par.MultiPartReader(path)
    with pytest.raises(want.type):
        tpar.MultiPartReader(path, device="cpu")
    return want.value


def test_manifest_validation_rejects_like_the_reference(ref, data, tmp_path):
    def snapshot(name):
        path = str(tmp_path / name)
        tpar.write_multipart(path, data.res, parts=2, payload_codec="zlib",
                             device="cpu")
        return path

    # a hand-edited manifest fails its CRC; the probe reports nothing
    path = snapshot("edited.taczd")
    mpath = os.path.join(path, mfst.MANIFEST_NAME)
    with open(mpath) as f:
        body = json.load(f)
    body["n_levels"] = 99
    with open(mpath, "w") as f:
        json.dump(body, f)
    assert "CRC" in str(_raises_alike(ref, path))
    assert treader.probe_index_crc(path) is None
    assert ref.reader.probe_index_crc(path) is None

    # a torn part, and a stale one (valid TACZ, another generation)
    path = snapshot("torn.taczd")
    part = os.path.join(path, "part-0001.tacz")
    with open(part, "rb") as f:
        blob = f.read()
    with open(part, "wb") as f:
        f.write(blob[:len(blob) // 2])
    _raises_alike(ref, path)
    path = snapshot("stale.taczd")
    shutil.copy(data.single, os.path.join(path, "part-0001.tacz"))
    assert "CRC" in str(_raises_alike(ref, path))

    # a part count that does not match: a re-stamped manifest naming a
    # third part that is not there, or dropping one of the two
    for name, parts in (("extra.taczd", 3), ("short.taczd", 1)):
        path = snapshot(name)
        body = mfst.load(path)
        if parts == 3:
            body["parts"].append(dict(body["parts"][1],
                                      name="part-0002.tacz"))
        else:
            body["parts"] = body["parts"][:1]
        mfst.write_atomic(path, body)
        _raises_alike(ref, path)

    # flipped payload bytes: open succeeds, verify() fails in both
    path = snapshot("flipped.taczd")
    part = os.path.join(path, "part-0000.tacz")
    with open(part, "rb") as f:
        blob = bytearray(f.read())
    with tio.TACZReader(part, device="cpu") as prd:
        sb = next(sb for e in prd.levels for sb in e.subblocks)
    blob[sb.payload_off + sb.payload_len - 1] ^= 0xFF
    with open(part, "wb") as f:
        f.write(bytes(blob))
    with tpar.MultiPartReader(path, device="cpu") as rd:
        with pytest.raises(IOError, match="CRC"):
            rd.verify()
    with ref.par.MultiPartReader(path) as rr:
        with pytest.raises(IOError, match="CRC"):
            rr.verify()


# --------------------------- compressed levels -------------------------------


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_compressed_levels_write_the_reference_bytes(ref, data, tmp_path,
                                                     parts, codec):
    """The payload-slice fan-out: every part file and the manifest equal
    the reference's byte for byte, each level's signature equals the
    single-file snapshot's, and the directory decodes to the
    compress-time recon."""
    a, b = str(tmp_path / "ref.taczd"), str(tmp_path / "port.taczd")
    fr = _frontier(ref.frt, data.rres)
    ref.io.write_multipart(a, data.rres, parts=parts, payload_codec=codec,
                           frontier=fr)
    tio.write_multipart(b, data.res, parts=parts, payload_codec=codec,
                        frontier=tio.Frontier.from_dict(fr.to_dict()),
                        device="cpu")
    assert _files(a) == _files(b)
    single = str(tmp_path / "single.tacz")
    tio.write(single, data.res, payload_codec=codec, device="cpu")
    with tio.TACZReader(single, device="cpu") as srd, \
            tio.open_snapshot(b, device="cpu") as mrd:
        assert isinstance(mrd, tio.MultiPartReader)
        assert (mrd.n_parts, mrd.version) == (parts, srd.version)
        assert mrd.subblock_keys() == srd.subblock_keys()
        for li in range(srd.n_levels):
            assert mrd.level_signature(li) == srd.level_signature(li)
        _same_levels(mrd.read(), [lr.recon for lr in data.res.levels])
        assert mrd.frontier.default_point.metrics["psnr"] == 72.0
        assert mrd.verify()


# ------------------------------ raw levels -----------------------------------


@pytest.fixture(scope="module")
def preset(ref):
    """The reference's ``run1_z10`` preset (64³) in both packages, with
    the port's single-file decode of it."""
    rds = ref.amr.load_preset("run1_z10")
    eb = 1e-3 * float(rds.levels[0].data.max() - rds.levels[0].data.min())
    ds = dataset_from_arrays([(l.data, l.mask, l.ratio) for l in rds.levels])
    res = hybrid.compress_amr(ds, eb=eb, device="cpu")
    return SimpleNamespace(rds=rds, ds=ds, eb=eb, res=res)


def test_raw_levels_thread_mode_write_the_reference_bytes(ref, preset,
                                                          tmp_path):
    """Each worker compresses its own bricks with a codebook of its own:
    the part files equal the reference's thread-mode output, and the
    decode equals the single-file decode bit for bit."""
    a, b = str(tmp_path / "ref.taczd"), str(tmp_path / "port.taczd")
    _ref_raw(ref, a, preset.rds, preset.eb, 3, payload_codec="zlib")
    _port_raw(b, preset.ds, preset.eb, 3, payload_codec="zlib")
    assert _files(a) == _files(b)
    with tio.open_snapshot(b, device="cpu") as rd:
        _same_levels(rd.read(), [lr.recon for lr in preset.res.levels])
        box = ((10, 50), (3, 64), (20, 30))
        with ref.io.open_snapshot(a) as rr:
            _same_roi(rd.read_roi(box), rr.read_roi(box))


def test_raw_levels_process_mode_spawns_the_same_bytes(ref, data, tmp_path):
    """Spawned workers (two parts) write the reference's thread-mode
    bytes; their stage totals come home in ``worker_obs`` and their own
    launch counts in ``worker_launches``, apart from this process's."""
    a, b = str(tmp_path / "ref.taczd"), str(tmp_path / "port.taczd")
    _ref_raw(ref, a, data.rds, data.eb, 2, payload_codec="zlib")
    before = dict(ops.launches)
    with tpar.ParallelTACZWriter(b, parts=2, mode="process", eb=data.eb,
                                 payload_codec="zlib", device="cpu") as w:
        assert not tpar.fork_safe()
        assert all(p.__class__.__name__ == "SpawnProcess"
                   for p in w._workers)
        for lvl in data.ds.levels:
            w.add_level(lvl.data, lvl.mask, ratio=lvl.ratio)
    assert _files(a) == _files(b)
    assert sorted(w.worker_obs) == [0, 1]
    assert all(o["levels"] == data.ds.n_levels for o in w.worker_obs.values())
    assert sorted(w.worker_launches) == [0, 1]
    for counts in w.worker_launches.values():   # the CPU launches nothing
        assert counts == dict.fromkeys(ops.launches, 0)
    assert ops.launches == before
    with tio.open_snapshot(b, device="cpu") as rd:
        _same_levels(rd.read(), [lr.recon for lr in data.res.levels])


def test_process_mode_compressed_levels_cross_as_host_arrays(data, tmp_path):
    """``add_compressed`` in process mode ships numpy codes to spawned
    workers: the directory equals thread mode's byte for byte."""
    a, b = str(tmp_path / "t.taczd"), str(tmp_path / "p.taczd")
    tio.write_multipart(a, data.res, parts=2, device="cpu")
    tio.write_multipart(b, data.res, parts=2, mode="process", device="cpu")
    assert _files(a) == _files(b)


# --------------------------- cross reads, golden ------------------------------


def test_each_package_reads_the_others_directory(ref, data, tmp_path):
    a, b = str(tmp_path / "ref.taczd"), str(tmp_path / "port.taczd")
    _ref_raw(ref, a, data.rds, data.eb, 3, payload_codec="none")
    _port_raw(b, data.ds, data.eb, 3, payload_codec="none")
    with ref.io.open_snapshot(b) as rr, \
            tio.open_snapshot(a, device="cpu") as rd:
        assert rr.index_crc == rd.index_crc
        want = rr.read()
        _same_levels(rd.read(), want)
        for lr, w in zip(data.rres.levels, want):
            np.testing.assert_array_equal(lr.recon, w)
        for box in BOXES:
            _same_roi(rd.read_roi(box), rr.read_roi(box))


def test_golden_multipart_decodes_to_expected():
    path = os.path.join(GOLD, "multipart.taczd")
    with np.load(os.path.join(GOLD, "expected.npz")) as z:
        expected = {k: z[k] for k in z.files}
    with tio.open_snapshot(path, device="cpu") as rd:
        assert isinstance(rd, tio.MultiPartReader)
        assert rd.n_parts == 2 and rd.verify()
        for li in range(rd.n_levels):
            np.testing.assert_array_equal(rd.read_level(li).numpy(),
                                          expected[f"level{li}"])
        assert rd.frontier.default_point.metrics["psnr"] == 72.0
        assert rd.frontier_error is None
        assert rd.index_crc == treader.probe_index_crc(path)
    with tio.open_snapshot(os.path.join(path, "manifest.json"),
                           device="cpu") as rd:
        np.testing.assert_array_equal(rd.read_level(0).numpy(),
                                      expected["level0"])


# ---------------------------------- GSP --------------------------------------


def test_gsp_level_is_owned_by_one_part(ref, tmp_path):
    # 16³: the plain decoder walks a GSP level's one payload symbol by
    # symbol
    rds = ref.amr.synthetic_amr((16, 16, 16), densities=[0.9, 0.1],
                                refine_block=4, seed=7)
    lvl = rds.levels[0]
    rlr = ref.hybrid.compress_level(lvl.data, lvl.mask, eb=0.01, unit=4,
                                    strategy="gsp", lorenzo_engine="numpy")
    lr = hybrid.compress_level(lvl.data, lvl.mask, eb=0.01, unit=4,
                               strategy="gsp", device="cpu")
    a, b = str(tmp_path / "ref.taczd"), str(tmp_path / "port.taczd")
    with ref.par.ParallelTACZWriter(a, parts=3) as w:
        w.add_compressed(rlr)
    with tpar.ParallelTACZWriter(b, parts=3, device="cpu") as w:
        w.add_compressed(lr)
    assert _files(a) == _files(b)
    owners = [p["levels"][0] for p in mfst.load(b)["parts"]]
    assert sorted(sum(owners, [])) == [0]
    with tpar.MultiPartReader(b, device="cpu") as rd:
        assert rd.subblock_keys() == [(0, treader.WHOLE_LEVEL)]
        _same_levels(rd.read(), [lr.recon])
    # a raw gsp level, compressed by the part that owns it
    a, b = str(tmp_path / "ref2.taczd"), str(tmp_path / "port2.taczd")
    with ref.par.ParallelTACZWriter(a, parts=3, eb=0.01, unit=4,
                                    strategy="gsp", **REF_ENGINES) as w:
        w.add_level(lvl.data, lvl.mask)
    with tpar.ParallelTACZWriter(b, parts=3, eb=0.01, unit=4,
                                 strategy="gsp", device="cpu") as w:
        w.add_level(lvl.data, lvl.mask)
    assert _files(a) == _files(b)
    with tpar.MultiPartReader(b, device="cpu") as rd:
        _same_levels(rd.read(), [lr.recon])


# --------------------------- crash consistency -------------------------------


def test_killed_part_worker_never_publishes(data, ref, tmp_path):
    """Kill one spawned worker mid-republish: close() fails, no new
    manifest appears, the victim's tmp is detected as litter, and the
    published snapshot survives byte for byte (two-phase commit)."""
    prior = _dataset(ref, densities=(0.5, 0.5), seed=9)
    prior_res = hybrid.compress_amr(prior[1], eb=prior[2], device="cpu")
    path = str(tmp_path / "killed.taczd")
    tio.write_multipart(path, prior_res, parts=3, device="cpu")
    before = _files(path)
    crc = treader.probe_index_crc(path)
    w = tpar.ParallelTACZWriter(path, parts=3, mode="process", eb=data.eb,
                                device="cpu")
    try:
        w.add_level(data.ds.levels[0].data, data.ds.levels[0].mask, ratio=1)
        victim = w._workers[1]
        victim_tmp = os.path.join(path, "part-0001.tacz.tmp")
        deadline = time.time() + 120
        while not os.path.exists(victim_tmp):    # the worker is mid-stream
            assert time.time() < deadline
            time.sleep(0.02)
        victim.terminate()
        victim.join()
        with pytest.raises(RuntimeError, match="manifest not published"):
            for _ in range(50):   # the dead worker surfaces on add or close
                w.add_level(data.ds.levels[1].data, data.ds.levels[1].mask,
                            ratio=2)
            w.close()
    finally:
        w.abort()
    assert mfst.stale_parts(path) == ["part-0001.tacz.tmp"]
    assert treader.probe_index_crc(path) == crc
    assert {k: v for k, v in _files(path).items()
            if not k.endswith(".tmp")} == before
    with tpar.MultiPartReader(path, device="cpu") as rd:
        _same_levels(rd.read(), [lr.recon for lr in prior_res.levels])


def test_worker_error_aborts_all_parts(tmp_path):
    path = str(tmp_path / "err.taczd")
    w = tpar.ParallelTACZWriter(path, parts=2, eb=-1.0, device="cpu")
    with pytest.raises(RuntimeError, match="error bound"):
        for _ in range(50):
            w.add_level(np.ones((8, 8, 8), np.float32))
        w.close()
    w.abort()
    assert not os.path.exists(os.path.join(path, mfst.MANIFEST_NAME))
    assert mfst.stale_parts(path) == []
    assert not any(n.endswith(".tacz") for n in os.listdir(path))


def test_crash_rerun_converges_and_keeps_old_snapshot(data, ref, tmp_path):
    path = str(tmp_path / "conv.taczd")
    tio.write_multipart(path, data.res, parts=2, device="cpu")
    crc = treader.probe_index_crc(path)
    for i in range(2):     # a writer killed before publishing
        (tmp_path / "conv.taczd" / (mfst.part_name(i) + ".tmp")).write_bytes(
            b"half-written garbage")
    assert mfst.stale_parts(path) == ["part-0000.tacz.tmp",
                                      "part-0001.tacz.tmp"]
    assert treader.probe_index_crc(path) == crc
    with tpar.MultiPartReader(path, device="cpu") as rd:
        _same_levels(rd.read(), [lr.recon for lr in data.res.levels])
    other = _dataset(ref, densities=(0.5, 0.5), seed=9)
    other_res = hybrid.compress_amr(other[1], eb=other[2], device="cpu")
    tio.write_multipart(path, other_res, parts=2, device="cpu")
    assert mfst.stale_parts(path) == []
    assert treader.probe_index_crc(path) != crc
    with tpar.MultiPartReader(path, device="cpu") as rd:
        _same_levels(rd.read(), [lr.recon for lr in other_res.levels])


def test_abort_leaves_no_trace(data, tmp_path):
    path = str(tmp_path / "abort.taczd")
    w = tpar.ParallelTACZWriter(path, parts=2, eb=data.eb, device="cpu")
    w.add_level(data.ds.levels[0].data, data.ds.levels[0].mask, ratio=1)
    w.abort()
    assert os.listdir(path) == []
    with pytest.raises(ValueError):
        w.add_level(data.ds.levels[0].data, data.ds.levels[0].mask)


def test_writer_rejects_bad_arguments(tmp_path):
    for kw in ({"parts": 0}, {"mode": "fork"}, {"payload_codec": "lz4"},
               {"entropy_engine": "gpu"}, {"lorenzo_engine": "gpu"},
               {"device": "meta"}):
        with pytest.raises(ValueError):
            tpar.ParallelTACZWriter(str(tmp_path / "bad"), **{
                "device": "cpu", **kw})
    with pytest.raises(TypeError):
        tio.write_multipart(str(tmp_path / "bad"), object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tpar.ParallelTACZWriter(str(tmp_path / "bad"))
        with pytest.raises(RuntimeError):
            tpar.MultiPartReader(os.path.join(GOLD, "multipart.taczd"))


def test_launch_counts_hold_under_threads():
    """Part workers count kernel launches from many threads at once: no
    update may be lost, and a failed launch counts nothing."""
    import sys
    import threading
    n_threads, per_thread = 16, 2000
    saved = dict(ops.launches)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ops.reset_launches()
        start = threading.Barrier(n_threads)

        def work():
            start.wait()
            for _ in range(per_thread):
                ops._launched("hist", 0)
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert ops.launches["hist"] == n_threads * per_thread
        with pytest.raises(RuntimeError):
            ops._launched("hist", 700)
        assert ops.launches["hist"] == n_threads * per_thread
    finally:
        sys.setswitchinterval(old)
        ops.launches.update(saved)


# -------------------------------- serving ------------------------------------


def test_region_server_serves_a_directory(ref, data, tmp_path):
    """Crops from the directory equal the single-file server's and the
    reference's server's, cold and warm."""
    path = str(tmp_path / "m.taczd")
    tio.write_multipart(path, data.res, parts=3, payload_codec="zlib",
                        device="cpu")
    with RegionServer(path, cache_bytes=32 << 20, device="cpu") as srv, \
            RegionServer(data.single, cache_bytes=32 << 20,
                         device="cpu") as one, \
            ref.RegionServer(path, cache_bytes=32 << 20) as rsrv:
        assert isinstance(srv.reader, tio.MultiPartReader)
        want = rsrv.get_regions(BOXES)
        for _ in range(2):                                  # cold, warm
            got = srv.get_regions(BOXES)
            for g, o, w in zip(got, one.get_regions(BOXES), want):
                _same_roi(g, w)
                _same_roi(o, w)
        assert srv.cache.stats()["hits"] > 0
        assert srv.snapshot_crc == rsrv.snapshot_crc == \
            treader.probe_index_crc(path)


def test_multipart_hot_swap_through_server(ref, data, tmp_path):
    """Republishing with fewer parts hot-swaps on the manifest CRC and
    removes the parts the new manifest does not name."""
    other = _dataset(ref, densities=(0.5, 0.5), seed=9)
    other_res = hybrid.compress_amr(other[1], eb=other[2], device="cpu")
    path = str(tmp_path / "hot.taczd")
    tio.write_multipart(path, data.res, parts=3, device="cpu")
    box = ((0, 32), (0, 32), (0, 32))
    with RegionServer(path, cache_bytes=32 << 20, device="cpu") as srv:
        assert torch.equal(srv.get_roi(box)[0].data, data.res.levels[0].recon)
        old = srv.snapshot_crc
        assert srv.maybe_reload() is False
        tio.write_multipart(path, other_res, parts=2, device="cpu")
        assert srv.maybe_reload() is True
        assert srv.snapshot_crc != old
        assert torch.equal(srv.get_roi(box)[0].data,
                           other_res.levels[0].recon)
        assert srv.health()["status"] == "ok"
    assert sorted(n for n in os.listdir(path) if n.endswith(".tacz")) == \
        ["part-0000.tacz", "part-0001.tacz"]


def test_part_aligned_shard_servers_open_only_their_part(ref, data,
                                                         tmp_path):
    """A shard map from the manifest's ``partition`` gives each shard one
    part's keys: its crops equal the reference's shard server's, and it
    opens no part but its own."""
    path = str(tmp_path / "shards.taczd")
    tio.write_multipart(path, data.res, parts=3, device="cpu")
    with tpar.MultiPartReader(path, device="cpu") as rd:
        m = ShardMap.from_dict(rd.partition)
        rm = ref.ShardMap.from_dict(rd.partition)
        part_keys = {f"part-{pi:04d}": {
            (li, g) for li, idxs in enumerate(p["levels"]) for g in idxs}
            for pi, p in enumerate(rd.manifest["parts"])}
    assert sorted(m.shards) == sorted(part_keys)
    for pi, sid in enumerate(sorted(m.shards)):
        with RegionServer(path, shard_map=m, shard_id=sid,
                          device="cpu") as srv, \
                ref.RegionServer(path, shard_map=rm, shard_id=sid) as rsrv:
            assert srv._owned == part_keys[sid]
            for g, w in zip(srv.get_regions(BOXES),
                            rsrv.get_regions(BOXES)):
                _same_roi(g, w)
            assert srv.reader.open_parts in ([], [pi])


# -------------------------- remaining compress options -----------------------


def _bricks(seed):
    rng = np.random.default_rng(seed)
    shapes = [(8, 8, 8), (8, 8, 8), (4, 8, 16), (2, 6, 6, 6), (8, 8, 8),
              (6, 12, 6)]
    return [np.cumsum(rng.normal(0, 2, s), axis=-1).astype(np.float32)
            for s in shapes]


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("batched", [True, False])
def test_she_encode_options_equal_the_reference(ref, shared, batched):
    """Codes, branches, betas, recon, bit counts and codebooks of every
    (shared, batched) pair, with a 4D brick in the list."""
    bricks = _bricks(4)
    want = ref.she.she_encode(bricks, 0.05, shared=shared, batched=batched,
                              lorenzo_engine="numpy")
    got = she.she_encode(bricks, 0.05, shared=shared, batched=batched,
                         device="cpu")
    assert (got.payload_bits, got.codebook_bits, got.meta_bits) == \
        (want.payload_bits, want.codebook_bits, want.meta_bits)
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g.codes.numpy(), w.codes)
        np.testing.assert_array_equal(g.recon.numpy(), w.recon)
        assert (g.method, g.payload_bits, g.codebook_bits, g.meta_bits) == \
            (w.method, w.payload_bits, w.codebook_bits, w.meta_bits)
        assert g.extras.get("branch") == w.extras.get("branch")
        if "betas" in w.extras:
            np.testing.assert_array_equal(g.extras["betas"].numpy(),
                                          w.extras["betas"])
    if shared:
        assert huffman.serialize_codebook(got.codebook) == \
            ref.huffman.serialize_codebook(want.codebook)
    else:
        assert got.codebook is None and want.codebook is None


def test_she_engine_names_are_validated():
    bricks = _bricks(5)[:2]
    base = she.she_encode(bricks, 0.05, device="cpu")
    for kw in ({"hist_engine": "pallas"}, {"lorenzo_engine": "numpy"},
               {"entropy_engine": "batched"}):
        alt = she.she_encode(bricks, 0.05, device="cpu", **kw)
        assert alt.total_bits == base.total_bits
    for kw in ({"hist_engine": "gpu"}, {"lorenzo_engine": "gpu"},
               {"entropy_engine": "gpu"}):
        with pytest.raises(ValueError):
            she.she_encode(bricks, 0.05, device="cpu", **kw)


def test_brick_payloads_round_trip_like_the_reference(ref):
    rng = np.random.default_rng(2)
    streams = [np.rint(rng.laplace(0, 5, n)).astype(np.int64)
               for n in (0, 1, 17, 300)]
    pooled = np.concatenate(streams)
    cb = huffman.build_codebook(pooled)
    rcb = ref.huffman.build_codebook(pooled)
    got = she.encode_brick_payloads(cb, streams, engine="numpy",
                                    device="cpu")
    assert got == ref.she.encode_brick_payloads(rcb, streams, engine="numpy")
    back = she.decode_brick_payloads(
        cb, [(b, n, s.size) for (b, n), s in zip(got, streams)],
        device="cpu")
    for g, s in zip(back, streams):
        np.testing.assert_array_equal(g.numpy(), s)


@pytest.mark.parametrize("batched", [True, False])
def test_compress_amr_batched_false_equals_the_reference(ref, batched):
    rds, ds, eb = _dataset(ref, shape=(16, 16, 16), densities=(0.4, 0.6),
                           seed=1)
    ebs = adaptive_eb.level_error_bounds(eb, ds.n_levels)
    want = ref.hybrid.compress_amr(rds, eb=ebs, batched=batched,
                                   lorenzo_engine="numpy")
    got = hybrid.compress_amr(ds, eb=ebs, batched=batched, device="cpu",
                              **REF_ENGINES)
    for g, w in zip(got.levels, want.levels):
        assert (g.strategy, g.total_bits, g.n_subblocks) == \
            (w.strategy, w.total_bits, w.n_subblocks)
        np.testing.assert_array_equal(g.recon.numpy(), w.recon)
        assert huffman.serialize_codebook(g.artifacts.codebook) == \
            ref.huffman.serialize_codebook(w.artifacts.codebook)
        assert [r.extras.get("branch") for r in g.artifacts.results] == \
            [r.extras.get("branch") for r in w.artifacts.results]


@pytest.mark.parametrize("metric", ["power_spectrum", "halo_finder",
                                    "generic", "other"])
def test_level_error_bounds_equal_the_reference(ref, metric):
    for n in (1, 2, 4):
        assert adaptive_eb.level_error_bounds(
            1e-3, n, metric=metric, upsample_rate=8) == \
            ref.adaptive.level_error_bounds(1e-3, n, metric=metric,
                                            upsample_rate=8)
    assert adaptive_eb.PAPER_RATIOS == ref.adaptive.PAPER_RATIOS
    fine, coarse = adaptive_eb.level_error_bounds(1.0, 2, metric=metric)
    if metric in adaptive_eb.PAPER_RATIOS:
        assert fine / coarse == pytest.approx(adaptive_eb.PAPER_RATIOS[metric])


@pytest.mark.parametrize("engine", ["auto", "numpy", "batched", "pallas"])
def test_inline_writer_writes_the_reference_bytes(ref, data, tmp_path,
                                                  engine):
    """``TACZWriter(background=False, entropy_engine=...)`` encodes on the
    caller's thread and writes the reference's bytes, whatever the
    engine name."""
    a, b = str(tmp_path / "ref.tacz"), str(tmp_path / "port.tacz")
    with ref.io.TACZWriter(a, eb=data.eb, payload_codec="zlib",
                           background=False, lorenzo_engine="numpy",
                           entropy_engine="batched") as w:
        for lvl in data.rds.levels:
            w.add_level(lvl.data, lvl.mask, ratio=lvl.ratio)
    with tio.TACZWriter(b, eb=data.eb, payload_codec="zlib",
                        background=False, entropy_engine=engine,
                        device="cpu") as w:
        assert w._thread is None
        for lvl in data.ds.levels:
            w.add_level(lvl.data, lvl.mask, ratio=lvl.ratio)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    blob, entry = twriter.pack_level(data.res.levels[0],
                                     payload_codec="zlib",
                                     entropy_engine=engine)
    rblob, rentry = ref.writer.pack_level(data.rres.levels[0],
                                          payload_codec="zlib")
    assert blob == rblob


def test_close_without_publish_and_obs_summary(ref, data, tmp_path):
    """``close(publish=False)`` finishes the ``.tmp`` and leaves it
    there; ``obs_summary()`` has the reference's keys."""
    path = str(tmp_path / "x.tacz")
    w = tio.TACZWriter(path, background=False, device="cpu")
    w.add_compressed(data.res.levels[0])
    tmp = w.close(publish=False)
    assert tmp == path + ".tmp"
    assert os.listdir(tmp_path) == ["x.tacz.tmp"]
    with tio.TACZReader(tmp, device="cpu") as rd:
        assert rd.index_crc == w.index_crc
    summary = w.obs_summary()
    rw = ref.io.TACZWriter(str(tmp_path / "r.tacz"), background=False)
    rw.abort()
    assert set(summary) == set(rw.obs_summary())
    assert summary["levels"] == 1 and summary["bytes"] > 0
    assert summary["publish_seconds"] > 0.0


def test_dropped_inline_writer_is_reaped(tmp_path):
    """A ``background=False`` writer dropped without close() or abort()
    closes its file and removes the unpublished tmp."""
    import gc
    w = tio.TACZWriter(str(tmp_path / "d.tacz"), background=False,
                       device="cpu")
    assert os.path.exists(str(tmp_path / "d.tacz.tmp"))
    del w
    gc.collect()
    assert os.listdir(tmp_path) == []


def test_inline_writer_error_refuses_to_publish(tmp_path):
    w = tio.TACZWriter(str(tmp_path / "e.tacz"), eb=-1.0, background=False,
                       device="cpu")
    with pytest.raises(ValueError):
        w.add_level(np.ones((8, 8, 8), np.float32))
    with pytest.raises(ValueError):
        w.close()
    assert os.listdir(tmp_path) == []


def test_writer_metrics_record_each_stage(data, tmp_path):
    from repro_torch.obs import metrics as obsm
    before = {s: obsm.WRITER_LEVEL_SECONDS.labels(s).count
              for s in ("encode", "pack", "publish")}
    levels = obsm.WRITER_LEVELS.labels().value
    with tio.TACZWriter(str(tmp_path / "m.tacz"), eb=data.eb,
                        device="cpu") as w:
        w.add_level(data.ds.levels[0].data, data.ds.levels[0].mask)
    after = {s: obsm.WRITER_LEVEL_SECONDS.labels(s).count
             for s in ("encode", "pack", "publish")}
    assert after == {s: n + 1 for s, n in before.items()}
    assert obsm.WRITER_LEVELS.labels().value == levels + 1
    text = obsm.REGISTRY.render()
    for name in ("tacz_writer_level_seconds", "tacz_writer_bytes_total",
                 "tacz_writer_levels_total"):
        assert name in text


# ------------------------------- on the card ---------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return "cuda"


def _port_dataset():
    ds = amr.synthetic_amr((64, 64, 64), densities=[0.35, 0.65],
                           refine_block=4, seed=5)
    eb = 1e-3 * float(ds.levels[0].data.max() - ds.levels[0].data.min())
    return ds, eb


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["thread", "process"])
def test_card_writes_the_cpu_parts(tmp_path, mode):
    """Part workers on the card (threads on their own streams, or spawned
    processes) write the CPU port's bytes, for raw and compressed levels,
    and the card decodes them to the CPU decode; the kernels of the path
    launched, in this process for threads and in the workers' own counts
    for spawned processes.  The compressed levels are made and handed
    over under a stream other than the default one."""
    dev = _card()
    ds, eb = _port_dataset()
    out = {}
    for where in ("cpu", dev):
        path = str(tmp_path / f"raw-{where}.taczd")
        ops.reset_launches()
        with tpar.ParallelTACZWriter(path, parts=3, mode=mode, eb=eb,
                                     payload_codec="zlib",
                                     device=where) as w:
            for lvl in ds.levels:
                w.add_level(lvl.data, lvl.mask, ratio=lvl.ratio)
        out[where] = (path, dict(ops.launches), w.worker_launches)
    assert _files(out["cpu"][0]) == _files(out[dev][0])
    here, spawned = out[dev][1], out[dev][2]
    for k in ("lorenzo3d_codes_batched", "hist"):
        if mode == "thread":
            assert here[k] > 0 and not spawned, (here, spawned)
        else:
            assert here[k] == 0, here
            assert all(spawned[pi][k] > 0 for pi in range(3)), spawned
    with tio.open_snapshot(out["cpu"][0], device="cpu") as rc, \
            tio.open_snapshot(out[dev][0], device=dev) as rg:
        for li in range(rc.n_levels):
            got = rg.read_level(li)
            assert got.is_cuda
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          rc.read_level(li).numpy())
    a, b = str(tmp_path / "c-card.taczd"), str(tmp_path / "c-cpu.taczd")
    with torch.cuda.stream(torch.cuda.Stream()):
        res = hybrid.compress_amr(ds, eb=eb, device=dev)
        tio.write_multipart(a, res, parts=4, mode=mode, device=dev)
    tio.write_multipart(b, hybrid.compress_amr(ds, eb=eb, device="cpu"),
                        parts=4, device="cpu")
    assert _files(a) == _files(b)


@pytest.mark.cuda
def test_card_reads_the_golden_multipart():
    dev = _card()
    path = os.path.join(GOLD, "multipart.taczd")
    with np.load(os.path.join(GOLD, "expected.npz")) as z:
        expected = {k: z[k] for k in z.files}
    ops.reset_launches()
    with tpar.MultiPartReader(path, device=dev) as rd:
        for li in range(rd.n_levels):
            got = rd.read_level(li)
            assert got.is_cuda
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          expected[f"level{li}"])
        box = ((2, 13), (0, 16), (5, 9))
        with RegionServer(path, device=dev) as srv:
            for g, r in zip(srv.get_roi(box), rd.read_roi(box)):
                assert torch.equal(g.data, r.data)
    assert ops.launches["huffdec"] > 0
