"""TACZ containers of the TAC path (gsp, nast and global levels) between
the port and the reference, on the CPU.

The port's files must equal ``repro.io.write``'s byte for byte, from the
port's own compression and from the reference's compressed state; each
package must read the other's files bit for bit (full levels, ROI crops,
level boxes, raw codes); and single-tensor blobs (``STRATEGY_GLOBAL``
levels) must equal ``repro.io.tensor``'s.
"""
import numpy as np
import pytest
import torch

from repro import io as rio
from repro.core import amr as ramr
from repro.core import hybrid as rhybrid
from repro.io import tensor as rtensor
from repro_torch import io as tio
from repro_torch.convert import dataset_from_arrays, result_from_reference
from repro_torch.core import hybrid

BOX = ((3, 13), (5, 16), (0, 9))
CONTAINERS = [("lorenzo", False, "gsp"), ("lor_reg", False, "gsp"),
              ("interp", False, "gsp"), ("lor_reg", True, "nast")]


@pytest.fixture(scope="module")
def data():
    rds = ramr.synthetic_amr((16, 16, 16), densities=[0.3, 0.7],
                             refine_block=4, seed=6)
    eb = 1e-3 * float(rds.levels[0].data.max() - rds.levels[0].data.min())
    ds = dataset_from_arrays([(l.data, l.mask, l.ratio) for l in rds.levels])
    return rds, ds, eb


@pytest.fixture(scope="module", params=CONTAINERS,
                ids=["-".join(map(str, c)) for c in CONTAINERS])
def files(request, data, tmp_path_factory):
    rds, ds, eb = data
    algorithm, she, strategy = request.param
    kw = dict(algorithm=algorithm, she=she, strategy=strategy)
    tmp = tmp_path_factory.mktemp("tac")
    rres = rhybrid.compress_amr(rds, eb=eb, **kw)
    pres = hybrid.compress_amr(ds, eb=eb, device="cpu", **kw)
    paths = {k: str(tmp / f"{k}.tacz") for k in ("ref", "port", "conv",
                                                 "stream", "ref_stream")}
    rio.write(paths["ref"], rres)
    tio.write(paths["port"], pres, device="cpu")
    tio.write(paths["conv"], result_from_reference(rres, device="cpu"),
              device="cpu")
    tio.write(paths["stream"], ds, eb=eb, device="cpu", **kw)
    rio.write(paths["ref_stream"], rds, eb=eb, **kw)
    return rres, pres, paths


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_port_file_bytes_equal_reference(files):
    _, _, p = files
    ref = _bytes(p["ref"])
    assert _bytes(p["port"]) == ref
    assert _bytes(p["conv"]) == ref
    assert _bytes(p["stream"]) == _bytes(p["ref_stream"]) == ref


def test_each_package_reads_the_other(files):
    rres, pres, p = files
    for got, lr in zip(rio.read(p["port"]), pres.levels):
        np.testing.assert_array_equal(got, lr.recon.numpy())
    with tio.TACZReader(p["ref"], device="cpu") as rd:
        assert rd.verify()
        for got, lr in zip(rd.read(), rres.levels):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), lr.recon)


def test_roi_and_level_box(files):
    _, _, p = files
    for want, got in zip(rio.read_roi(p["port"], BOX),
                         tio.read_roi(p["ref"], BOX, device="cpu")):
        assert (got.level, got.ratio, got.box) == \
            (want.level, want.ratio, want.box)
        np.testing.assert_array_equal(got.data.numpy(), want.data)
    with tio.TACZReader(p["ref"], device="cpu") as rd, \
            rio.TACZReader(p["ref"]) as rr:
        lbox = ((2, 11), (-4, 7), (5, 40))
        np.testing.assert_array_equal(rd.read_level_box(1, lbox).numpy(),
                                      rr.read_level_box(1, lbox))
        for li in range(rd.n_levels):
            assert rd.subblock_shape(li, 0) == rr.subblock_shape(li, 0)
            (pc, pb), = rd.decode_subblocks(li, [0])
            (rc, rb), = rr.decode_subblocks(li, [0])
            np.testing.assert_array_equal(pc.numpy(), rc)
            assert (pb is None) == (rb is None)
            if pb is not None:
                np.testing.assert_array_equal(pb.numpy(), rb)


def test_merged_levels_are_not_writable(data, tmp_path):
    _, ds, eb = data
    res = hybrid.compress_amr(ds, eb=eb, she=False, strategy="opst",
                              device="cpu")
    with pytest.raises(ValueError, match="merged-4D"):
        tio.write(str(tmp_path / "m.tacz"), res, device="cpu")


@pytest.mark.parametrize("shape,scale", [((300,), 1.0), ((7, 9), 50.0),
                                         ((6, 5, 7), 1.0), ((6, 5, 7), 1e4),
                                         ((3, 4, 5, 2), 3.0)])
def test_tensor_blob_matches_reference(shape, scale):
    a = np.random.default_rng(len(shape)).normal(0, scale, shape) \
        .astype(np.float32)
    eb = 1e-3
    blob = tio.encode_tensor(a, eb, device="cpu")
    assert blob == rtensor.encode_tensor(a, eb)
    got = tio.decode_tensor(blob, device="cpu")
    np.testing.assert_array_equal(got.numpy(), rtensor.decode_tensor(blob))
    assert float(np.abs(got.numpy() - a).max()) <= \
        eb + 2.0 ** -22 * float(np.abs(a).max())


def test_tensor_blob_other_dtypes_and_errors():
    a = np.random.default_rng(1).normal(0, 9, (4, 5, 6))
    assert tio.encode_tensor(a, 1e-2, device="cpu") == \
        rtensor.encode_tensor(a, 1e-2)
    ints = np.arange(60, dtype=np.int32).reshape(3, 4, 5)
    assert tio.encode_tensor(ints, 0.5, device="cpu") == \
        rtensor.encode_tensor(ints, 0.5)
    with pytest.raises(ValueError):
        tio.encode_tensor(np.float32(1.0), 1e-3, device="cpu")
    with pytest.raises(ValueError):
        tio.encode_tensor(np.zeros(4, np.float32), 0.0, device="cpu")
