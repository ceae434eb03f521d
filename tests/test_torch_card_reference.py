"""The port's output on the card held to the reference's, not only to
the kernels' plain versions.

A fault that a kernel and its plain version share on the card passes
the card's kernel tests; these tests compare what the card produces with
files the reference wrote:

* the golden fixtures (``tests/golden/{v1,v2_zlib,truncated_tacf}.tacz``)
  decode on the card to ``expected.npz`` bit for bit;
* one TAC GSP level (``tests/card_reference/``, written by the
  reference's host path from a numpy seed, 64³ values, ``lorenzo``)
  compresses on the card to the reference's bytes and decodes on the
  card to the reference's recon; kernels 5 and 6 take their
  ``tile = shape`` routes there;
* one TAC+ snapshot (the ``run1_z10`` structure at 128³, seed 10)
  compresses on the card to the reference's bytes and decodes on the
  card to the reference's recon (held by SHA-256 per level); kernels 1
  to 4 run there, kernel 1 on its plane walk;
* one variant set (the reference tuning tests' 32³ dataset, ``hi``:
  ``psnr>=70``, ``lo``: ``psnr>=50``) tuned on the card reaches the
  reference's bounds and bits (payloads priced without the zstd pass
  in both, so the bits do not follow ``zstandard``'s presence), decodes
  to the reference's recon, and
  restates its metrics exactly, twice in a row (``psnr``, ``psnr_u`` and
  ``max_abs_error`` equal to the reference's; ``ps_error`` within 1e-12,
  as ``torch.fft`` differs from pocketfft in the last bits).

The ``cuda`` tests import no JAX, so they run on the card's machine with
``pytest --noconftest -m cuda``.  The CPU tests regenerate the fixtures
with the reference (imported inside the test) and hold the port's CPU
path to them; they never decode the GSP payload with the plain decoder,
which walks it one symbol per step.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import io as tio
from repro_torch.convert import dataset_from_arrays
from repro_torch.core import amr, hybrid
from repro_torch.io import variants as vrt
from repro_torch.kernels import ops
from repro_torch.tuning import measure_metrics, write_variant_set

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "golden")
_spec = importlib.util.spec_from_file_location(
    "make_card_reference",
    os.path.join(HERE, "card_reference", "make_card_reference.py"))
fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture)

GOLDEN = ["v1", "v2_zlib", "truncated_tacf"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return "cuda"


def _bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _recon() -> np.ndarray:
    with np.load(fixture.RECON) as z:
        return z["recon"]


def _port_write(path: str, device: str) -> None:
    data, mask, eb = fixture.level()
    with tio.TACZWriter(path, eb=eb, device=device, **fixture.WRITER) as w:
        w.add_level(data, mask, ratio=1)


def _port_compress(device: str):
    data, mask, eb = fixture.level()
    ds = dataset_from_arrays([(data, mask, 1)])
    res = hybrid.compress_amr(ds, eb=eb, device=device, **fixture.COMPRESS)
    lr, = res.levels
    assert lr.strategy == "gsp"
    return lr


def test_card_reference_fixture_regenerates(tmp_path):
    path = str(tmp_path / "ref.tacz")
    recon = fixture.write_reference(path)
    assert _bytes(path) == _bytes(fixture.CONTAINER)
    np.testing.assert_array_equal(recon, _recon())
    assert recon.shape == fixture.SHAPE and recon.dtype == np.float32


def test_port_writes_card_reference_bytes_on_cpu(tmp_path):
    path = str(tmp_path / "port.tacz")
    _port_write(path, "cpu")
    assert _bytes(path) == _bytes(fixture.CONTAINER)
    np.testing.assert_array_equal(_port_compress("cpu").recon.numpy(),
                                  _recon())


def _tacplus_digests() -> list[str]:
    with open(fixture.TACPLUS_RECON) as f:
        return json.load(f)["levels"]


def _tacplus_write(path: str, device: str) -> list[str]:
    """The port's TAC+ snapshot on ``device`` written to ``path``;
    returns the digests of its compress-time recon."""
    ds = amr.synthetic_amr(**fixture.TACPLUS)
    res = hybrid.compress_amr(ds, eb=fixture.finest_eb(ds), device=device)
    tio.write(path, res, payload_codec="none", device=device)
    return [fixture.digest(lr.recon.cpu().numpy()) for lr in res.levels]


def test_tacplus_fixture_regenerates(tmp_path):
    path = str(tmp_path / "ref.tacz")
    assert fixture.write_tacplus_reference(path) == _tacplus_digests()
    assert _bytes(path) == _bytes(fixture.TACPLUS_CONTAINER)


def test_port_writes_tacplus_bytes_on_cpu(tmp_path):
    path = str(tmp_path / "port.tacz")
    assert _tacplus_write(path, "cpu") == _tacplus_digests()
    assert _bytes(path) == _bytes(fixture.TACPLUS_CONTAINER)


@pytest.mark.cuda
def test_tacplus_snapshot_compresses_to_reference_bytes_on_card(tmp_path):
    dev = _card()
    ops.reset_launches()
    path = str(tmp_path / "card.tacz")
    assert _tacplus_write(path, dev) == _tacplus_digests()
    for name in ("lorenzo3d_codes_batched", "lorenzo3d_recon_batched",
                 "hist"):
        assert ops.launches[name] > 0, name
    assert _bytes(path) == _bytes(fixture.TACPLUS_CONTAINER)


@pytest.mark.cuda
def test_tacplus_snapshot_decodes_to_reference_recon_on_card():
    dev = _card()
    ops.reset_launches()
    got = tio.read(fixture.TACPLUS_CONTAINER, device=dev)
    assert ops.launches["huffdec"] > 0
    assert ops.launches["lorenzo3d_recon_batched"] > 0
    assert [fixture.digest(g.cpu().numpy()) for g in got] == \
        _tacplus_digests()


@pytest.fixture(scope="module")
def expected():
    with np.load(os.path.join(GOLD, "expected.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.cuda
@pytest.mark.parametrize("name", GOLDEN)
def test_golden_fixtures_decode_on_card(expected, name):
    dev = _card()
    with tio.TACZReader(os.path.join(GOLD, f"{name}.tacz"),
                        device=dev) as rd:
        assert rd.verify()
        for li in range(rd.n_levels):
            got = rd.read_level(li)
            assert got.device.type == "cuda" and got.dtype == torch.float32
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          expected[f"level{li}"])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_gsp_level_compresses_to_reference_bytes_on_card(tmp_path):
    dev = _card()
    assert ops.codes3d_route(fixture.SHAPE, fixture.SHAPE) == "walk"
    ops.reset_launches()
    path = str(tmp_path / "card.tacz")
    _port_write(path, dev)
    assert ops.launches["lorenzo3d_codes"] > 0
    assert _bytes(path) == _bytes(fixture.CONTAINER)
    lr = _port_compress(dev)
    np.testing.assert_array_equal(lr.recon.cpu().numpy(), _recon())


@pytest.mark.cuda
def test_gsp_level_decodes_to_reference_recon_on_card():
    dev = _card()
    assert ops.recon3d_route(fixture.SHAPE, fixture.SHAPE) == "planes"
    ops.reset_launches()
    got, = tio.read(fixture.CONTAINER, device=dev)
    assert ops.launches["lorenzo3d_recon"] > 0
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), _recon())
    roi, = tio.read_roi(fixture.CONTAINER, ((5, 40), (0, 64), (17, 18)),
                        device=dev)
    np.testing.assert_array_equal(roi.data.cpu().numpy(),
                                  _recon()[5:40, 0:64, 17:18])


# ------------------------------ tuned variant set ---------------------------


def _tuned() -> dict:
    with open(fixture.TUNED_JSON) as f:
        return json.load(f)


def _port_tune(set_dir: str, device: str) -> dict:
    """The port's variant set of the fixture's dataset and targets on
    ``device``; returns its summary, the levels decoded on ``device``."""
    ds = amr.synthetic_amr(**fixture.TUNED_DATASET)
    with fixture.huffman_pricing("repro_torch"):
        write_variant_set(set_dir, ds, fixture.TUNED_TARGETS,
                          default=fixture.TUNED_DEFAULT,
                          payload_codec="none", device=device)
    return fixture.tuned_summary(set_dir, lambda p: [
        r.cpu().numpy() for r in tio.read(p, device=device)])


def _tuned_match(got: dict, want: dict) -> None:
    assert got["default"] == want["default"]
    assert list(got["variants"]) == list(want["variants"])
    for name, w in want["variants"].items():
        g = got["variants"][name]
        assert (g["ebs"], g["bits"], g["levels"]) == \
            (w["ebs"], w["bits"], w["levels"]), name
        for k in ("psnr", "psnr_u", "max_abs_error"):
            assert g["metrics"][k] == w["metrics"][k], (name, k)
        assert abs(g["metrics"]["ps_error"] - w["metrics"]["ps_error"]) \
            <= 1e-12


def test_tuned_fixture_regenerates(tmp_path):
    set_dir = str(tmp_path / "ref.taczv")
    assert fixture.write_tuned_reference(set_dir) == _tuned()
    for name in sorted(os.listdir(fixture.TUNED_SET)):
        assert _bytes(os.path.join(set_dir, name)) == \
            _bytes(os.path.join(fixture.TUNED_SET, name)), name


def test_port_tunes_to_tuned_fixture_on_cpu(tmp_path):
    _tuned_match(_port_tune(str(tmp_path / "port.taczv"), "cpu"), _tuned())


@pytest.mark.cuda
def test_tuned_set_on_card(tmp_path):
    dev = _card()
    ops.reset_launches()
    set_dir = str(tmp_path / "card.taczv")
    got = _port_tune(set_dir, dev)
    for name in ("lorenzo3d_codes_batched", "hist", "huffdec",
                 "lorenzo3d_recon_batched"):
        assert ops.launches[name] > 0, name
    _tuned_match(got, _tuned())
    # the catalog's metrics, restated from each decoded variant on the
    # card, exactly and twice in a row
    ds = amr.synthetic_amr(**fixture.TUNED_DATASET)
    for entry in vrt.load_catalog(set_dir)["variants"]:
        levels = tio.read(os.path.join(set_dir, entry["file"]), device=dev)
        res = hybrid.AMRCompressionResult(levels=[
            hybrid.LevelResult(strategy="", algorithm="", she=True,
                               payload_bits=0, codebook_bits=0, meta_bits=0,
                               recon=r, n_values=0, density=0.0, eb=0.0)
            for r in levels], method="decoded")
        first = measure_metrics(ds, res)
        assert first == measure_metrics(ds, res) == entry["metrics"]
