"""The port's whole slice against the reference, on the CPU.

compress → write → read → read_roi in ``repro_torch`` (``device="cpu"``,
so every kernel runs its plain version) is held against the JAX
package's numpy path on the same seeded datasets: the same strategy,
sub-blocks, codebook, branches and recon per level; byte-identical files
from the same compressed state; each package reads the other's files bit
for bit; and the frozen golden fixtures decode to ``expected.npz``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import io as rio
from repro.core import amr as ramr
from repro.core import huffman as rhuffman
from repro.core import hybrid as rhybrid
from repro.io import frontier as rfrt
from repro_torch import io as tio
from repro_torch.convert import dataset_from_arrays, result_from_reference
from repro_torch.core import gsp, huffman, hybrid, she
from repro_torch.io import frontier as tfrt

GOLD = os.path.join(os.path.dirname(__file__), "golden")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
BOX = ((3, 29), (10, 40), (0, 17))

DATASETS = {
    "synthetic32": lambda: ramr.synthetic_amr((32, 32, 32), seed=3),
    "run1_z10": lambda: ramr.load_preset("run1_z10"),
    "three_levels": lambda: ramr.synthetic_amr(
        (32, 32, 32), densities=[0.1, 0.3, 0.6], seed=5),
}


@pytest.fixture(scope="module", params=sorted(DATASETS))
def case(request):
    rds = DATASETS[request.param]()
    eb = 1e-3 * float(rds.levels[0].data.max() - rds.levels[0].data.min())
    ds = dataset_from_arrays([(l.data, l.mask, l.ratio) for l in rds.levels])
    return rds, ds, eb, rhybrid.compress_amr(rds, eb=eb), \
        hybrid.compress_amr(ds, eb=eb, device="cpu")


def test_compress_amr_matches_reference(case):
    _, _, _, rres, pres = case
    assert pres.method == rres.method
    assert pres.total_bits == rres.total_bits
    for rl, pl in zip(rres.levels, pres.levels):
        assert (pl.strategy, pl.n_subblocks, pl.n_values, pl.payload_bits,
                pl.codebook_bits, pl.meta_bits) == \
            (rl.strategy, rl.n_subblocks, rl.n_values, rl.payload_bits,
             rl.codebook_bits, rl.meta_bits)
        ra, pa = rl.artifacts, pl.artifacts
        assert [(s.origin, s.bsize) for s in pa.subblocks] == \
            [(s.origin, s.bsize) for s in ra.subblocks]
        assert huffman.serialize_codebook(pa.codebook) == \
            rhuffman.serialize_codebook(ra.codebook)
        assert [r.extras["branch"] for r in pa.results] == \
            [r.extras["branch"] for r in ra.results]
        np.testing.assert_array_equal(pl.recon.numpy(), rl.recon)


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_writer_bytes_identical_from_reference_state(case, codec, tmp_path):
    _, _, _, rres, _ = case
    fr = rfrt.Frontier(metric="psnr", points=[rfrt.FrontierPoint(
        ebs=(1e-3, 2e-3), bits=rres.total_bits, metrics={"psnr": 70.0})])
    rio.write(str(tmp_path / "r.tacz"), rres, payload_codec=codec,
              frontier=fr)
    tfr = tfrt.Frontier.from_dict(fr.to_dict())
    tio.write(str(tmp_path / "p.tacz"), result_from_reference(
        rres, device="cpu"), payload_codec=codec, frontier=tfr, device="cpu")
    assert (tmp_path / "p.tacz").read_bytes() == \
        (tmp_path / "r.tacz").read_bytes()


def test_reference_reads_port_file(case, tmp_path):
    _, _, _, _, pres = case
    path = str(tmp_path / "port.tacz")
    tio.write(path, pres, device="cpu")
    for got, lr in zip(rio.read(path), pres.levels):
        np.testing.assert_array_equal(got, lr.recon.numpy())
    with tio.TACZReader(path, device="cpu") as rd:
        assert rd.verify()
        for got, lr in zip(rd.read(), pres.levels):
            assert torch.equal(got, lr.recon)
    for want, got in zip(rio.read_roi(path, BOX),
                         tio.read_roi(path, BOX, device="cpu")):
        assert got.box == want.box and got.level == want.level
        np.testing.assert_array_equal(got.data.numpy(), want.data)


def test_streamed_dataset_equals_one_shot(case, tmp_path):
    _, ds, eb, _, pres = case
    a, b = str(tmp_path / "a.tacz"), str(tmp_path / "b.tacz")
    tio.write(a, ds, eb=eb, device="cpu")
    tio.write(b, pres, device="cpu")
    assert open(a, "rb").read() == open(b, "rb").read()


def test_read_level_box_and_subblocks(case, tmp_path):
    _, _, _, _, pres = case
    path = str(tmp_path / "p.tacz")
    tio.write(path, pres, device="cpu")
    with tio.TACZReader(path, device="cpu") as rd, \
            rio.TACZReader(path) as rr:
        lbox = ((2, 11), (-4, 7), (5, 40))
        np.testing.assert_array_equal(rd.read_level_box(0, lbox).numpy(),
                                      rr.read_level_box(0, lbox))
        sbis = [0, len(rd.levels[0].subblocks) - 1, 0]
        for (pc, pb), (rc, rb) in zip(rd.decode_subblocks(0, sbis),
                                      rr.decode_subblocks(0, sbis)):
            np.testing.assert_array_equal(pc.numpy(), rc)
            assert (pb is None) == (rb is None)
            if pb is not None:
                np.testing.assert_array_equal(pb.numpy(), rb)


@pytest.fixture(scope="module")
def expected():
    with np.load(os.path.join(GOLD, "expected.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name,version", [("v1", 1), ("v2_zlib", 2),
                                          ("truncated_tacf", 2)])
def test_golden_fixtures_decode(expected, name, version):
    with tio.TACZReader(os.path.join(GOLD, f"{name}.tacz"),
                        device="cpu") as rd:
        assert rd.version == version
        for li in range(rd.n_levels):
            got = rd.read_level(li)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), expected[f"level{li}"])
        if name == "truncated_tacf":
            assert rd.frontier is None and rd.frontier_error
        elif name == "v2_zlib":
            assert rd.frontier_error is None
            assert rd.frontier.default_point.metrics["psnr"] == 72.0
        else:
            assert rd.frontier is None and rd.frontier_error is None


def test_unported_paths_raise():
    """The paths that raised before they were ported now run: a multi-part
    snapshot opens and decodes, the per-brick SHE route equals the
    batched one, and the per-block baseline prices one codebook a brick.
    What stays unported still raises."""
    expected = np.load(os.path.join(GOLD, "expected.npz"))
    with tio.open_snapshot(os.path.join(GOLD, "multipart.taczd"),
                           device="cpu") as rd:
        for li in range(rd.n_levels):
            np.testing.assert_array_equal(rd.read_level(li).numpy(),
                                          expected[f"level{li}"])
    rds = ramr.synthetic_amr((16, 16, 16), densities=[0.4, 0.6],
                             refine_block=4, seed=1)
    ds = dataset_from_arrays([(l.data, l.mask, l.ratio) for l in rds.levels])
    seq = hybrid.compress_amr(ds, eb=1e-3, device="cpu", batched=False)
    bat = hybrid.compress_amr(ds, eb=1e-3, device="cpu")
    for a, b in zip(seq.levels, bat.levels):
        assert a.total_bits == b.total_bits
        assert torch.equal(a.recon, b.recon)
    enc = she.she_encode([rds.levels[0].data[:8, :8, :8]], 1e-3,
                         shared=False, device="cpu")
    assert enc.codebook is None
    assert enc.codebook_bits == enc.results[0].codebook_bits > 0
    from repro_torch.configs import registry
    registry.get_config("rwkv6_7b")                  # ported since
    # the embedding-input archs load too, with no token table
    assert registry.get_config("internvl2_76b").input_mode == "embeddings"


def test_corrupt_payload_fails_crc(tmp_path):
    raw = bytearray(open(os.path.join(GOLD, "v2_zlib.tacz"), "rb").read())
    with tio.TACZReader(bytes(raw), device="cpu") as rd:
        off = rd.levels[0].subblocks[0].payload_off
    raw[off] ^= 0xFF
    with tio.TACZReader(bytes(raw), device="cpu") as rd:
        with pytest.raises(IOError, match="CRC mismatch"):
            rd.read_level(0)
        with pytest.raises(IOError):
            rd.verify()


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    ds = dataset_from_arrays([(np.zeros((8, 8, 8), np.float32),
                               np.ones((8, 8, 8), bool), 1)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hybrid.compress_amr(ds, eb=1e-3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.TACZReader(os.path.join(GOLD, "v1.tacz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hybrid.compress_amr(ds, eb=1e-3, she=False, algorithm="interp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gsp.gsp_pad(np.ones((8, 8, 8), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.encode_tensor(np.ones(4, np.float32), 1e-3)
    blob = tio.encode_tensor(np.ones(4, np.float32), 1e-3, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.decode_tensor(blob)


def test_import_hygiene():
    """The port imports neither jax nor any module of the reference."""
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "need = {'repro_torch.serving.sharded', 'repro_torch.serving.loadgen',\n"
        "        'repro_torch.obs.collect', 'repro_torch.obs.slo',\n"
        "        'repro_torch.models.moe', 'repro_torch.core.entropy',\n"
        "        'repro_torch.launch.train', 'repro_torch.optim.grad_compress'}\n"
        "assert need <= set(sys.modules), need - set(sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
