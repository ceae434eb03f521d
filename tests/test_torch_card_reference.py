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
  as ``torch.fft`` differs from pocketfft in the last bits);
* the mixture-of-experts case (``moe.npz``): ``moe_apply`` and the
  granite-moe smoke model's train logits on a numpy-seeded parameter
  tree, on the card, within the CPU tests' tolerances of the
  reference's outputs (float32: outputs 1e-5, logits 1e-4, ``aux``
  1e-6; bf16: 1e-2, relative);
* the recurrent case (``recurrent.npz``): ``rwkv6_apply`` and
  ``mamba2_apply`` in train, prefill and decode, and the rwkv6-7b and
  zamba2-2.7b smoke models' train logits and a prefill plus one decode
  step (zamba2 cut to its first group), on numpy-seeded trees whose
  recurrence leaves are non-zero, on the card within the CPU tests'
  tolerances (``make_card_reference.TOL``: blocks float32 1e-5, bf16
  1e-2; models float32 1e-4, bf16 1e-2);
* the embedding-input case (``frontends.npz``): musicgen-medium's and
  internvl2-76b's smoke models fed by seeded frontend embeddings, train
  logits, a prefill and one decode step, in float32 and bf16, within the
  CPU tests' tolerances (``TOL``/``ARCH_TOL``: ``"logits"``,
  ``"steps"``);
* the train case (``train.npz``): musicgen-medium's float32 smoke model,
  its loss and gradients (``TOL["loss"]``, ``TOL["grads"]``), the loss
  and gradient norm with two microbatches, one AdamW and one Adafactor
  step from seeded gradients (each value within ``TOL["update"]`` of its
  leaf's largest update plus one ulp), and a two-replica gradient
  exchange on kernels 7 and 8 at group 256, bit for bit (its digests).

The ``cuda`` tests import no JAX, so they run on the card's machine with
``pytest --noconftest -m cuda``.  The CPU tests regenerate the fixtures
with the reference (imported inside the test) and hold the port's CPU
path to them; they never decode the GSP payload with the plain decoder,
which walks it one symbol per step.
"""
import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch import io as tio
from repro_torch.configs import RunConfig, smoke_config
from repro_torch.convert import dataset_from_arrays, params_from_reference
from repro_torch.core import amr, hybrid
from repro_torch.io import variants as vrt
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlay
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.optim import adafactor as tada
from repro_torch.optim import adamw as tadam
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim.adamw import global_norm
from repro_torch.serving import make_prefill_step, make_serve_step
from repro_torch.serving.engine import grow_cache
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


# ------------------------------ mixture of experts --------------------------

#: relative tolerances of the CPU tests (tests/test_torch_moe.py,
#: tests/test_torch_lm_serving.py)
MOE_TOL = {"float32": {"out": 1e-5, "logits": 1e-4},
           "bfloat16": {"out": 1e-2, "logits": 1e-2}}


def _moe_fixture() -> dict:
    with np.load(fixture.MOE_FIXTURE) as z:
        return {k: z[k] for k in z.files}


def _rel(want: np.ndarray, got: np.ndarray) -> float:
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-9))


def _port_moe(dtype: str, device: str) -> dict:
    """The port's outputs of the MoE case on ``device``, as float32 numpy
    arrays under the fixture's keys."""
    cfg = replace(smoke_config(fixture.MOE_ARCH), dtype=dtype)
    x, tokens = fixture.moe_inputs(cfg)
    specs = tmoe.moe_specs(cfg)
    tree = fixture.seeded_tree(fixture.spec_leaves(specs), fixture.MOE_SEED)
    params = {k: torch.from_numpy(v).to(device=device,
                                        dtype=specs[k].torch_dtype)
              for k, v in tree.items()}
    dt = params["w_up"].dtype
    out, aux = tmoe.moe_apply(params, torch.from_numpy(x).to(device, dt),
                              cfg, group_size=fixture.MOE_GROUP)
    tree = fixture.seeded_tree(
        fixture.spec_leaves(tmodel.model_specs(cfg)), fixture.MOE_SEED)
    logits, maux = tmodel.forward(
        params_from_reference(tree, cfg, device=device), cfg,
        tokens=torch.from_numpy(tokens).to(device), mode="train")
    f32 = lambda t: t.float().cpu().numpy()
    return {f"moe_apply/{dtype}/out": f32(out),
            f"moe_apply/{dtype}/aux": f32(aux),
            f"model/{dtype}/logits": f32(logits),
            f"model/{dtype}/moe_aux": f32(maux["moe_aux"])}


def _moe_match(got: dict, want: dict, dtype: str) -> None:
    tol = MOE_TOL[dtype]
    for key, kind in (("moe_apply", "out"), ("model", "logits")):
        w, g = want[f"{key}/{dtype}/{kind}"], got[f"{key}/{dtype}/{kind}"]
        assert g.shape == w.shape and np.isfinite(g).all()
        assert _rel(w, g) <= tol[kind], (key, _rel(w, g))
    for key in ("moe_apply/{}/aux", "model/{}/moe_aux"):
        w, g = (float(d[key.format(dtype)]) for d in (want, got))
        limit = 1e-6 if dtype == "float32" else tol["out"] * w
        assert abs(g - w) <= limit, (key, g, w)


def test_moe_fixture_regenerates(tmp_path):
    """The reference writes the stored outputs again (in a child process,
    so that its XLA flags take effect): float32 within 1e-6 and bf16
    within 1e-2, relative, since another CPU may sum in another order."""
    path = str(tmp_path / "moe.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(os.path.join(HERE, "..", "src"))]
        + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "card_reference",
                                      "make_card_reference.py"),
         "--moe", path], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = _moe_fixture()
    with np.load(path) as z:
        assert sorted(z.files) == sorted(want)
        for k in z.files:
            limit = 1e-6 if "float32" in k else 1e-2
            assert _rel(want[k], z[k]) <= limit, k


@pytest.mark.parametrize("dtype", fixture.MOE_DTYPES)
def test_port_matches_moe_fixture_on_cpu(dtype):
    _moe_match(_port_moe(dtype, "cpu"), _moe_fixture(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", fixture.MOE_DTYPES)
def test_moe_on_card_matches_reference(dtype):
    dev = _card()
    torch.set_float32_matmul_precision("highest")
    _moe_match(_port_moe(dtype, dev), _moe_fixture(), dtype)


# ------------------------------ recurrent state -----------------------------

def _recurrent_fixture() -> dict:
    with np.load(fixture.RECURRENT_FIXTURE) as z:
        return {k: z[k] for k in z.files}


def _port_recurrent(arch: str, dtype: str, device: str) -> dict:
    """The port's outputs of the recurrent case for ``arch`` on
    ``device``, as float32 numpy arrays under the fixture's keys."""
    cfg = replace(smoke_config(arch), dtype=dtype)
    block = fixture.recurrent_block(cfg)
    x, state, tokens = fixture.recurrent_inputs(cfg)
    apply, specs = ((trwkv.rwkv6_apply, trwkv.rwkv6_specs(cfg))
                    if block == "rwkv" else
                    (tssm.mamba2_apply, tssm.mamba2_specs(cfg)))
    tree = fixture.recurrent_tree(fixture.spec_leaves(specs),
                                  fixture.RECURRENT_SEED)
    params = {k: torch.from_numpy(v).to(device=device,
                                        dtype=specs[k].torch_dtype)
              for k, v in tree.items()}
    st = {k: torch.from_numpy(v).to(
        device=device, dtype=torch.bfloat16 if k == "conv" else torch.float32)
        for k, v in state.items()}
    xt = torch.from_numpy(x).to(device, tlay.DTYPES[dtype])
    keep = fixture.RECURRENT_KEEP
    f32 = lambda t: t.float().cpu().numpy()
    out = {}
    tag = f"{block}/{dtype}"
    y, _ = apply(params, xt, cfg, mode="train", chunk=fixture.RECURRENT_CHUNK)
    out[f"{tag}/train"] = f32(y[:, -keep:])
    y, _ = apply(params, xt, cfg, mode="prefill", state=st,
                 chunk=fixture.RECURRENT_CHUNK)
    out[f"{tag}/prefill"] = f32(y[:, -keep:])
    y, _ = apply(params, xt[:, :1], cfg, mode="decode", state=st)
    out[f"{tag}/decode"] = f32(y)
    cfg = fixture.recurrent_model_cfg(cfg)
    tree = fixture.recurrent_tree(
        fixture.spec_leaves(tmodel.model_specs(cfg)), fixture.RECURRENT_SEED)
    params = params_from_reference(tree, cfg, device=device)
    tk = torch.from_numpy(tokens).to(device)
    tag = f"model/{arch}/{dtype}"
    logits, _ = tmodel.forward(params, cfg, tokens=tk, mode="train")
    out[f"{tag}/train"] = f32(logits[:, -keep // 2:])
    run = RunConfig(kv_quant=False)
    lg, state1 = make_prefill_step(cfg, run)(params, {"tokens": tk[:, :-1]})
    out[f"{tag}/prefill"] = f32(lg)
    lg, _ = make_serve_step(cfg, run)(
        params, grow_cache(state1, 1, cfg), {"tokens": tk[:, -1:]},
        tokens.shape[1] - 1)
    out[f"{tag}/decode"] = f32(lg)
    return out


def _recurrent_match(got: dict, want: dict, dtype: str) -> None:
    """Blocks at ``TOL["block"]``, the (cut) smoke models at
    ``TOL["logits"]``."""
    for key, g in got.items():
        w = want[key]
        assert g.shape == w.shape and np.isfinite(g).all(), key
        kind = "logits" if key.startswith("model/") else "block"
        assert _rel(w, g) <= fixture.tol(kind, dtype), (key, _rel(w, g))


def test_recurrent_fixture_regenerates(tmp_path):
    """The reference writes the stored outputs again (in a child process,
    so that its XLA flags take effect): float32 within 1e-6 and bf16
    within 1e-2, relative; zamba2's float32 decode step within the port's
    own bar against this fixture."""
    path = str(tmp_path / "recurrent.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(os.path.join(HERE, "..", "src"))]
        + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "card_reference",
                                      "make_card_reference.py"),
         "--recurrent", path], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = _recurrent_fixture()
    with np.load(path) as z:
        assert sorted(z.files) == sorted(want)
        for k in z.files:
            limit = 1e-6 if "float32" in k else 1e-2
            if k == "model/zamba2_2_7b/float32/decode":
                # reads the bf16 KV cache of the shared attention, whose
                # roundings follow the XLA build: the port's own bar
                # (:func:`_recurrent_match`)
                limit = fixture.tol("logits", "float32")
            assert _rel(want[k], z[k]) <= limit, k


@pytest.mark.parametrize("dtype", fixture.RECURRENT_DTYPES)
@pytest.mark.parametrize("arch", fixture.RECURRENT_ARCHS)
def test_port_matches_recurrent_fixture_on_cpu(arch, dtype):
    _recurrent_match(_port_recurrent(arch, dtype, "cpu"),
                     _recurrent_fixture(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", fixture.RECURRENT_DTYPES)
@pytest.mark.parametrize("arch", fixture.RECURRENT_ARCHS)
def test_recurrent_on_card_matches_reference(arch, dtype):
    dev = _card()
    torch.set_float32_matmul_precision("highest")
    _recurrent_match(_port_recurrent(arch, dtype, dev),
                     _recurrent_fixture(), dtype)


# ------------------------------------------------- embedding-input decoders

def _load(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _regenerate(flag: str, path: str) -> dict:
    """The reference's outputs of one case, written again by
    ``make_card_reference.py`` in a child process (so that its XLA flags
    take effect)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(os.path.join(HERE, "..", "src"))]
        + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "card_reference",
                                      "make_card_reference.py"),
         flag, path], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return _load(path)


def _port_frontends(arch: str, dtype: str, device: str) -> dict:
    """The port's outputs of the embedding-input case for ``arch`` on
    ``device``, as float32 numpy arrays under the fixture's keys."""
    cfg = replace(smoke_config(arch), dtype=dtype)
    tree = fixture.model_tree(tmodel.model_specs(cfg), cfg,
                              fixture.FRONTEND_SEED)
    params = params_from_reference(tree, cfg, device=device)
    emb = torch.from_numpy(fixture.frontend_inputs(cfg)).to(device)
    f32 = lambda t: t.float().cpu().numpy()
    tag = f"{arch}/{dtype}"
    out = {}
    logits, _ = tmodel.forward(params, cfg, embeds=emb, mode="train")
    out[f"{tag}/train"] = f32(logits)
    run = RunConfig(kv_quant=False)
    lg, state = make_prefill_step(cfg, run)(params, {"embeds": emb[:, :-1]})
    out[f"{tag}/prefill"] = f32(lg)
    lg, _ = make_serve_step(cfg, run)(
        params, grow_cache(state, 1, cfg), {"embeds": emb[:, -1:]},
        emb.shape[1] - 1)
    out[f"{tag}/decode"] = f32(lg)
    return out


def _frontends_match(got: dict, want: dict, arch: str, dtype: str) -> None:
    for key, g in got.items():
        w = want[key]
        assert g.shape == w.shape and np.isfinite(g).all(), key
        kind = "steps" if key.endswith("/decode") else "logits"
        assert _rel(w, g) <= fixture.tol(kind, dtype, arch), (key,
                                                              _rel(w, g))


def test_frontends_fixture_regenerates(tmp_path):
    """float32 within 1e-6 and bf16 within 1e-2, relative; each decode
    step within the port's own bar against this fixture
    (``tol("steps", dtype, arch)``, as :func:`_frontends_match` holds it):
    the float32 decode steps read the bf16 KV cache, where whether 1–3
    K/V values round up or down follows the XLA build (2.02e-5 read for
    ``internvl2_76b/float32/decode`` on one machine), and a fixture that
    moves by less than the port's bar changes no verdict on the port."""
    got = _regenerate("--frontends", str(tmp_path / "frontends.npz"))
    want = _load(fixture.FRONTEND_FIXTURE)
    assert sorted(got) == sorted(want)
    for k in got:
        arch, dtype, _ = k.split("/")
        limit = 1e-6 if dtype == "float32" else 1e-2
        if k.endswith("/decode"):
            limit = fixture.tol("steps", dtype, arch)
        assert _rel(want[k], got[k]) <= limit, k


@pytest.mark.parametrize("dtype", fixture.FRONTEND_DTYPES)
@pytest.mark.parametrize("arch", fixture.FRONTEND_ARCHS)
def test_port_matches_frontends_fixture_on_cpu(arch, dtype):
    _frontends_match(_port_frontends(arch, dtype, "cpu"),
                     _load(fixture.FRONTEND_FIXTURE), arch, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", fixture.FRONTEND_DTYPES)
@pytest.mark.parametrize("arch", fixture.FRONTEND_ARCHS)
def test_frontends_on_card_match_reference(arch, dtype):
    dev = _card()
    torch.set_float32_matmul_precision("highest")
    _frontends_match(_port_frontends(arch, dtype, dev),
                     _load(fixture.FRONTEND_FIXTURE), arch, dtype)


# ------------------------------------------------- the train step

def _nested(flat_tree: dict, device: str) -> dict:
    return fixture.nested({k: torch.from_numpy(np.asarray(v)).to(device)
                           for k, v in flat_tree.items()})


def _train_match(device: str) -> None:
    """The port's train case on ``device`` against ``train.npz``."""
    want = _load(fixture.TRAIN_FIXTURE)
    cfg = replace(smoke_config(fixture.TRAIN_ARCH), dtype="float32")
    specs = tmodel.model_specs(cfg)
    tree = fixture.model_tree(specs, cfg, fixture.TRAIN_SEED)
    params = params_from_reference(tree, cfg, device=device)
    batch = {k: torch.from_numpy(v).to(device).long() if v.dtype == np.int32
             else torch.from_numpy(v).to(device) for k, v in
             fixture.train_batch(cfg, fixture.TRAIN_BATCH,
                                 fixture.TRAIN_SEED + 1).items()}
    run = RunConfig(remat="layer")
    loss, _, grads = ttrain.value_and_grad(params, batch, cfg, run)
    f32 = lambda t: t.float().cpu().numpy()
    assert _rel(want["loss"], f32(loss)) <= fixture.tol("loss", "float32")
    for path, g in fixture.flat(grads).items():
        assert _rel(want[f"grads/{path}"], f32(g)) <= fixture.tol(
            "grads", "float32"), path
    # each optimizer's step from the seeded gradients the reference took
    g2, e2 = fixture.exchange_inputs(fixture.spec_leaves(specs),
                                     fixture.TRAIN_PODS,
                                     fixture.TRAIN_SEED + 2)
    step_grads = _nested({k: v[0] for k, v in g2.items()}, device)
    for name, opt, init, update in (
            ("adamw", tadam.AdamWConfig(**fixture.TRAIN_ADAMW),
             tadam.adamw_init, tadam.adamw_update),
            ("adafactor", tada.AdafactorConfig(**fixture.TRAIN_ADAFACTOR),
             tada.adafactor_init, tada.adafactor_update)):
        new, _, stats = update(params, step_grads, init(params, opt), opt)
        assert float(stats["lr"]) == float(want[f"{name}/lr"])
        assert abs(float(stats["grad_norm"]) - float(want[f"{name}/grad_norm"])
                   ) <= 1e-6 * float(want[f"{name}/grad_norm"])
        for path, p in fixture.flat(new).items():
            w, o, g = (want[f"{name}/params/{path}"],
                       fixture.flat(tree)[path], f32(p))
            limit = (fixture.TOL["update"]["float32"] * np.abs(w - o).max()
                     + np.spacing(np.abs(w)))
            assert (np.abs(g - w) <= limit).all(), (name, path)
    loss2, _, grads2 = ttrain._microbatched_grads(
        params, batch, cfg, replace(run, microbatches=2))
    assert _rel(want["mb2/loss"], f32(loss2)) <= fixture.tol("loss",
                                                            "float32")
    assert _rel(want["mb2/grad_norm"], f32(global_norm(grads2))) <= 1e-6
    # the exchange, exact: kernel 7 once and kernel 8 once a leaf
    ops.reset_launches()
    mean, new_e = tgc.compress_pod_reduce(
        _nested(g2, device), _nested(e2, device), n_pods=fixture.TRAIN_PODS)
    launches = dict(ops.launches)
    n_leaves = len(g2) if device != "cpu" else 0
    assert (launches["group_quant"], launches["group_dequant"]) == (
        n_leaves, n_leaves)
    for path in g2:
        m = fixture.flat(mean)[path].cpu().numpy()
        assert fixture.digest(m[0]) == str(want[f"exchange/mean/{path}"])
        assert np.array_equal(m[0], m[1])
        assert fixture.digest(fixture.flat(new_e)[path].cpu().numpy()) == str(
            want[f"exchange/ef/{path}"]), path


def test_train_fixture_regenerates(tmp_path):
    """Every array within 1e-6, relative to its largest magnitude; the
    exchange's digests equal."""
    got = _regenerate("--train", str(tmp_path / "train.npz"))
    want = _load(fixture.TRAIN_FIXTURE)
    assert sorted(got) == sorted(want)
    for k in got:
        if k.startswith("exchange/"):
            assert str(got[k]) == str(want[k]), k
        else:
            assert _rel(want[k], got[k]) <= 1e-6, k


def test_port_matches_train_fixture_on_cpu():
    _train_match("cpu")


@pytest.mark.cuda
def test_train_on_card_matches_reference():
    dev = _card()
    torch.set_float32_matmul_precision("highest")
    _train_match(dev)
