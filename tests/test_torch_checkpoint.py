"""The port's ``CheckpointManager`` against the reference's, on the CPU.

* Checkpoints cross between the packages: each restores the other's
  ``step_XXXXXXXX.{npz,json}``, and for the same tree the two write the
  same bytes — lossless, and lossy with the byte codec pinned to zlib in
  both (``HAVE_ZSTD`` patched off; ``"auto"`` would follow whether
  ``zstandard`` is installed) — with bf16 and float32 leaves, leaves of
  rank 3 (kernels 5/6 on the card) and 4 (kernels 1/2), and an Adafactor
  state.
* The lossy restore casts the float32 reconstruction to the entry's
  dtype; torch's bf16 cast rounds ties to even, as ``ml_dtypes`` does
  (pinned on reconstructions that lie exactly on bf16 ties).
* The snapshot is a copy: a non-blocking save followed by an in-place
  update restores the values before the update.
* ``keep`` deletes old steps; a pre-TACZ (legacy) lossy entry restores.
* Port twins of the reference's green ``test_framework.py`` tests
  ``test_checkpoint_lossy_mode_bounds_error`` and
  ``test_checkpoint_corruption_detected``.
* The card fixture (``tests/card_reference/checkpoint/``, written by the
  reference: :func:`make_card_reference.write_checkpoint_reference`)
  restores through the port to the reference's arrays (SHA-256 of their
  float32 values), on the CPU and, marked ``cuda``, on the card, and the
  port writes its files' bytes.

The reference is imported inside the CPU tests' bodies.
"""
import importlib.util
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.io import tensor as ttensor
from repro_torch.kernels import ops
from repro_torch.models import model as tmodel
from repro_torch.models.layers import init_from_specs
from repro_torch.optim import adafactor as tada

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "make_card_reference",
    os.path.join(HERE, "card_reference", "make_card_reference.py"))
fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture)

STEP = 7


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return "cuda"


def _bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _files(directory: str, step: int) -> dict:
    return {ext: _bytes(os.path.join(directory, f"step_{step:08d}.{ext}"))
            for ext in ("npz", "json")}


def _np(t) -> np.ndarray:
    """float32 numpy values of a tensor or a numpy/JAX array."""
    if isinstance(t, torch.Tensor):
        return t.float().cpu().numpy()
    return np.asarray(t).astype(np.float32)


def _torch(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _reference(a: np.ndarray, dtype: str) -> np.ndarray:
    """A float32 array in the reference's ``dtype`` (``ml_dtypes`` for
    bf16), as its host snapshot holds it."""
    import ml_dtypes

    return a.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)


@pytest.fixture
def pinned_zlib(monkeypatch):
    """Both packages' tensor codec on zlib."""
    from repro.io import tensor as rtensor

    monkeypatch.setattr(rtensor, "HAVE_ZSTD", False)
    monkeypatch.setattr(ttensor, "HAVE_ZSTD", False)


# ------------------------------------------------------ crossing packages

#: leaf → (shape, dtype): rank 3 and 4 float32 (kernels 5 and 1 when
#: lossy on the card), bf16 of rank 2 and 3, and leaves that stay
#: lossless (rank 1, 4096 values or fewer)
LEAVES = {"blocks/w3": ((3, 32, 48), "float32"),
          "blocks/w4": ((2, 3, 16, 48), "float32"),
          "blocks/b3": ((2, 40, 64), "bfloat16"),
          "embed": ((80, 64), "bfloat16"),
          "small": ((64, 64), "float32"),
          "norm": ((64,), "float32")}


def _mixed_params(seed: int = 0) -> dict:
    """``{"a/b": float32 array}`` of :data:`LEAVES`, smooth as trained
    weights are (:func:`make_card_reference.smooth_leaf`)."""
    rng = np.random.default_rng(seed)
    return {p: fixture.smooth_leaf(rng.standard_normal(s).astype(np.float32))
            for p, (s, _) in sorted(LEAVES.items())}


def _opt_state(package: str, params) -> dict:
    """A seeded Adafactor state of ``package``'s structure for its
    ``params``: :func:`make_card_reference.checkpoint_opt` of its leaf
    shapes."""
    if package == "port":
        init = tada.adafactor_init(params, tada.AdafactorConfig())
    else:
        from repro.optim import adafactor as rada
        init = rada.adafactor_init(params, rada.AdafactorConfig())
    shapes = {k: tuple(v.shape) for k, v in fixture.flat(init).items()}
    return fixture.checkpoint_opt(shapes)


def _port_tree(flat_np: dict) -> dict:
    return fixture.nested({p: _torch(a, getattr(torch, LEAVES[p][1]))
                           for p, a in flat_np.items()})


def _reference_tree(flat_np: dict) -> dict:
    return fixture.nested({p: _reference(a, LEAVES[p][1])
                           for p, a in flat_np.items()})


@pytest.mark.parametrize("eb_rel", [0.0, 1e-3], ids=["lossless", "lossy"])
def test_checkpoints_cross_packages_byte_equal(tmp_path, pinned_zlib, eb_rel):
    """Both packages save the same tree (params and an Adafactor state)
    to the same bytes; each restores the other's files to the same
    arrays as its own restore, lossless leaves bit for bit; lossy leaves
    within ``eb`` (+ float32 rounding) of their source, rank 3 and 4
    included."""
    from repro.checkpoint.manager import CheckpointManager as RManager

    flat_p = _mixed_params()
    t_params, r_params = _port_tree(flat_p), _reference_tree(flat_p)
    t_opt = fixture.nested({k: torch.from_numpy(np.asarray(v)) for k, v in
                            _opt_state("port", t_params).items()})
    r_opt_flat = _opt_state("reference", r_params)
    assert sorted(r_opt_flat) == sorted(fixture.flat(t_opt))
    r_opt = fixture.nested(r_opt_flat)
    tdir, rdir = str(tmp_path / "port"), str(tmp_path / "ref")
    CheckpointManager(tdir, lossy_eb_rel=eb_rel, device="cpu").save(
        STEP, t_params, t_opt, extra={"note": "x"}, blocking=True)
    RManager(rdir, lossy_eb_rel=eb_rel).save(
        STEP, r_params, r_opt, extra={"note": "x"}, blocking=True)
    assert _files(tdir, STEP) == _files(rdir, STEP)
    with open(os.path.join(tdir, f"step_{STEP:08d}.json")) as f:
        manifest = json.load(f)
    lossy = {manifest["entries"][k]["path"] for k in manifest["lossy"]}
    if eb_rel:
        assert lossy == {"params/blocks/w3", "params/blocks/w4",
                         "params/blocks/b3", "params/embed"}
    else:
        assert not lossy
    # each restores the other's files
    tp, to, ts = CheckpointManager(rdir, device="cpu").restore(STEP)
    rp, ro, rs = RManager(tdir).restore(STEP)
    assert ts == rs == STEP
    got = fixture.flat({"params": tp, "opt": to})
    want = fixture.flat({"params": rp, "opt": ro})
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        w = np.asarray(want[path])
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype), path
        assert tuple(t.shape) == w.shape, path
        np.testing.assert_array_equal(_np(t), _np(w))
        if path.startswith("opt/"):
            assert t.dtype == (torch.int32 if path == "opt/step"
                               else torch.float32)
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(r_opt_flat[path[4:]]))
            continue
        src = _np(t_params_flat := fixture.flat(t_params)[path[7:]])
        if path in lossy:
            eb = eb_rel * float(np.abs(src).max())
            ulp = 2.0 ** -9 if t_params_flat.dtype == torch.bfloat16 \
                else 2.0 ** -24
            assert np.abs(_np(t) - src).max() <= eb + ulp * np.abs(src).max()
        else:
            np.testing.assert_array_equal(_np(t), src)


def test_lossy_restore_rounds_bf16_ties_as_ml_dtypes(tmp_path, pinned_zlib):
    """A bf16 leaf with ``max |a| = 1`` at ``eb_rel = 3 · 2⁻¹⁰``: the
    reconstruction is ``3q · 2⁻⁹``, which for odd ``q`` in [0.5, 1) lies
    exactly halfway between two bf16 values.  The port's restore (torch's
    cast) equals the reference's (``ml_dtypes``) on every value, and the
    ties went to the even neighbour; the cast alone agrees on ties of
    both signs and several exponents."""
    import ml_dtypes
    from repro.checkpoint.manager import CheckpointManager as RManager

    rng = np.random.default_rng(4)
    a = rng.uniform(0.5, 1.0, (2, 48, 64)).astype(np.float32)
    a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    a[0, 0, 0] = 1.0
    eb_rel = 3 * 2.0 ** -10
    tdir = str(tmp_path / "port")
    CheckpointManager(tdir, lossy_eb_rel=eb_rel, device="cpu").save(
        1, {"w": torch.from_numpy(a).bfloat16()},
        {"step": torch.zeros((), dtype=torch.int32)}, blocking=True)
    tp, _, _ = CheckpointManager(tdir, device="cpu").restore(1)
    rp, _, _ = RManager(tdir).restore(1)
    got, want = tp["w"], rp["w"]
    assert got.dtype == torch.bfloat16 and want.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    recon = torch.from_numpy(np.round(a / (6 * 2.0 ** -10)) * 3
                             * 2.0 ** -9).float()
    ties = (recon.view(torch.int32) & 0xFFFF) == 0x8000
    assert int(ties.sum()) > 1000
    assert bool(((got.view(torch.int16)[ties] & 1) == 0).all())
    # the cast alone, on ties of both signs and of several exponents
    bits = np.arange(0, 1 << 16, 7, dtype=np.uint32) << 16 | 0x8000
    vals = bits.astype(np.uint32).view(np.float32)
    vals = vals[np.isfinite(vals)]
    np.testing.assert_array_equal(
        torch.from_numpy(vals).bfloat16().view(torch.int16).numpy(),
        vals.astype(ml_dtypes.bfloat16).view(np.int16))


# ---------------------------------------------------------- the manager

def test_nonblocking_save_snapshots_before_inplace_update(tmp_path):
    """``save`` copies the leaves before it returns: updating the
    parameters in place right after a non-blocking save (as the port's
    train steps do) leaves the checkpoint with the values before the
    update.  On the CPU, ``.cpu()`` would share the storage."""
    rng = np.random.default_rng(1)
    params = {f"w{i}": torch.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32)) for i in range(32)}
    before = {k: v.clone() for k, v in params.items()}
    opt = {"step": torch.zeros((), dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(1, params, opt)
    for v in params.values():
        v.add_(1.0)
    opt["step"] += 1
    mgr.wait()
    rp, ro, _ = mgr.restore(1)
    for k, v in before.items():
        assert torch.equal(rp[k], v), k
    assert int(ro["step"]) == 0 and ro["step"].dim() == 0


def test_keep_deletes_old_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, device="cpu")
    params = {"w": torch.ones(4)}
    for s in range(1, 5):
        mgr.save(s, params, {"step": torch.tensor(s, dtype=torch.int32)})
    mgr.wait()
    assert mgr.list_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000003.json", "step_00000003.npz",
        "step_00000004.json", "step_00000004.npz"]
    _, ro, step = mgr.restore_latest()
    assert step == 4 and int(ro["step"]) == 4
    assert CheckpointManager(str(tmp_path / "empty"),
                             device="cpu").restore_latest() is None


def test_legacy_lossy_entry_restores(tmp_path):
    """A pre-TACZ lossy entry (no ``"format"``: zlib-compressed int16
    Lorenzo codes with their ``codes_dtype``, ``shape`` and ``eb``)
    restores in both packages to the same float32 values, within ``eb``
    of the source."""
    from repro.checkpoint.manager import CheckpointManager as RManager
    from repro.core.sz import lorenzo_nd_codes, prequant

    rng = np.random.default_rng(2)
    a = fixture.smooth_leaf(rng.standard_normal((3, 40, 50)).astype(
        np.float32))
    eb = 1e-3 * float(np.abs(a).max())
    codes = lorenzo_nd_codes(prequant(a, eb)).astype(np.int16)
    blob = np.frombuffer(zlib.compress(codes.tobytes()), np.uint8)
    step = np.asarray(2, np.int32)
    np.savez(str(tmp_path / "step_00000002.npz"),
             params__w=blob, opt__step=step)
    manifest = {
        "step": 2,
        "entries": {
            "params__w": {"path": "params/w", "shape": [3, 40, 50],
                          "dtype": "float32",
                          "crc": zlib.crc32(blob.tobytes())},
            "opt__step": {"path": "opt/step", "shape": [], "dtype": "int32",
                          "crc": zlib.crc32(step.tobytes())}},
        "lossy": {"params__w": {"eb": eb, "codes_dtype": "int16",
                                "shape": [3, 40, 50], "codec": "zlib",
                                "out_dtype": "float32"}},
        "extra": {}}
    with open(tmp_path / "step_00000002.json", "w") as f:
        json.dump(manifest, f)
    tp, to, ts = CheckpointManager(str(tmp_path), device="cpu").restore(2)
    rp, ro, rs = RManager(str(tmp_path)).restore(2)
    assert ts == rs == 2 and int(to["step"]) == 2
    assert tp["w"].dtype == torch.float32
    np.testing.assert_array_equal(tp["w"].numpy(), np.asarray(rp["w"]))
    assert np.abs(tp["w"].numpy() - a).max() <= eb * (1 + 1e-6)


def test_checkpoint_lossy_mode_bounds_error(tmp_path):
    """The reference's ``test_checkpoint_lossy_mode_bounds_error`` on the
    port: deepseek-7b's smoke model, every large leaf made smooth, saved
    lossy at ``eb_rel = 1e-3``: each lossy leaf within the bound plus half
    an ulp of its dtype, every other leaf exact, and the file smaller than
    the lossless one."""
    cfg = smoke_config("deepseek_7b")
    params = init_from_specs(tmodel.model_specs(cfg),
                             torch.Generator().manual_seed(0), device="cpu")

    def smooth(p):
        if p.dim() >= 2 and p.numel() > 4096:
            r = torch.arange(p.shape[-2], dtype=torch.float32)
            c = torch.arange(p.shape[-1], dtype=torch.float32)
            field = torch.sin(r[:, None] / 9.0) * torch.cos(c[None, :] / 7.0)
            return (field * 0.02 + 0.001 * p.float()).to(p.dtype)
        return p

    params = fixture.nested({k: smooth(v) for k, v in
                             fixture.flat(params).items()})
    opt = {"step": torch.zeros((), dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path / "lossy"), lossy_eb_rel=1e-3,
                            device="cpu")
    mgr.save(1, params, opt, blocking=True)
    size = os.path.getsize(tmp_path / "lossy" / "step_00000001.npz")
    rp, ro, step = mgr.restore(1)
    assert step == 1
    got = fixture.flat(rp)
    for path, a in fixture.flat(params).items():
        b = got[path]
        assert b.dtype == a.dtype, path
        x, y = a.float().numpy(), b.float().numpy()
        rng = np.abs(x).max()
        if a.numel() > 4096 and a.dim() >= 2 and rng > 0:
            ulp = 2.0 ** -9 if a.dtype == torch.bfloat16 else 2.0 ** -24
            assert np.abs(x - y).max() <= (1e-3 + ulp) * rng * (1 + 1e-3)
        else:
            np.testing.assert_array_equal(x, y)
    mgr2 = CheckpointManager(str(tmp_path / "lossless"), device="cpu")
    mgr2.save(1, params, opt, blocking=True)
    assert size < os.path.getsize(tmp_path / "lossless" / "step_00000001.npz")


def test_checkpoint_corruption_detected(tmp_path):
    """The reference's ``test_checkpoint_corruption_detected``: a flipped
    byte in the npz payload fails the restore."""
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(1, {"w": torch.ones((8, 8))},
             {"step": torch.zeros((), dtype=torch.int32)}, blocking=True)
    f = tmp_path / "step_00000001.npz"
    data = bytearray(f.read_bytes())
    data[len(data) // 2] ^= 0xFF
    f.write_bytes(bytes(data))
    with pytest.raises(Exception):
        mgr.restore(1)


def test_checkpoint_manager_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckpointManager(str(tmp_path))


# ------------------------------------------------------ the card fixture

def _fixture_summary() -> dict:
    with open(os.path.join(fixture.CHECKPOINT_DIR, "restored.json")) as f:
        return json.load(f)


def _port_summary(params, opt) -> dict:
    return {path: [str(t.dtype).removeprefix("torch."), list(t.shape),
                   fixture.digest(_np(t))]
            for path, t in fixture.flat({"params": params,
                                         "opt": opt}).items()}


def _port_checkpoint_state():
    """The checkpoint case in the port: the smoke tree in each leaf's
    dtype (torch's bf16 cast, round to nearest even as ``ml_dtypes``) and
    the seeded Adafactor state of the port's structure."""
    cfg = fixture.checkpoint_cfg(smoke_config)
    specs = tmodel.model_specs(cfg)
    dtypes = {k: v.torch_dtype for k, v in fixture.flat(specs).items()}
    params = fixture.nested({k: _torch(a, dtypes[k]) for k, a in
                             fixture.checkpoint_params(specs).items()})
    init = tada.adafactor_init(params, tada.AdafactorConfig())
    opt = fixture.checkpoint_opt({k: tuple(v.shape) for k, v in
                                  fixture.flat(init).items()})
    return params, fixture.nested({k: torch.from_numpy(v)
                                   for k, v in opt.items()})


def _restore_fixture(kind: str, device: str) -> dict:
    mgr = CheckpointManager(os.path.join(fixture.CHECKPOINT_DIR, kind),
                            device=device)
    params, opt, step = mgr.restore(fixture.CHECKPOINT_STEP)
    assert step == fixture.CHECKPOINT_STEP
    for path, t in fixture.flat(params).items():
        assert t.device.type == device, path
    assert opt["step"].device.type == "cpu" and opt["step"].dim() == 0
    return _port_summary(params, opt)


@pytest.mark.parametrize("kind", list(fixture.CHECKPOINT_KINDS))
def test_port_restores_checkpoint_fixture_on_cpu(kind):
    assert _restore_fixture(kind, "cpu") == _fixture_summary()[kind]


@pytest.mark.parametrize("kind", list(fixture.CHECKPOINT_KINDS))
def test_port_writes_checkpoint_fixture_bytes(tmp_path, monkeypatch, kind):
    monkeypatch.setattr(ttensor, "HAVE_ZSTD", False)
    params, opt = _port_checkpoint_state()
    CheckpointManager(str(tmp_path), lossy_eb_rel=fixture.CHECKPOINT_KINDS[
        kind], device="cpu").save(fixture.CHECKPOINT_STEP, params, opt,
                                  extra=fixture.CHECKPOINT_EXTRA,
                                  blocking=True)
    assert _files(str(tmp_path), fixture.CHECKPOINT_STEP) == _files(
        os.path.join(fixture.CHECKPOINT_DIR, kind), fixture.CHECKPOINT_STEP)


def test_checkpoint_fixture_regenerates(tmp_path):
    """The reference writes the fixture's files again, byte for byte, and
    restores the same arrays (their digests equal)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(os.path.join(HERE, "..", "src"))]
        + [p for p in [env.get("PYTHONPATH")] if p])
    out = str(tmp_path / "checkpoint")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "card_reference",
                                      "make_card_reference.py"),
         "--checkpoint", out], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for kind in fixture.CHECKPOINT_KINDS:
        assert _files(os.path.join(out, kind), fixture.CHECKPOINT_STEP) == \
            _files(os.path.join(fixture.CHECKPOINT_DIR, kind),
                   fixture.CHECKPOINT_STEP), kind
    assert _bytes(os.path.join(out, "restored.json")) == _bytes(
        os.path.join(fixture.CHECKPOINT_DIR, "restored.json"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(fixture.CHECKPOINT_KINDS))
def test_checkpoint_fixture_restores_on_card(kind):
    """The fixture restored on the card equals the reference's arrays;
    the lossy one decodes each rank-3 leaf in one kernel-6 launch."""
    dev = _card()
    ops.reset_launches()
    assert _restore_fixture(kind, dev) == _fixture_summary()[kind]
    with open(os.path.join(fixture.CHECKPOINT_DIR, kind,
                           f"step_{fixture.CHECKPOINT_STEP:08d}.json")) as f:
        manifest = json.load(f)
    rank3 = sum(len(manifest["entries"][k]["shape"]) == 3
                for k in manifest["lossy"])
    assert ops.launches["lorenzo3d_recon"] == rank3
    assert (rank3 > 0) == (kind == "lossy")


@pytest.mark.cuda
def test_lossy_save_on_card_equals_plain(tmp_path):
    """A lossy save on the card (kernel 5 for rank 3, kernel 1 for rank 4)
    writes the bytes of the CPU's plain versions, and its restore (kernels
    6 and 2) the same arrays."""
    dev = _card()
    flat_p = _mixed_params()
    trees = {}
    for device in ("cpu", dev):
        params = fixture.nested({p: _torch(a, getattr(torch, LEAVES[p][1]))
                                 .to(device) for p, a in flat_p.items()})
        ops.reset_launches()
        CheckpointManager(str(tmp_path / device), lossy_eb_rel=1e-3,
                          device=device).save(
            1, params, {"step": torch.zeros((), dtype=torch.int32)},
            blocking=True)
        saved = dict(ops.launches)
        trees[device] = CheckpointManager(str(tmp_path / device),
                                          device=device).restore(1)[0]
        if device != "cpu":
            assert saved["lorenzo3d_codes"] == 2           # w3, b3
            assert saved["lorenzo3d_codes_batched"] == 1   # w4
            assert ops.launches["lorenzo3d_recon"] == 2
            assert ops.launches["lorenzo3d_recon_batched"] == 1
    assert _files(str(tmp_path / "cpu"), 1) == _files(str(tmp_path / dev), 1)
    for path, t in fixture.flat(trees["cpu"]).items():
        assert torch.equal(t, fixture.flat(trees[dev])[path].cpu()), path
