"""Error-bound tuning on the port (``repro_torch.core.metrics``,
``core.baselines``, ``tuning``, ``io.variants``) against the reference's
``repro`` modules, on the CPU.

Both packages get the same seeded datasets: the reference tuning tests'
32³ two-level ``ds`` (densities [0.35, 0.65], ``refine_block=4``, seed 5)
and the reference bench's three-level one (densities [0.3, 0.5, 0.2],
seed 5).  Held to the reference:

* ``uniform_resolution``, ``reconstruct_uniform``, ``psnr``,
  ``amr_psnr``, ``psnr_u``, ``max_abs_error``, the halo finder and the
  three baselines (bits, recon): exact;
* ``ps_error``: within 1e-12 absolute (``torch.fft`` cannot match
  pocketfft bit for bit; the binning is fixed-order and repeats exactly);
* ``AutoTuner.tune``: the same bounds, bits, evaluation and compression
  counts and frontier points on every target; the same
  ``TargetUnsatisfiable`` best;
* variant sets written with ``payload_codec="none"``: catalogs field by
  field, catalog bytes for the same body, every variant's levels decoding
  bit for bit in both directions across the packages, frontier sections.

The reference is imported inside fixtures and test bodies only.
"""
import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import io as tio
from repro_torch.convert import dataset_from_arrays
from repro_torch.core import amr, baselines, hybrid, metrics
from repro_torch.io import frontier as frt
from repro_torch.io import variants as vrt
from repro_torch.tuning import AutoTuner, measure_metrics, write_variant_set

PS_TOL = 1e-12
DATASETS = {"two_level": dict(densities=[0.35, 0.65]),
            "three_level": dict(densities=[0.3, 0.5, 0.2])}
TARGETS = ["psnr>=50", "psnr>=55", "psnr>=60", "psnr>=70",
           "ps_error<=0.01"]
VARIANTS = {"hi": "psnr>=70", "lo": "psnr>=50"}
EXACT = ("psnr", "psnr_u", "max_abs_error")


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (imported here, not at module level)."""
    from repro import io as rio
    from repro.core import amr as ramr
    from repro.core import baselines as rbaselines
    from repro.core import hybrid as rhybrid
    from repro.core import metrics as rmetrics
    from repro.io import frontier as rfrt
    from repro.io import variants as rvrt
    from repro import tuning as rtuning
    return SimpleNamespace(io=rio, amr=ramr, baselines=rbaselines,
                           hybrid=rhybrid, metrics=rmetrics, frt=rfrt,
                           vrt=rvrt, tuning=rtuning)


@pytest.fixture(scope="module")
def pairs(ref):
    """``{name: (reference dataset, port dataset, eb)}``."""
    out = {}
    for name, kw in DATASETS.items():
        rds = ref.amr.synthetic_amr((32, 32, 32), refine_block=4, seed=5,
                                    **kw)
        ds = dataset_from_arrays([(l.data, l.mask, l.ratio)
                                  for l in rds.levels])
        eb = 1e-3 * float(rds.levels[0].data.max()
                          - rds.levels[0].data.min())
        out[name] = (rds, ds, eb)
    return out


@pytest.fixture(scope="module")
def compressed(ref, pairs):
    """``{name: (reference result, port result)}`` at the dataset's eb."""
    return {name: (ref.hybrid.compress_amr(rds, eb=eb),
                   hybrid.compress_amr(ds, eb=eb, device="cpu"))
            for name, (rds, ds, eb) in pairs.items()}


def _metrics_match(want: dict, got: dict) -> None:
    assert set(want) == set(got)
    for k in EXACT:
        assert got[k] == want[k], (k, got[k], want[k])
    assert abs(got["ps_error"] - want["ps_error"]) <= PS_TOL


# ------------------------------- metrics -----------------------------------


@pytest.mark.parametrize("name", DATASETS)
def test_uniform_fields_exact(ref, pairs, compressed, name):
    rds, ds, _ = pairs[name]
    rres, res = compressed[name]
    uni = amr.uniform_resolution(ds)
    assert isinstance(uni, np.ndarray) and uni.dtype == np.float32
    np.testing.assert_array_equal(uni, ref.amr.uniform_resolution(rds))
    got = metrics.reconstruct_uniform(ds, res)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  ref.metrics.reconstruct_uniform(rds, rres))


@pytest.mark.parametrize("name", DATASETS)
def test_psnr_exact(ref, pairs, compressed, name):
    rds, ds, _ = pairs[name]
    rres, res = compressed[name]
    assert metrics.amr_psnr(ds, res) == ref.metrics.amr_psnr(rds, rres)
    orig_u = ref.amr.uniform_resolution(rds)
    recon_u = ref.metrics.reconstruct_uniform(rds, rres)
    assert metrics.psnr(orig_u, recon_u, device="cpu") == \
        ref.metrics.psnr(orig_u, recon_u)
    assert metrics.psnr(orig_u, orig_u, device="cpu") == float("inf")


@pytest.mark.parametrize("name", DATASETS)
def test_measure_metrics_match_reference(ref, pairs, compressed, name):
    rds, ds, _ = pairs[name]
    rres, res = compressed[name]
    want = ref.tuning.measure_metrics(rds, rres)
    got = measure_metrics(ds, res)
    _metrics_match(want, got)
    assert got == measure_metrics(ds, res)      # the same floats again


@pytest.mark.parametrize("name", DATASETS)
def test_power_spectrum_within_tolerance_and_repeatable(ref, pairs,
                                                        compressed, name):
    rds, _, _ = pairs[name]
    rres, _ = compressed[name]
    orig_u = ref.amr.uniform_resolution(rds)
    recon_u = ref.metrics.reconstruct_uniform(rds, rres)
    k_ref, p_ref = ref.metrics.power_spectrum(orig_u)
    k, p = metrics.power_spectrum(orig_u, device="cpu")
    np.testing.assert_array_equal(k.numpy(), k_ref)
    np.testing.assert_allclose(p.numpy(), p_ref, rtol=1e-12, atol=0)
    _, p2 = metrics.power_spectrum(torch.from_numpy(orig_u))
    assert torch.equal(p, p2)
    want = ref.metrics.power_spectrum_error(orig_u, recon_u, k_max=10.0)
    got = metrics.power_spectrum_error(orig_u, recon_u, k_max=10.0,
                                       device="cpu")
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= PS_TOL
    # odd bin counts and no k_max
    k_ref, p_ref = ref.metrics.power_spectrum(orig_u, n_bins=7)
    k, p = metrics.power_spectrum(orig_u, n_bins=7, device="cpu")
    np.testing.assert_array_equal(k.numpy(), k_ref)
    np.testing.assert_allclose(p.numpy(), p_ref, rtol=1e-12, atol=0)
    got = metrics.power_spectrum_error(orig_u, recon_u, device="cpu")
    want = ref.metrics.power_spectrum_error(orig_u, recon_u)
    assert float(np.abs(got.numpy() - want).max()) <= PS_TOL


@pytest.mark.parametrize("name", DATASETS)
def test_halo_finder_exact(ref, pairs, compressed, name):
    rds, ds, _ = pairs[name]
    rres, res = compressed[name]
    orig_u = ref.amr.uniform_resolution(rds)
    recon_u = ref.metrics.reconstruct_uniform(rds, rres)
    for kw in ({}, {"threshold_factor": 4.0, "min_cells": 2}):
        want = ref.metrics.halo_finder(orig_u, **kw)
        got = metrics.halo_finder(torch.from_numpy(orig_u), **kw)
        assert [(h.mass, h.n_cells, h.position) for h in got] == \
            [(h.mass, h.n_cells, h.position) for h in want]
        want_r = ref.metrics.halo_finder(recon_u, **kw)
        got_r = metrics.halo_finder(metrics.reconstruct_uniform(ds, res),
                                    **kw)
        assert metrics.halo_diff(got, got_r) == \
            ref.metrics.halo_diff(want, want_r)
    assert metrics.halo_diff([], got_r) == (0.0, 0.0)
    assert metrics.halo_diff(got, []) == ref.metrics.halo_diff(want, [])


# ------------------------------- baselines ---------------------------------

BASELINES = ["1d", "zmesh", "3d/lorenzo", "3d/lor_reg", "3d/interp"]


def _baseline(mod, kind: str, ds, eb, **kw):
    if kind == "1d":
        return mod.compress_1d_naive(ds, eb, **kw)
    if kind == "zmesh":
        return mod.compress_zmesh(ds, eb, **kw)
    return mod.compress_3d_baseline(ds, eb, algorithm=kind[3:], **kw)


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("kind", BASELINES)
def test_baselines_match_reference(ref, pairs, kind, name):
    rds, ds, eb = pairs[name]
    want = _baseline(ref.baselines, kind, rds, eb)
    got = _baseline(baselines, kind, ds, eb, device="cpu")
    assert got.method == want.method
    assert got.total_bits == want.total_bits
    for w, g in zip(want.levels, got.levels):
        assert (g.strategy, g.algorithm, g.payload_bits, g.codebook_bits,
                g.meta_bits, g.n_values, g.eb) == \
            (w.strategy, w.algorithm, w.payload_bits, w.codebook_bits,
             w.meta_bits, w.n_values, w.eb)
        assert g.recon.dtype == torch.float32
        np.testing.assert_array_equal(g.recon.numpy(), w.recon)


def test_zmesh_order_matches_reference(ref, pairs):
    rds, ds, _ = pairs["three_level"]
    stream, idx, tags = baselines.zmesh_order(ds)
    rstream, ridx, rtags = ref.baselines.zmesh_order(rds)
    np.testing.assert_array_equal(stream, rstream)
    np.testing.assert_array_equal(tags, rtags)
    for a, b in zip(idx, ridx):
        np.testing.assert_array_equal(a, b)


# -------------------------------- autotuner --------------------------------


def _frontier_match(want, got) -> None:
    assert got.metric == want.metric and got.default == want.default
    assert len(got.points) == len(want.points)
    for w, g in zip(want.points, got.points):
        assert g.ebs == w.ebs and g.bits == w.bits
        _metrics_match(w.metrics, g.metrics)


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("target", TARGETS)
def test_autotune_matches_reference(ref, pairs, name, target):
    rds, ds, _ = pairs[name]
    want = ref.tuning.AutoTuner(rds, steps_down=4, steps_up=4).tune(target)
    tuner = AutoTuner(ds, steps_down=4, steps_up=4, device="cpu")
    got = tuner.tune(target)
    assert str(got.target) == str(want.target)
    assert got.ebs == want.ebs and got.bits == want.bits
    assert got.evaluations == want.evaluations
    assert got.compressions == want.compressions
    _metrics_match(want.metrics, got.metrics)
    _frontier_match(want.frontier, got.frontier)
    assert got.result.total_bits == got.bits
    for w, g in zip(want.result.levels, got.result.levels):
        np.testing.assert_array_equal(g.recon.numpy(), w.recon)


def test_autotune_unsatisfiable_same_best(ref, pairs):
    rds, ds, _ = pairs["two_level"]
    with pytest.raises(ref.frt.TargetUnsatisfiable) as want:
        ref.tuning.AutoTuner(rds, steps_down=1, steps_up=1).tune(
            "psnr>=500")
    with pytest.raises(frt.TargetUnsatisfiable) as got:
        AutoTuner(ds, steps_down=1, steps_up=1, device="cpu").tune(
            "psnr>=500")
    assert got.value.best == want.value.best
    assert str(got.value) == str(want.value)


def test_autotune_memo_one_compression_per_level_eb(pairs):
    _, ds, _ = pairs["two_level"]
    tuner = AutoTuner(ds, steps_down=3, steps_up=3, device="cpu")
    tuner.tune("psnr>=50")
    first = tuner.compressions
    tuner.tune("psnr>=60")    # overlapping ladder → memo reuse
    assert tuner.compressions == len(tuner._level_memo)
    assert tuner.compressions < 2 * first


def test_autotune_restated_from_decoded_snapshot(tmp_path, pairs):
    """The tuned point's metrics hold when re-measured from the decoded
    file, exactly, and every level within its tuned bound."""
    _, ds, _ = pairs["two_level"]
    tr = AutoTuner(ds, steps_down=4, steps_up=4, device="cpu").tune(
        "psnr>=60")
    path = str(tmp_path / "tuned.tacz")
    tio.write(path, tr.result, frontier=tr.frontier, device="cpu")
    recons = tio.read(path, device="cpu")
    decoded = hybrid.AMRCompressionResult(
        levels=[hybrid.LevelResult(**{**lr.__dict__, "recon": r})
                for lr, r in zip(tr.result.levels, recons)],
        method=tr.result.method)
    assert measure_metrics(ds, decoded) == tr.metrics
    for li, (lvl, r) in enumerate(zip(ds.levels, recons)):
        err = np.abs(r.numpy() - lvl.data)[lvl.mask]
        assert float(err.max()) <= tr.ebs[li] * (1 + 1e-5)


def test_tuner_rejects_bad_factor(pairs):
    _, ds, _ = pairs["two_level"]
    with pytest.raises(ValueError, match="factor"):
        AutoTuner(ds, factor=1.0, device="cpu")


# ------------------------------ variant sets -------------------------------


@pytest.fixture(scope="module")
def variant_sets(ref, pairs, tmp_path_factory):
    """The two-level dataset's ``hi``/``lo`` set written by each package
    with ``payload_codec="none"``; ``(reference dir, port dir, port
    tuner)``."""
    rds, ds, _ = pairs["two_level"]
    root = str(tmp_path_factory.mktemp("vsets"))
    rdir = ref.tuning.write_variant_set(
        os.path.join(root, "ref.taczv"), rds, VARIANTS, default="lo",
        payload_codec="none")
    tuner = AutoTuner(ds, device="cpu")
    pdir = write_variant_set(os.path.join(root, "port.taczv"), ds, VARIANTS,
                             default="lo", payload_codec="none",
                             tuner=tuner)
    return rdir, pdir, tuner


def test_variant_catalogs_match(ref, variant_sets):
    rdir, pdir, _ = variant_sets
    want = ref.vrt.load_catalog(rdir)
    got = vrt.load_catalog(pdir)
    assert vrt.is_variant_set(pdir)
    assert vrt.variant_names(got) == ["hi", "lo"]
    assert {k: v for k, v in got.items() if k not in ("variants", "crc32")} \
        == {k: v for k, v in want.items() if k not in ("variants", "crc32")}
    for w, g in zip(want["variants"], got["variants"]):
        assert {k: v for k, v in g.items() if k != "metrics"} == \
            {k: v for k, v in w.items() if k != "metrics"}
        _metrics_match(w["metrics"], g["metrics"])


def test_catalog_bytes_equal_reference(ref, variant_sets, tmp_path):
    """The same body publishes to the reference's bytes and CRC."""
    rdir, _, _ = variant_sets
    body = ref.vrt.load_catalog(rdir)
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    vrt.write_catalog(str(a), dict(body))
    ref.vrt.write_catalog(str(b), dict(body))
    assert (a / vrt.VARIANTS_NAME).read_bytes() == \
        (b / vrt.VARIANTS_NAME).read_bytes()
    assert vrt.load_catalog(str(a)) == ref.vrt.load_catalog(str(b))


@pytest.mark.parametrize("variant", ["hi", "lo"])
def test_variant_files_decode_across_packages(ref, variant_sets, variant):
    rdir, pdir, _ = variant_sets
    rpath = os.path.join(rdir, f"{variant}.tacz")
    ppath = os.path.join(pdir, f"{variant}.tacz")
    want = ref.io.read(rpath)
    for got in (tio.read(rpath, device="cpu"), tio.read(ppath, device="cpu"),
                ref.io.read(ppath)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.parametrize("variant", ["hi", "lo"])
def test_variant_frontier_sections_match(ref, variant_sets, variant):
    rdir, pdir, _ = variant_sets
    with ref.io.TACZReader(os.path.join(rdir, f"{variant}.tacz")) as rd:
        want = rd.frontier
    with tio.TACZReader(os.path.join(pdir, f"{variant}.tacz"),
                        device="cpu") as rd:
        got = rd.frontier
        cat = vrt.load_catalog(pdir)
        entry = next(v for v in cat["variants"] if v["name"] == variant)
        assert got.default_point.bits == entry["bits"]
        assert list(got.default_point.ebs) == entry["ebs"]
    _frontier_match(want, got)


def test_select_variant(variant_sets):
    _, pdir, _ = variant_sets
    cat = vrt.load_catalog(pdir)
    assert vrt.select_variant(cat, None)["name"] == "lo"
    assert vrt.select_variant(cat, "psnr>=60")["name"] == "hi"
    assert vrt.select_variant(cat, "psnr>=20")["name"] == "lo"
    with pytest.raises(frt.TargetUnsatisfiable) as ei:
        vrt.select_variant(cat, "psnr>=500")
    assert ei.value.best == max(v["metrics"]["psnr"]
                                for v in cat["variants"])
    with pytest.raises(ValueError):
        vrt.select_variant(cat, "psnr==60")


def test_catalog_corruption_detected(variant_sets, tmp_path):
    _, pdir, _ = variant_sets
    clone = str(tmp_path / "clone.taczv")
    shutil.copytree(pdir, clone)
    cpath = os.path.join(clone, vrt.VARIANTS_NAME)
    with open(cpath) as f:
        body = json.load(f)
    body["default"] = "hi"        # flip a field without re-stamping CRC
    with open(cpath, "w") as f:
        json.dump(body, f)
    with pytest.raises(ValueError, match="CRC"):
        vrt.load_catalog(clone)
    with open(cpath, "w") as f:
        f.write("{not json")
    with pytest.raises(ValueError, match="corrupt"):
        vrt.load_catalog(clone)
    assert not vrt.is_variant_set(str(tmp_path))


def test_variant_set_multipart_decodes_across_packages(ref, variant_sets,
                                                       pairs, tmp_path):
    """``parts=2`` writes each variant as a snapshot directory; both
    packages decode it to the single-file variant's levels."""
    rdir, _, tuner = variant_sets
    _, ds, _ = pairs["two_level"]
    pdir = write_variant_set(str(tmp_path / "mp.taczv"), ds, VARIANTS,
                             default="lo", parts=2, payload_codec="none",
                             tuner=tuner)
    assert vrt.load_catalog(pdir)["variants"][0]["file"] == "hi.taczd"
    for name in VARIANTS:
        want = ref.io.read(os.path.join(rdir, f"{name}.tacz"))
        mp = os.path.join(pdir, f"{name}.taczd")
        with tio.open_snapshot(mp, device="cpu") as rd:
            got = rd.read()
        with ref.io.open_snapshot(mp) as rd:
            got_ref = rd.read()
        for g, r, w in zip(got, got_ref, want):
            np.testing.assert_array_equal(g.numpy(), w)
            np.testing.assert_array_equal(r, w)


def test_write_variant_set_rejects_bad_default(pairs, tmp_path):
    _, ds, _ = pairs["two_level"]
    with pytest.raises(ValueError, match="default"):
        write_variant_set(str(tmp_path / "x"), ds, VARIANTS, default="mid",
                          device="cpu")
    with pytest.raises(ValueError, match="target"):
        write_variant_set(str(tmp_path / "y"), ds, {}, device="cpu")
