"""The port's TAC path (``she=False``; GSP, NaST, merged 4D) against the
reference, on the CPU.

``repro_torch.core.hybrid.compress_amr`` (``device="cpu"``, kernels in
their plain versions) and ``repro.core.hybrid.compress_amr`` run on the
same seeded datasets for every algorithm and strategy: method, strategy,
sub-block count, all three bit counts and the recon of every level must
be equal, and every recon holds the error bound.
"""
import numpy as np
import pytest

from repro.core import amr as ramr
from repro.core import hybrid as rhybrid
from repro_torch.convert import dataset_from_arrays
from repro_torch.core import hybrid

ALGORITHMS = ["lorenzo", "lor_reg", "interp"]


def _pair(shape, densities, refine_block, seed):
    rds = ramr.synthetic_amr(shape, densities=densities,
                             refine_block=refine_block, seed=seed)
    eb = 1e-3 * float(rds.levels[0].data.max() - rds.levels[0].data.min())
    ds = dataset_from_arrays([(l.data, l.mask, l.ratio) for l in rds.levels])
    return rds, ds, eb


@pytest.fixture(scope="module")
def dense():
    """The coarse level holds 90 % of the blocks: above T2, so GSP."""
    return _pair((32, 32, 32), [0.1, 0.9], 4, 2)


@pytest.fixture(scope="module")
def small():
    return _pair((16, 16, 16), [0.3, 0.7], 4, 6)


def _assert_same(rres, pres, rds):
    assert pres.method == rres.method
    assert pres.total_bits == rres.total_bits
    for rl, pl, lvl in zip(rres.levels, pres.levels, rds.levels):
        assert (pl.strategy, pl.algorithm, pl.she, pl.n_subblocks,
                pl.n_values, pl.payload_bits, pl.codebook_bits,
                pl.meta_bits) == \
            (rl.strategy, rl.algorithm, rl.she, rl.n_subblocks, rl.n_values,
             rl.payload_bits, rl.codebook_bits, rl.meta_bits)
        np.testing.assert_array_equal(pl.recon.numpy(), rl.recon)
        err = np.abs(pl.recon.numpy() - lvl.data)[lvl.mask].max()
        assert err <= pl.eb + 2.0 ** -22 * np.abs(lvl.data).max()


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_tac_compress_amr_matches(dense, algorithm):
    rds, ds, eb = dense
    rres = rhybrid.compress_amr(rds, eb=eb, algorithm=algorithm, she=False)
    pres = hybrid.compress_amr(ds, eb=eb, algorithm=algorithm, she=False,
                               device="cpu")
    assert [l.strategy for l in pres.levels] == ["opst", "gsp"]
    assert pres.method == f"tac/{algorithm}"
    _assert_same(rres, pres, rds)
    gsp_art = pres.levels[1].artifacts
    assert gsp_art.subblocks == [] and len(gsp_art.results) == 1
    assert pres.levels[0].artifacts is None    # merged 4D: not indexable


@pytest.mark.parametrize("strategy", ["gsp", "nast", "opst", "akdtree"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_tac_strategies_match(small, algorithm, strategy):
    rds, ds, eb = small
    rres = rhybrid.compress_amr(rds, eb=eb, algorithm=algorithm, she=False,
                                strategy=strategy)
    pres = hybrid.compress_amr(ds, eb=eb, algorithm=algorithm, she=False,
                               strategy=strategy, device="cpu")
    assert {l.strategy for l in pres.levels} == {strategy}
    _assert_same(rres, pres, rds)


@pytest.mark.parametrize("algorithm", ["lorenzo", "interp"])
def test_she_flag_with_global_algorithms_takes_tac(small, algorithm):
    # SHE pairs with Lor/Reg only: other algorithms take the TAC path
    rds, ds, eb = small
    rres = rhybrid.compress_amr(rds, eb=eb, algorithm=algorithm)
    pres = hybrid.compress_amr(ds, eb=eb, algorithm=algorithm, device="cpu")
    assert pres.method == f"tac/{algorithm}"
    _assert_same(rres, pres, rds)


@pytest.mark.parametrize("strategy", ["gsp", "nast"])
def test_tac_plus_with_forced_strategy_matches(small, strategy):
    rds, ds, eb = small
    rres = rhybrid.compress_amr(rds, eb=eb, strategy=strategy)
    pres = hybrid.compress_amr(ds, eb=eb, strategy=strategy, device="cpu")
    _assert_same(rres, pres, rds)


def test_unknown_algorithm_raises(small):
    _, ds, eb = small
    with pytest.raises(ValueError):
        hybrid.compress_amr(ds, eb=eb, algorithm="zfp", device="cpu")
