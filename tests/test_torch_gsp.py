"""The port's GSP and NaST pre-processing against the reference.

``repro_torch.core.gsp`` and ``repro_torch.core.nast`` run on the CPU on
the same seeded numpy levels as ``repro.core.gsp``/``repro.core.nast``:
padded grids, unpadded grids, packed blocks, coordinates and metadata
bits must be equal bit for bit.
"""
import numpy as np
import pytest
import torch

from repro.core import amr as ramr
from repro.core import gsp as rgsp
from repro.core import nast as rnast
from repro_torch.core import gsp, hybrid, nast


def _random_level(seed, bshape=(6, 5, 7), unit=4, density=0.4):
    """Blocks occupied at random, with lognormal values; partially valid
    blocks keep zeros in their invalid cells."""
    rng = np.random.default_rng(seed)
    occ = rng.random(bshape) < density
    shape = tuple(b * unit for b in bshape)
    mask = np.repeat(np.repeat(np.repeat(occ, unit, 0), unit, 1), unit, 2)
    mask &= rng.random(shape) < 0.9
    data = np.zeros(shape, np.float32)
    data[mask] = rng.lognormal(0, 2.0, int(mask.sum())).astype(np.float32)
    return data, mask


@pytest.mark.parametrize("unit", [2, 4, 8])
@pytest.mark.parametrize("density", [0.1, 0.5, 0.9])
def test_gsp_pad_matches(unit, density):
    data, mask = _random_level(int(density * 10) + unit, unit=unit,
                               density=density)
    want, rgrid = rgsp.gsp_pad(data, mask, unit=unit)
    got, grid = gsp.gsp_pad(data, mask, unit=unit, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(grid.occ, rgrid.occ)
    assert gsp.gsp_meta_bits(grid) == rgsp.gsp_meta_bits(rgrid)
    np.testing.assert_array_equal(gsp.gsp_unpad(got, grid).numpy(),
                                  rgsp.gsp_unpad(want, rgrid))


def test_gsp_pad_on_amr_levels_with_ragged_shape():
    ds = ramr.synthetic_amr((24, 24, 24), densities=[0.2, 0.8],
                            refine_block=4, seed=9)
    for lvl in ds.levels:
        for unit in (2, 5, 8):      # 5 does not divide 24 or 12: padded grid
            want, _ = rgsp.gsp_pad(lvl.data, lvl.mask, unit=unit)
            got, _ = gsp.gsp_pad(lvl.data, lvl.mask, unit=unit, device="cpu")
            np.testing.assert_array_equal(got.numpy(), want)


def test_gsp_pads_with_neighbor_average():
    # one non-empty block with constant value 2.0; its empty face neighbour
    # is padded with 2.0 in the adjacent m layers
    occ_data = np.zeros((8, 8, 8), np.float32)
    occ_data[0:4] = 2.0
    mask = np.zeros_like(occ_data, bool)
    mask[0:4] = True
    padded, _ = gsp.gsp_pad(occ_data, mask, unit=4, device="cpu")
    want, _ = rgsp.gsp_pad(occ_data, mask, unit=4)
    np.testing.assert_array_equal(padded.numpy(), want)
    m = min(4 // 2, 4)
    assert bool((padded[4:4 + m, :4, :4] == 2.0).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nast_roundtrip_matches(seed):
    data, mask = _random_level(seed, density=0.3 + 0.2 * seed)
    rpacked, rcoords, rgrid = rnast.nast_pack(data, mask, unit=4)
    packed, coords, grid = nast.nast_pack(data, mask, unit=4, device="cpu")
    np.testing.assert_array_equal(packed.numpy(), rpacked)
    np.testing.assert_array_equal(coords, rcoords)
    assert nast.nast_meta_bits(coords) == rnast.nast_meta_bits(rcoords)
    np.testing.assert_array_equal(nast.nast_unpack(packed, coords,
                                                   grid).numpy(),
                                  rnast.nast_unpack(rpacked, rcoords, rgrid))


def test_nast_partition_is_unit_blocks():
    data, mask = _random_level(4, density=0.35)
    grid, strategy, _, subblocks = hybrid.partition_level(
        data, mask, unit=4, strategy="nast")
    assert strategy == "nast"
    assert [sb.origin for sb in subblocks] == \
        [tuple(c) for c in np.argwhere(grid.occ)]
    assert {sb.bsize for sb in subblocks} == {(1, 1, 1)}
