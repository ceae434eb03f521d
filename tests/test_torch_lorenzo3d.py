"""Kernels 5 and 6 (tiled 3D Lorenzo codes and recon) against the reference.

On the CPU the wrappers run their plain PyTorch versions; here they are
held against the reference's numpy host path tile by tile, and against
the Pallas kernels in interpret mode on inputs where float32 and float64
quantization agree.  All comparisons are exact.  The CUDA kernels run
only on a card: ``test_tiled_kernels_match_plain_on_card`` is marked
``cuda`` and skips without one.
"""
import numpy as np
import pytest
import torch

from repro.core import sz as rsz
from repro.kernels import ops as rops
from repro_torch.kernels import ops, ref

CASES = [((5, 7, 9), (5, 7, 9)), ((8, 16, 16), (2, 4, 4)),
         ((6, 6, 6), (8, 128, 128)), ((12, 8, 20), (4, 8, 5)),
         ((1, 3, 17), (1, 3, 17)), ((16, 4, 8), (16, 1, 8))]


def _field(shape, eb, seed):
    x = np.random.default_rng(seed).normal(0, 40, shape).astype(np.float32)
    # half-integer ties of x / 2eb (round half to even must agree)
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5], dtype=np.float64)
    flat = x.reshape(-1)
    k = min(ties.size, flat.size)
    flat[:k] = (ties[:k] * 2.0 * eb).astype(np.float32)
    return x


def _host_per_tile(q, tile, fn):
    """Apply the reference's N-D Lorenzo ``fn`` to every tile of ``q``."""
    out = np.zeros(q.shape, dtype=np.int64)
    grid = [range(0, s, t) for s, t in zip(q.shape, tile)]
    for a in grid[0]:
        for b in grid[1]:
            for c in grid[2]:
                sl = (slice(a, a + tile[0]), slice(b, b + tile[1]),
                      slice(c, c + tile[2]))
                out[sl] = fn(q[sl])
    return out


@pytest.mark.parametrize("shape,tile", CASES)
def test_tiled_lorenzo_plain_matches_host_path(shape, tile):
    eb = 0.037
    x = _field(shape, eb, seed=sum(shape))
    t = ref.check_tile(shape, tile)
    q = rsz.prequant(x, eb)
    want = _host_per_tile(q, t, rsz.lorenzo_nd_codes)
    got = ops.lorenzo3d_codes(torch.from_numpy(x), eb, tile)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    recon = ops.lorenzo3d_recon(got, eb, tile)
    np.testing.assert_array_equal(recon.numpy(), rsz.dequant(q, eb))


@pytest.mark.parametrize("shape,tile", [((8, 16, 16), (4, 8, 8)),
                                        ((4, 8, 12), (4, 8, 12))])
def test_tiled_lorenzo_plain_matches_pallas_interpret(shape, tile):
    # no ties and |q| < 2^23, with 2eb a power of two: the Pallas body's
    # f32 reciprocal and f32 dequant are then exact too
    eb = 2.0 ** -4
    rng = np.random.default_rng(7)
    x = (np.floor(rng.normal(0, 30, shape) / (2 * eb)) * 2 * eb
         + 0.3 * eb).astype(np.float32)
    codes = ops.lorenzo3d_codes(torch.from_numpy(x), eb, tile)
    pallas = np.asarray(rops.lorenzo3d_codes(x, eb=eb, tile=tile,
                                             interpret=True))
    np.testing.assert_array_equal(codes.numpy(), pallas)
    recon = ops.lorenzo3d_recon(codes, eb, tile)
    pallas_r = np.asarray(rops.lorenzo3d_recon(pallas, eb=eb, tile=tile,
                                               interpret=True))
    np.testing.assert_array_equal(recon.numpy(), pallas_r)


def test_tile_must_divide_shape():
    x = torch.zeros(6, 8, 8)
    with pytest.raises(ValueError, match="not divisible"):
        ops.lorenzo3d_codes(x, 0.1, (4, 8, 8))
    with pytest.raises(ValueError, match="not divisible"):
        ops.lorenzo3d_recon(torch.zeros(6, 8, 8, dtype=torch.int64), 0.1,
                            (6, 3, 8))
    with pytest.raises(ValueError):
        ops.lorenzo3d_codes(x, 0.1, (0, 8, 8))
    with pytest.raises(TypeError):
        ops.lorenzo3d_codes(x.double(), 0.1, (6, 8, 8))
    # clamped to the shape, as the TPU kernel's grid does
    assert ref.check_tile((6, 8, 8), (8, 128, 128)) == (6, 8, 8)


@pytest.mark.cuda
def test_tiled_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for shape, tile in CASES + [((64, 128, 128), (8, 128, 128))]:
        x = torch.from_numpy(_field(shape, 0.02, 3)).to(dev)
        codes = ops.lorenzo3d_codes(x, 0.02, tile)
        assert torch.equal(codes, ref.lorenzo3d_codes(x, 0.02, tile))
        assert torch.equal(ops.lorenzo3d_recon(codes, 0.02, tile),
                           ref.lorenzo3d_recon(codes, 0.02, tile))
