"""Kernels 5 and 6 (tiled 3D Lorenzo codes and recon) against the reference,
and the route kernel 2 (the brick-stack recon) takes for a brick shape.

On the CPU the wrappers run their plain PyTorch versions; here they are
held against the reference's numpy host path tile by tile, and against
the Pallas kernels in interpret mode on inputs where float32 and float64
quantization agree.  All comparisons are exact.  The CUDA kernels run
only on a card: ``test_tiled_kernels_match_plain_on_card`` and
``test_brick_recon_matches_plain_on_card`` are marked ``cuda`` and skip
without one; the reference is imported inside the CPU tests, so that the
card's tests run where JAX is not installed (``pytest --noconftest -m
cuda``).
"""
import numpy as np
import pytest
import torch

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
    from repro.core import sz as rsz

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
    from repro.kernels import ops as rops

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


# (X, Y, Z) bricks: the main paths' shapes (8³ to 64³, 48³), and the
# shared-memory budget's edges: whole bricks up to 8·X·Y·(Z+1) = 232,448
# bytes (8 x 16 x 226), X planes while 8·Y·(Z+1) fits (Y = 128, Z = 226)
ROUTES = [((16, 16, 16), "shared"), ((8, 8, 8), "shared"),
          ((8, 16, 16), "shared"), ((4, 4, 4), "shared"),
          ((8, 16, 226), "shared"), ((8, 16, 227), "planes"),
          ((32, 32, 32), "planes"), ((48, 48, 48), "planes"),
          ((64, 64, 64), "planes"), ((32, 64, 32), "planes"),
          ((2, 128, 226), "planes"), ((2, 128, 227), "three_pass"),
          ((3, 64, 512), "three_pass"), ((1, 1, 1), "shared")]


@pytest.mark.parametrize("brick,route", ROUTES)
def test_brick_recon_route_by_shape(brick, route):
    assert ops.recon_route(brick) == route
    x, y, z = brick
    assert (8 * x * y * (z + 1) <= ops.RECON_SMEM_BUDGET) == \
        (route == "shared")
    assert (8 * y * (z + 1) <= ops.RECON_SMEM_BUDGET) == \
        (route != "three_pass")


@pytest.mark.parametrize("brick", [(16, 16, 16), (5, 7, 9), (32, 32, 32),
                                   (2, 128, 227)])
def test_brick_recon_plain_matches_host_path(brick):
    # the plain version the CPU runs whatever the route: the reference's
    # N-D Lorenzo recon brick by brick
    from repro.core import sz as rsz

    eb = 0.02
    rng = np.random.default_rng(sum(brick))
    codes = rng.integers(-3000, 3000, (2, *brick)).astype(np.int64)
    got = ops.lorenzo3d_recon_batched(torch.from_numpy(codes), eb)
    for i in range(2):
        want = rsz.dequant(rsz.lorenzo_nd_recon(codes[i]), eb)
        np.testing.assert_array_equal(got[i].numpy(), want)


@pytest.mark.cuda
def test_brick_recon_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(4)
    for brick, _ in ROUTES + [((5, 7, 9), "shared"), ((33, 17, 31), "shared")]:
        for n in (1, 3, 37) if brick[0] * brick[1] * brick[2] < 10 ** 5 \
                else (1, 3):
            codes = torch.randint(-2 ** 20, 2 ** 20, (n, *brick),
                                  generator=gen, device="cuda")
            assert torch.equal(ops.lorenzo3d_recon_batched(codes, 0.013),
                               ref.lorenzo3d_recon_batched(codes, 0.013))
    # a storage offset that breaks the 16-byte alignment of the loads
    flat = torch.randint(-99, 99, (1 + 4 * 16 ** 3,), generator=gen,
                         device="cuda")
    codes = flat[1:].view(4, 16, 16, 16)
    assert torch.equal(ops.lorenzo3d_recon_batched(codes, 0.5),
                       ref.lorenzo3d_recon_batched(codes, 0.5))
