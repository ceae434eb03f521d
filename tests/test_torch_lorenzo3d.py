"""Kernels 5 and 6 (tiled 3D Lorenzo codes and recon) against the reference,
and the route kernel 2 (the brick-stack recon) takes for a brick shape.

On the CPU the wrappers run their plain PyTorch versions; here they are
held against the reference's numpy host path tile by tile, and against
the Pallas kernels in interpret mode on inputs where float32 and float64
quantization agree.  All comparisons are exact.  The CUDA kernels run
only on a card: ``test_tiled_kernels_match_plain_on_card``,
``test_brick_recon_matches_plain_on_card`` and
``test_brick_codes_match_plain_on_card`` are marked ``cuda`` and skip
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


# (N, X, Y, Z) stacks for kernel 1.  Up to 2^17 values one thread per
# element: small stacks of the main paths' shapes and odd ones.  Past it
# the plane walk: the main paths' brick shapes (8^3 to 64^3, 48^3,
# 8 x 16 x 16), one 64^3 brick (cut into X slabs and Y bands), odd Z (one
# value a unit: whole bricks, Y bands); rows past 128 units take one
# thread per element again
K1_STACKS = [(3, 1, 1, 1), (5, 3, 5, 7), (37, 8, 8, 8), (7, 8, 16, 16),
             (71, 8, 16, 8), (1, 64, 64, 32), (2, 2, 128, 64),
             (300, 16, 16, 16), (600, 8, 8, 8), (90, 24, 16, 40),
             (11, 32, 32, 32), (3, 48, 48, 48), (2, 64, 64, 64),
             (1, 64, 64, 64), (130, 8, 16, 16), (13, 5, 64, 32),
             (9, 2, 128, 64), (2000, 3, 5, 7), (40, 3, 40, 30),
             (3, 8, 16, 512), (120, 3, 3, 129), (50, 3, 5, 201),
             (60, 2, 9, 129)]


@pytest.mark.parametrize("stack,route", [
    ((300, 16, 16, 16), "planes"), ((1, 64, 64, 64), "planes"),
    ((40, 3, 40, 30), "planes"), ((32, 16, 16, 16), "elementwise"),
    ((1, 64, 64, 32), "elementwise"), ((1, 64, 64, 33), "planes"),
    ((60, 2, 9, 129), "elementwise"), ((2, 64, 64, 512), "planes"),
    ((2, 64, 64, 516), "elementwise")])
def test_brick_codes_route_by_shape(stack, route):
    x = torch.zeros(stack)
    assert ops.codes_route(x) == route
    assert (x.numel() <= ops.CODES_ELEMENTWISE_MAX) <= (route ==
                                                         "elementwise")
    # off 16-byte alignment a load takes one value: a row of 512 is long
    flat = torch.zeros(1 + 2 * 64 * 64 * 512)
    assert ops.codes_route(flat[1:].view(2, 64, 64, 512)) == "elementwise"


@pytest.mark.cuda
def test_brick_codes_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    routes = set()
    for stack in K1_STACKS:
        x = torch.from_numpy(_field(stack, 0.02, sum(stack))).to(dev)
        routes.add(ops.codes_route(x))
        assert torch.equal(ops.lorenzo3d_codes_batched(x, 0.02),
                           ref.lorenzo3d_codes_batched(x, 0.02)), stack
    assert routes == {"planes", "elementwise"}
    # an eb that gives codes past 2^31
    x = torch.from_numpy(_field((40, 16, 16, 16), 1e-3, 1) * 1e3).to(dev)
    want = ref.lorenzo3d_codes_batched(x, 1e-7)
    assert int(want.abs().max()) > 2 ** 31
    assert torch.equal(ops.lorenzo3d_codes_batched(x, 1e-7), want)
    # a storage offset that breaks the 16-byte alignment of the loads
    flat = torch.from_numpy(_field((1 + 40 * 16 ** 3,), 0.5, 2)).to(dev)
    x = flat[1:].view(40, 16, 16, 16)
    assert torch.equal(ops.lorenzo3d_codes_batched(x, 0.5),
                       ref.lorenzo3d_codes_batched(x, 0.5))
    torch.cuda.synchronize()


def test_prequant_ties_match_host_path():
    """Quotients at and next to the ties of ``rint``: the port's prequant
    and kernel 1's plain version equal the reference's host path."""
    from repro.core import sz as rsz
    from repro_torch.core import sz

    eb = 1.3
    x = (np.arange(-20000, 20000) * 2.6 + 1.3).astype(np.float32)
    q = rsz.prequant(x, eb)
    np.testing.assert_array_equal(sz.prequant(torch.from_numpy(x), eb).numpy(),
                                  q)
    stack = x.reshape(10, 16, 10, 25)
    want = np.stack([rsz.lorenzo_nd_codes(rsz.prequant(b, eb)) for b in stack])
    np.testing.assert_array_equal(
        ops.lorenzo3d_codes_batched(torch.from_numpy(stack), eb).numpy(), want)


@pytest.mark.cuda
def test_prequant_divides_as_numpy_on_card():
    """Quotients at and next to the ties of ``rint``: the port's prequant
    (``sz.prequant``, kernel 1 and its plain version) rounds on the card
    as numpy's division does, not as a product with the reciprocal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.core import sz

    eb = 1.3
    x = (np.arange(-20000, 20000) * 2.6 + 1.3).astype(np.float32)
    want = np.round(x.astype(np.float64) / (2.0 * eb)).astype(np.int64)
    xt = torch.from_numpy(x).cuda()
    assert np.array_equal(sz.prequant(xt, eb).cpu().numpy(), want)
    stack = xt.reshape(10, 16, 10, 25)
    cpu = ref.lorenzo3d_codes_batched(stack.cpu(), eb)
    assert torch.equal(ref.lorenzo3d_codes_batched(stack, eb).cpu(), cpu)
    assert torch.equal(ops.lorenzo3d_codes_batched(stack, eb).cpu(), cpu)
    big = torch.cat([stack] * 4).reshape(40, 16, 10, 25)
    assert big.numel() > 2 ** 17
    assert torch.equal(ops.lorenzo3d_codes_batched(big, eb).cpu(),
                       ref.lorenzo3d_codes_batched(big.cpu(), eb))


# (shape, tile) → kernel 5's and kernel 6's routes: the new kernels at
# tile = shape within their row limits (Z ≤ 512 for the walk, Z ≤ 4096
# for the planes), the elementwise and three-pass kernels for any other
# tile and for longer rows, as the tensor codec sends them
ROUTES_3D = [
    ((128, 128, 128), (128, 128, 128), "walk", "planes"),
    ((512, 512, 512), (512, 512, 512), "walk", "planes"),
    ((512, 512, 512), (8, 128, 128), "elementwise", "three_pass"),
    ((64, 256, 512), (64, 256, 512), "walk", "planes"),
    ((3, 64, 1030), (3, 64, 1030), "elementwise", "planes"),
    ((5, 7, 9), (5, 7, 9), "walk", "planes"),
    ((1, 1, 1), (1, 1, 1), "walk", "planes"),
    ((2, 3, 513), (2, 3, 513), "elementwise", "planes"),
    ((2, 3, 4096), (2, 3, 4096), "elementwise", "planes"),
    ((1, 1, 4097), (1, 1, 4097), "elementwise", "three_pass"),
    ((1, 1, 10 ** 7), (1, 1, 10 ** 7), "elementwise", "three_pass"),
    ((8, 16, 16), (2, 4, 4), "elementwise", "three_pass"),
]


@pytest.mark.parametrize("shape,tile,codes,recon", ROUTES_3D)
def test_single_array_routes_by_shape_and_tile(shape, tile, codes, recon):
    t = ref.check_tile(shape, tile)
    assert ops.codes3d_route(shape, t) == codes
    assert ops.recon3d_route(shape, t) == recon
    assert (codes == "walk") == (t == shape and shape[2] <=
                                 ops.CODES3D_MAX_Z)
    assert (recon == "planes") == (t == shape and shape[2] <=
                                   ops.RECON3D_MAX_Z)


def test_tensor_codec_shapes_take_routes_by_shape():
    # the tensor codec hands kernels 5 and 6 any rank-3 float32 tensor
    # whole (tile = shape): the route follows its row length alone
    for shape in [(4, 4, 4), (2, 3, 600), (1, 2, 5000), (7, 1, 3)]:
        route = ops.codes3d_route(shape, shape)
        assert route == ("walk" if shape[2] <= 512 else "elementwise")
        route = ops.recon3d_route(shape, shape)
        assert route == ("planes" if shape[2] <= 4096 else "three_pass")


# shapes and tiles for kernels 5 and 6 on the card: the paths' grids
# (128³, 512³), odd and tiny arrays, rows with Z % 4 != 0 that are long
# for the walk, a wide plane, each at tile = shape and at the reference's
# default tile
CARD_3D = [(128, 128, 128), (512, 512, 512), (5, 7, 9), (1, 3, 17),
           (1, 1, 1), (3, 64, 1030), (64, 256, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_3D)
def test_single_array_kernels_match_plain_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    eb = 0.02
    x = torch.randn(shape, generator=gen, device="cuda") * (40.0)
    x[..., :1] = 0.0  # zeros, which the walk's zero test skips
    # the default tile where it divides the shape, else half rows
    default = (8, 128, 128) if shape[2] % min(128, shape[2]) == 0 else \
        (8, 128, shape[2] // 2)
    for tile in (shape, default):
        t = ref.check_tile(shape, tile)
        codes = ops.lorenzo3d_codes(x, eb, t)
        assert torch.equal(codes, ref.lorenzo3d_codes(x, eb, t)), (shape, t)
        assert torch.equal(ops.lorenzo3d_recon(codes, eb, t),
                           ref.lorenzo3d_recon(codes, eb, t)), (shape, t)
        del codes
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_single_array_kernels_on_views_and_wide_sums_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(5)
    # a storage offset that breaks the 16-byte alignment of the loads
    for shape in [(16, 64, 128), (9, 33, 512), (4, 6, 10)]:
        n = shape[0] * shape[1] * shape[2]
        flat = torch.randn(n + 1, generator=gen, device="cuda") * 50
        x = flat[1:].view(shape)
        assert ops.codes3d_route(shape, shape) == "walk"
        codes = ops.lorenzo3d_codes(x, 0.5, shape)
        assert torch.equal(codes, ref.lorenzo3d_codes(x, 0.5, shape))
        iflat = torch.empty(n + 1, dtype=torch.int64, device="cuda")
        iflat[1:] = codes.reshape(-1)
        view = iflat[1:].view(shape)
        assert torch.equal(ops.lorenzo3d_recon(view, 0.5, shape),
                           ref.lorenzo3d_recon(view, 0.5, shape))
    # an eb that gives codes and prefix sums past 2^31
    shape = (64, 64, 64)
    x = torch.rand(shape, generator=gen, device="cuda") * 1e3 + 1e3
    codes = ops.lorenzo3d_codes(x, 1e-7, shape)
    want = ref.lorenzo3d_codes(x, 1e-7, shape)
    assert int(want.abs().max()) > 2 ** 31
    assert torch.equal(codes, want)
    recon = ops.lorenzo3d_recon(codes, 1e-7, shape)
    assert torch.equal(recon, ref.lorenzo3d_recon(codes, 1e-7, shape))
    assert float(recon.abs().max()) > 2 ** 31 * 2e-7
    torch.cuda.synchronize()
