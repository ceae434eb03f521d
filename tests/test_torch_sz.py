"""The port's SZ Lor/Reg core against the reference's numpy host path.

Same inputs (numpy, seeded) go through ``repro.core.sz`` and
``repro_torch.core.sz`` on the CPU.  Codes, branch choices, betas,
reconstructions and meta bits must agree exactly: the port reproduces
numpy's summation order for the regression fit's block sums.
"""
import numpy as np
import pytest
import torch

from repro.core import sz as rsz
from repro_torch.core import sz


def _smooth_stack(shape, seed):
    """Bricks mixing planes (regression wins) and rough fields (Lorenzo
    wins)."""
    rng = np.random.default_rng(seed)
    n = shape[0]
    i, j, k = np.meshgrid(*[np.arange(s) for s in shape[1:]], indexing="ij")
    out = []
    for b in range(n):
        plane = 3.0 * i + 2.0 * j - 1.0 * k + rng.normal(0, 0.3, shape[1:])
        rough = 40.0 * np.sin(i * j + b) * (b % 2)
        out.append(plane + rough + rng.lognormal(0, 1.0, shape[1:]) * (b % 3 == 0))
    return np.stack(out).astype(np.float32)


def _assert_same(ref_results, port_results):
    assert len(ref_results) == len(port_results)
    for r, p in zip(ref_results, port_results):
        assert r.extras["branch"] == p.extras["branch"]
        assert r.method == p.method and r.meta_bits == p.meta_bits
        np.testing.assert_array_equal(p.codes.numpy(), r.codes)
        np.testing.assert_array_equal(p.recon.numpy(), r.recon)
        if r.extras["branch"] == "reg":
            np.testing.assert_array_equal(p.extras["betas"].numpy(),
                                          r.extras["betas"])


@pytest.mark.parametrize("shape", [(4, 12, 12, 12), (3, 24, 24, 24),
                                   (5, 16, 16, 16), (3, 4, 4, 4),
                                   (6, 20, 8, 4), (2, 8, 4, 16),
                                   (4, 6, 6, 6), (3, 2, 4, 6), (5, 2, 2, 2)])
def test_compress_lor_reg_batched_matches(shape):
    x = _smooth_stack(shape, seed=sum(shape))
    eb = 1e-2
    ref = rsz.compress_lor_reg_batched(x, eb, engine="numpy")
    port = sz.compress_lor_reg_batched(torch.from_numpy(x), eb)
    _assert_same(ref, port)


def test_both_branches_exercised():
    x = _smooth_stack((6, 12, 12, 12), seed=1)
    port = sz.compress_lor_reg_batched(torch.from_numpy(x), 1e-2)
    assert {p.extras["branch"] for p in port} == {"reg", "lorenzo"}


@pytest.mark.parametrize("shape", [(3, 18, 6, 12), (2, 64, 8, 8),
                                   (4, 4, 8, 12), (2, 12, 6, 6)])
def test_block_mean_follows_numpy_order(shape):
    x = np.random.default_rng(3).lognormal(0, 1.8, shape).astype(np.float32)
    b, _ = rsz.reg_block_grid(shape[1:], 6)
    xb, _ = rsz._block_view_batched(x, b)
    want = xb.mean(axis=(-3, -2, -1))
    pxb, _ = sz._block_view_batched(torch.from_numpy(x), b)
    got = sz._block_sum(pxb) / float(b ** 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("branch", ["lorenzo", "reg"])
def test_decode_codes_batched_matches(branch):
    x = _smooth_stack((5, 12, 18, 6), seed=4)
    eb = 5e-3
    port = sz.compress_lor_reg_batched(torch.from_numpy(x), eb)
    ref = rsz.compress_lor_reg_batched(x, eb, engine="numpy")
    _assert_same(ref, port)
    rows = [i for i, r in enumerate(ref) if r.extras["branch"] == branch]
    assert rows
    codes = np.stack([ref[i].codes for i in rows])
    betas = (np.stack([ref[i].extras["betas"] for i in rows])
             if branch == "reg" else None)
    want = rsz.decode_codes_batched(codes, x.shape[1:], eb, branch=branch,
                                    betas=betas)
    got = sz.decode_codes_batched(
        torch.from_numpy(codes), x.shape[1:], eb, branch=branch,
        betas=None if betas is None else torch.from_numpy(betas))
    np.testing.assert_array_equal(got.numpy(), want)
    for r, i in enumerate(rows):
        np.testing.assert_array_equal(got[r].numpy(), ref[i].recon)
    one = sz.decode_codes(torch.from_numpy(codes[0]), x.shape[1:], eb,
                          branch=branch,
                          betas=None if betas is None
                          else torch.from_numpy(betas[0]))
    np.testing.assert_array_equal(one.numpy(), want[0])


def test_prequant_dequant_and_nd_lorenzo():
    x = np.random.default_rng(5).normal(0, 9, (6, 7, 5)).astype(np.float32)
    eb = 0.013
    q = sz.prequant(torch.from_numpy(x), eb)
    np.testing.assert_array_equal(q.numpy(), rsz.prequant(x, eb))
    np.testing.assert_array_equal(sz.dequant(q, eb).numpy(),
                                  rsz.dequant(q.numpy(), eb))
    c = sz.lorenzo_nd_codes(q)
    np.testing.assert_array_equal(c.numpy(), rsz.lorenzo_nd_codes(q.numpy()))
    np.testing.assert_array_equal(sz.lorenzo_nd_recon(c).numpy(), q.numpy())
    with pytest.raises(ValueError):
        sz.prequant(torch.from_numpy(x), 0.0)


def test_reg_block_grid_and_unported_branches():
    for shape in [(8, 8, 8), (1, 5, 9), (3, 16, 2)]:
        assert sz.reg_block_grid(shape, 6) == rsz.reg_block_grid(shape, 6)
    # 1D Lorenzo and interp payloads decode as the reference decodes them
    codes = np.random.default_rng(8).integers(-9, 9, (2, 8))
    for shape, branch in [((8,), "lorenzo"), ((2, 2, 2), "interp")]:
        np.testing.assert_array_equal(
            sz.decode_codes_batched(torch.from_numpy(codes), shape, 0.1,
                                    branch=branch).numpy(),
            rsz.decode_codes_batched(codes, shape, 0.1, branch=branch))
    with pytest.raises(ValueError):
        sz.decode_codes_batched(torch.from_numpy(codes), (8,), 0.1,
                                branch="reg", betas=torch.zeros(2, 1, 4))
