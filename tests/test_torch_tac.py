"""The port's global SZ compressors (the TAC path) against the reference.

``compress_lorenzo``, ``compress_interp`` and the sequential
``compress_lor_reg`` of ``repro_torch.core.sz`` run on the CPU (kernels in
their plain versions) on the same seeded numpy inputs as
``repro.core.sz``: codes, recon, method, branch, betas and all three bit
counts must be equal.  So must the decoders and the numpy-order sum the
whole-array branch score rests on.
"""
import numpy as np
import pytest
import torch

from repro.core import huffman as rhuffman
from repro.core import sz as rsz
from repro_torch.core import huffman, sz

SHAPES = [(5, 7, 9), (1, 3, 17), (3, 4, 5, 6), (12, 18, 30), (16, 16, 16),
          (2, 6, 6, 6), (20, 1, 9)]


def _field(shape, seed):
    """Smooth ramps (regression wins) plus lognormal spikes (Lorenzo
    wins), with a few half-integer ties of x / 2eb."""
    rng = np.random.default_rng(seed)
    idx = np.indices(shape).astype(np.float64)
    ramp = sum((k + 1.5) * a for k, a in enumerate(idx))
    spikes = rng.lognormal(0, 1.5, shape) * (seed % 2)
    return (ramp + spikes + rng.normal(0, 0.2, shape)).astype(np.float32)


def _assert_same(p, r):
    assert p.method == r.method
    assert (p.payload_bits, p.codebook_bits, p.meta_bits) == \
        (r.payload_bits, r.codebook_bits, r.meta_bits)
    assert p.extras.get("branch") == r.extras.get("branch")
    np.testing.assert_array_equal(p.codes.numpy(), r.codes)
    np.testing.assert_array_equal(p.recon.numpy(), r.recon)
    if r.extras.get("branch") == "reg":
        np.testing.assert_array_equal(p.extras["betas"].numpy(),
                                      r.extras["betas"])
    pe, re_ = p.extras["entropy"], r.extras["entropy"]
    assert pe["packed"] == re_["packed"] and pe["nbits"] == re_["nbits"]
    assert huffman.serialize_codebook(pe["codebook"]) == \
        rhuffman.serialize_codebook(re_["codebook"])


@pytest.mark.parametrize("name", ["compress_lorenzo", "compress_interp",
                                  "compress_lor_reg"])
@pytest.mark.parametrize("shape", SHAPES)
def test_global_compressors_match(name, shape):
    x = _field(shape, seed=sum(shape))
    eb = 0.01
    _assert_same(getattr(sz, name)(torch.from_numpy(x), eb),
                 getattr(rsz, name)(x, eb))


@pytest.mark.parametrize("name", ["compress_lorenzo", "compress_interp",
                                  "compress_lor_reg"])
def test_float64_input_keeps_host_arithmetic(name):
    # no float32 kernel applies: the plain path quantizes the float64 values
    x = np.random.default_rng(3).normal(0, 5, (12, 18, 30))
    _assert_same(getattr(sz, name)(torch.from_numpy(x), 0.01),
                 getattr(rsz, name)(x, 0.01))


def test_lor_reg_takes_both_branches():
    eb = 0.01
    rough = (np.random.default_rng(0).lognormal(0, 1.5, (16, 16, 16))
             + np.linspace(0, 5, 16)).astype(np.float32)
    methods = set()
    for x in (_field((12, 18, 30), 0), rough):
        p = sz.compress_lor_reg(torch.from_numpy(x), eb)
        _assert_same(p, rsz.compress_lor_reg(x, eb))
        methods.add(p.method)
    assert methods == {"lor_reg/reg", "lor_reg/lorenzo"}


def test_shared_codebook_and_no_entropy():
    x = _field((6, 8, 10), 3)
    rcb = rhuffman.build_codebook(np.arange(-2000, 2000))
    pcb = huffman.build_codebook(np.arange(-2000, 2000))
    for name in ("compress_lorenzo", "compress_interp", "compress_lor_reg"):
        _assert_same(getattr(sz, name)(torch.from_numpy(x), 0.05,
                                       codebook=pcb, use_zstd=False),
                     getattr(rsz, name)(x, 0.05, codebook=rcb,
                                        use_zstd=False))
    p = sz.compress_lor_reg(torch.from_numpy(x), 0.05, count_entropy=False)
    r = rsz.compress_lor_reg(x, 0.05, count_entropy=False)
    assert p.payload_bits == r.payload_bits == 0
    np.testing.assert_array_equal(p.codes.numpy(), r.codes)


@pytest.mark.parametrize("shape", [(5, 7, 9), (3, 4, 5, 6), (33,), (9, 17),
                                   (2, 2, 3, 3, 4)])
def test_interp_codes_roundtrip(shape):
    q = np.random.default_rng(len(shape)).integers(-900, 900, shape)
    codes = sz.interp_nd_codes(torch.from_numpy(q))
    np.testing.assert_array_equal(codes.numpy(), rsz.interp_nd_codes(q))
    np.testing.assert_array_equal(sz.interp_nd_recon(codes).numpy(), q)


def test_interp_shift_floors_negatives():
    # (b + c) >> 1 and the cubic >> 4 must floor negative values as numpy
    q = np.array([-7, 3, -9, 0, -1, -13, 5, -2, -11], dtype=np.int64)
    np.testing.assert_array_equal(
        sz.interp_nd_codes(torch.from_numpy(q)).numpy(),
        rsz.interp_nd_codes(q))


@pytest.mark.parametrize("shape,name,branch", [
    ((7, 9, 11), "compress_lorenzo", "lorenzo"),
    ((3, 4, 5, 6), "compress_lorenzo", "lorenzo"),
    ((40,), "compress_lorenzo", "lorenzo"),
    ((5, 7, 9), "compress_interp", "interp"),
    ((3, 4, 5, 6), "compress_interp", "interp"),
    ((12, 18, 30), "compress_lor_reg", "reg")])
def test_decode_codes_any_rank(shape, name, branch):
    x = _field(shape, seed=0)
    eb = 0.02
    r = getattr(rsz, name)(x, eb)
    if branch == "reg":
        assert r.extras["branch"] == "reg"
    betas = r.extras.get("betas")
    want = rsz.decode_codes(r.codes, shape, eb, branch=branch, betas=betas)
    np.testing.assert_array_equal(want, r.recon)
    got = sz.decode_codes(torch.from_numpy(r.codes), shape, eb,
                          branch=branch,
                          betas=None if betas is None
                          else torch.from_numpy(betas))
    np.testing.assert_array_equal(got.numpy(), want)
    if branch != "reg":
        stack = np.stack([r.codes, r.codes])
        np.testing.assert_array_equal(
            sz.decode_codes_batched(torch.from_numpy(stack), shape, eb,
                                    branch=branch).numpy(),
            rsz.decode_codes_batched(stack, shape, eb, branch=branch))


@pytest.mark.parametrize("n", [1, 7, 8, 129, 8191, 8192, 8193, 20000,
                               3 * 8192 + 5])
def test_numpy_sum_order(n):
    a = np.random.default_rng(n).lognormal(0, 3, n)
    assert sz._numpy_sum(torch.from_numpy(a)) == float(a.sum())


def test_entropy_stage_matches():
    codes = np.random.default_rng(2).integers(-50, 50, 3000)
    p = sz.entropy_stage(torch.from_numpy(codes))
    r = rsz.entropy_stage(codes)
    assert p[:2] == r[:2] and p[2]["packed"] == r[2]["packed"]
    assert sz.entropy_bits(torch.from_numpy(codes), use_zstd=False) == \
        rsz.entropy_bits(codes, use_zstd=False)
    assert sz.entropy_stage(torch.zeros(0, dtype=torch.int64))[:2] == (0, 0)
