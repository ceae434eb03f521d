"""The port's Huffman codebooks, entropy engine and SHE histogram against
the reference, on the CPU: codebook bytes, payload bytes and histograms
must be identical."""
import numpy as np
import pytest
import torch

from repro.core import entropy as rentropy
from repro.core import huffman as rhuffman
from repro.core import she as rshe
from repro_torch.core import entropy, huffman, she


def _codes(seed, n=4000, scale=6.0):
    rng = np.random.default_rng(seed)
    return np.rint(rng.laplace(0, scale, n)).astype(np.int64)


@pytest.mark.parametrize("codes", [
    _codes(0), _codes(1, scale=300.0), np.array([5, 5, 5]),
    np.zeros(0, np.int64), np.array([-2 ** 40, 3, 3, 2 ** 35])])
def test_codebook_bytes_identical(codes):
    r = rhuffman.build_codebook(codes)
    p = huffman.build_codebook(codes)
    assert huffman.serialize_codebook(p) == rhuffman.serialize_codebook(r)
    back = huffman.deserialize_codebook(rhuffman.serialize_codebook(r))
    for k in ("symbols", "lengths", "codes", "first_code", "first_index",
              "count"):
        np.testing.assert_array_equal(getattr(back, k), getattr(r, k))


def test_encode_payloads_bytes_identical():
    rng = np.random.default_rng(7)
    pooled = _codes(3, n=20000)
    cb_r = rhuffman.build_codebook(pooled)
    cb_p = huffman.build_codebook(pooled)
    cuts = np.sort(rng.integers(0, pooled.size, 40))
    streams = np.split(pooled, cuts)        # includes empty streams
    want = rentropy.NumpyEngine().encode_payloads(cb_r, streams)
    assert want == rentropy.BatchedEngine().encode_payloads(cb_r, streams)
    got = entropy.TorchEngine("cpu").encode_payloads(
        cb_p, [torch.from_numpy(s) for s in streams])
    assert got == want
    back = entropy.TorchEngine("cpu").decode_payloads(
        cb_p, got, [s.size for s in streams])
    for b, s in zip(back, streams):
        np.testing.assert_array_equal(b.numpy(), s)


def test_encode_degenerate_and_unknown_symbols():
    eng = entropy.TorchEngine("cpu")
    cb = huffman.build_codebook(np.array([4, 4, 4]))
    assert eng.encode_payloads(cb, [np.array([4, 4]), np.zeros(0, np.int64)]) \
        == rentropy.NumpyEngine().encode_payloads(
            rhuffman.build_codebook(np.array([4, 4, 4])),
            [np.array([4, 4]), np.zeros(0, np.int64)])
    assert eng.encode_payloads(cb, [np.zeros(0, np.int64)]) == [(b"", 0)]
    with pytest.raises(ValueError, match="symbol not in codebook"):
        eng.encode_payloads(cb, [np.array([4, 5])])
    assert eng.decode_payloads(cb, []) == []


def test_code_lengths_price_the_stream():
    codes = _codes(4)
    cb = huffman.build_codebook(codes)
    lens = entropy.code_lengths(cb, torch.from_numpy(codes))
    np.testing.assert_array_equal(lens.numpy(),
                                  rhuffman.code_lengths_for(
                                      rhuffman.build_codebook(codes), codes))
    assert int(lens.sum()) == entropy.encode_stream(cb, codes)[1]


@pytest.mark.parametrize("codes", [
    _codes(5), _codes(6, scale=2000.0), np.array([-9]), np.zeros(0, np.int64),
    np.array([0, 1 << 23, -5, 1 << 23])])      # span past the dense limit
def test_aggregate_histogram_matches(codes):
    want = rshe.aggregate_histogram(codes)
    got = she.aggregate_histogram(torch.from_numpy(codes))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        got[0], np.unique(codes) if codes.size else np.zeros(0))


def test_she_encode_matches_reference():
    rng = np.random.default_rng(8)
    bricks = [rng.normal(0, 4, s).astype(np.float32)
              for s in [(8, 8, 8), (8, 8, 8), (4, 8, 16), (8, 8, 8)]]
    want = rshe.she_encode(bricks, 0.05, lorenzo_engine="numpy")
    got = she.she_encode(bricks, 0.05, device="cpu")
    assert (got.payload_bits, got.codebook_bits, got.meta_bits) == \
        (want.payload_bits, want.codebook_bits, want.meta_bits)
    assert [r.payload_bits for r in got.results] == \
        [r.payload_bits for r in want.results]
    assert huffman.serialize_codebook(got.codebook) == \
        rhuffman.serialize_codebook(want.codebook)
    # the per-block baseline and the per-brick route: exact as well
    for kw in ({"shared": False}, {"batched": False}):
        want = rshe.she_encode(bricks, 0.05, lorenzo_engine="numpy", **kw)
        got = she.she_encode(bricks, 0.05, device="cpu", **kw)
        assert (got.payload_bits, got.codebook_bits, got.meta_bits) == \
            (want.payload_bits, want.codebook_bits, want.meta_bits)
        assert [(r.payload_bits, r.codebook_bits) for r in got.results] == \
            [(r.payload_bits, r.codebook_bits) for r in want.results]
