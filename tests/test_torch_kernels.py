"""The port's kernel plain versions against the reference, on the CPU.

Each kernel of ``repro_torch.kernels`` has a plain PyTorch version that
runs for CPU tensors; here it is held against the JAX package's numpy
host path and its Pallas kernels (interpret mode) on the same inputs,
made from a numpy seed.  All comparisons are exact.  The kernels
themselves run only on a card: ``test_kernels_match_plain_on_card`` is
marked ``cuda`` and skips without one.
"""
import numpy as np
import pytest
import torch

from repro.core import entropy as rentropy
from repro.core import huffman as rhuffman
from repro.core import sz as rsz
from repro.kernels import ops as rops
from repro_torch.core import entropy, huffman
from repro_torch.kernels import ops, ref

RNG = np.random.default_rng(20260)


def _bricks(shape, scale=40.0, seed=0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


@pytest.mark.parametrize("shape,eb", [((3, 8, 8, 8), 0.01), ((2, 5, 7, 9), 0.37),
                                      ((1, 1, 1, 1), 0.1), ((4, 16, 4, 2), 1e-3)])
def test_lorenzo_plain_matches_host_path(shape, eb):
    x = _bricks(shape)
    # half-integer ties of x / 2eb (round half to even must agree)
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5], dtype=np.float64)
    flat = x.reshape(-1)
    k = min(ties.size, flat.size)
    flat[:k] = (ties[:k] * 2.0 * eb).astype(np.float32)
    want = rsz.lorenzo_nd_codes(rsz.prequant(x, eb), axes=(1, 2, 3))
    got = ops.lorenzo3d_codes_batched(torch.from_numpy(x), eb)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    recon = ops.lorenzo3d_recon_batched(got, eb)
    np.testing.assert_array_equal(
        recon.numpy(), rsz.dequant(rsz.lorenzo_nd_recon(want, axes=(1, 2, 3)),
                                   eb))


@pytest.mark.parametrize("shape", [(2, 8, 8, 8), (3, 4, 8, 16)])
def test_lorenzo_plain_matches_pallas_interpret(shape):
    # no ties and |q| < 2^23, with 2eb a power of two: the Pallas body's
    # f32 reciprocal and f32 dequant are then exact too
    eb = 2.0 ** -4
    x = (np.floor(_bricks(shape, 30.0, seed=1) / (2 * eb)) * 2 * eb
         + 0.3 * eb).astype(np.float32)
    codes = ops.lorenzo3d_codes_batched(torch.from_numpy(x), eb)
    pallas = np.asarray(rops.lorenzo3d_codes_batched(
        x, eb=eb, tile=shape[1:], interpret=True))
    np.testing.assert_array_equal(codes.numpy(), pallas)
    recon = ops.lorenzo3d_recon_batched(codes, eb)
    pallas_r = np.asarray(rops.lorenzo3d_recon_batched(
        pallas, eb=eb, tile=shape[1:], interpret=True))
    np.testing.assert_array_equal(recon.numpy(), pallas_r)
    np.testing.assert_array_equal(
        recon.numpy(), rsz.dequant(rsz.lorenzo_nd_recon(
            codes.numpy(), axes=(1, 2, 3)), eb))


@pytest.mark.parametrize("n,lo,hi,n_bins", [(5000, -40, 40, 128),
                                            (20000, 0, 1000, 1024),
                                            (300, -5, 3, 256)])
def test_hist_plain_matches_pallas_and_bincount(n, lo, hi, n_bins):
    codes = RNG.integers(lo, hi, n)
    got = ops.hist(torch.from_numpy(codes), lo, n_bins).numpy()
    np.testing.assert_array_equal(
        got, np.bincount(codes - lo, minlength=n_bins))
    pallas = np.asarray(rops.hist((codes - lo).astype(np.int32), n_bins=n_bins,
                                  interpret=True))
    np.testing.assert_array_equal(got, pallas)


def test_hist_plain_clips_to_escape_bins():
    codes = np.array([-7, -1, 0, 3, 4, 9, 100])
    got = ops.hist(torch.from_numpy(codes), 0, 5).numpy()
    np.testing.assert_array_equal(got, [3, 0, 0, 1, 3])


def _pair(symbols, freqs):
    """The same codebook in both packages."""
    return (rhuffman.build_codebook(symbols=symbols, freqs=freqs),
            huffman.build_codebook(symbols=symbols, freqs=freqs))


def _decode_both(rcb, pcb, triples):
    try:
        want = rentropy.NumpyEngine().decode_payloads(rcb, triples)
        want_err = None
    except ValueError as exc:
        want, want_err = None, str(exc)
    try:
        got = entropy.TorchEngine("cpu").decode_payloads(pcb, triples)
        got_err = None
    except ValueError as exc:
        got, got_err = None, str(exc)
    assert got_err == want_err
    if want is not None:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    return want_err


def _streams(rcb, n_payloads, seed):
    rng = np.random.default_rng(seed)
    streams = [rng.choice(rcb.symbols, size=int(rng.integers(0, 300)),
                          p=None) for _ in range(n_payloads)]
    out = []
    for s in streams:
        packed, nbits = entropy.encode_stream(rcb, s)
        out.append((packed.tobytes(), nbits, s.size))
    return out


def test_huffdec_plain_valid_payloads():
    rcb, pcb = _pair(np.arange(-20, 21), RNG.integers(1, 5000, 41))
    assert _decode_both(rcb, pcb, _streams(rcb, 9, seed=2)) is None


def test_huffdec_plain_prefix_limit():
    rcb, pcb = _pair(np.arange(-6, 7), RNG.integers(1, 900, 13))
    triples = [(b, nb, max(0, nc - 7)) for b, nb, nc in _streams(rcb, 5, 3)]
    assert _decode_both(rcb, pcb, triples) is None


def test_huffdec_plain_truncated_lowest_index_wins():
    rcb, pcb = _pair(np.arange(-20, 21), RNG.integers(1, 5000, 41))
    triples = _streams(rcb, 6, seed=4)
    triples = [t for t in triples if t[2] > 10]
    b, nb, nc = triples[1]
    triples[1] = (b, nb // 3, nc)
    b, nb, nc = triples[3]
    triples[3] = (b[: len(b) // 2], nb, nc)
    assert _decode_both(rcb, pcb, triples) == "truncated bitstream"


def test_huffdec_plain_corrupt_gap():
    # an incomplete (deserialized) codebook: 0 → 5, 10 → -3, 11 is free
    blob = rhuffman.serialize_codebook(rhuffman.Codebook(
        symbols=np.array([5, -3]), lengths=np.array([1, 2]),
        codes=np.array([0, 2])))
    rcb, pcb = rhuffman.deserialize_codebook(blob), \
        huffman.deserialize_codebook(blob)
    ok = (np.packbits([0, 1, 0, 0, 1, 0]).tobytes(), 6, 4)
    corrupt = (np.packbits([0, 1, 1, 0, 0, 0]).tobytes(), 6, 3)
    short = (np.packbits([0, 1]).tobytes(), 2, 2)
    assert _decode_both(rcb, pcb, [ok]) is None
    assert _decode_both(rcb, pcb, [ok, corrupt, short]) == "corrupt bitstream"
    assert _decode_both(rcb, pcb, [ok, short, corrupt]) == \
        "truncated bitstream"
    # gap hit with too few bits left for the oracle's l > maxlen check
    assert _decode_both(rcb, pcb, [(np.packbits([1, 1]).tobytes(), 2, 1)]) \
        == "truncated bitstream"


def test_huffdec_plain_degenerate_codebooks():
    rcb, pcb = _pair(np.array([7]), np.array([10]))
    one = [(b"\x00\x00", 12, 12), (b"", 0, 0), (b"\x00", 3, 3)]
    assert _decode_both(rcb, pcb, one) is None
    assert _decode_both(rcb, pcb, one + [(b"\x00", 5, 9)]) == \
        "truncated bitstream"
    rcb, pcb = _pair(np.zeros(0, np.int64), np.zeros(0, np.int64))
    assert _decode_both(rcb, pcb, [(b"", 0, 0)]) is None
    assert _decode_both(rcb, pcb, [(b"", 0, 0), (b"\x00", 8, 2)]) == \
        "cannot decode symbols with an empty codebook"


def test_huffdec_plain_batch_of_one():
    rcb, pcb = _pair(np.arange(3), np.array([5, 3, 1]))
    assert _decode_both(rcb, pcb, _streams(rcb, 1, seed=7)) is None


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(TypeError):
        ops.lorenzo3d_codes_batched(torch.zeros(1, 2, 2, 2,
                                                dtype=torch.float64), 0.1)
    with pytest.raises(ValueError):
        ops.lorenzo3d_recon_batched(torch.zeros(2, 2, 2, dtype=torch.int64),
                                    0.1)
    with pytest.raises(ValueError):
        ops.hist(torch.zeros(4, dtype=torch.int64)[::2], 0, 4)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    x = torch.from_numpy(_bricks((5, 16, 12, 8))).to(dev)
    codes = ops.lorenzo3d_codes_batched(x, 0.02)
    assert torch.equal(codes, ref.lorenzo3d_codes_batched(x, 0.02))
    assert torch.equal(ops.lorenzo3d_recon_batched(codes, 0.02),
                       ref.lorenzo3d_recon_batched(codes, 0.02))
    flat = codes.reshape(-1)
    lo, hi = (int(v) for v in torch.aminmax(flat))
    assert torch.equal(ops.hist(flat, lo, hi - lo + 1),
                       ref.hist(flat, lo, hi - lo + 1))
    rcb, pcb = _pair(np.arange(-20, 21), RNG.integers(1, 5000, 41))
    args = entropy.TorchEngine(dev).huffdec_args(pcb, _streams(rcb, 9, 5))
    for a, b in zip(ops.huffdec(*args), ref.huffdec(*args)):
        assert torch.equal(a, b)
