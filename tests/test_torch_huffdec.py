"""Kernel 4 (chunked Huffman decode): chunk plan, adversarial cases.

The CPU tests check the chunk plan the wrapper computes on the host's
side of the launch, and hold the plain decoder against the reference's
serial oracle ``repro.core.entropy.decode_stream`` and, where the
codebook fits its 30-bit windows, against the Pallas window kernel and
walk in interpret mode, on the seeded adversarial cases of
``repro_torch.kernels.huffdec_cases``.  The ``cuda``-marked tests hold the
CUDA kernel (chunked, and its serial walk forced) against the plain
decoder on the same cases; they skip without a card, and import nothing
of the reference, so that they run where JAX is not installed
(``pytest --noconftest -m cuda``).  Every comparison is exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import huffman
from repro_torch.core.entropy import TorchEngine, encode_stream
from repro_torch.kernels import huffdec_cases, ops, ref

CHUNK = 64
CASES = {name: (cb, pays) for name, cb, pays in huffdec_cases.cases(CHUNK)}
KINDS = {"truncated bitstream": 1, "corrupt bitstream": 2,
         "cannot decode symbols with an empty codebook": 3}


def _args(cb, pays, device="cpu"):
    return TorchEngine(device).huffdec_args(cb, pays)


@pytest.mark.parametrize("nbits,chunk,first,pay,bit", [
    # empty, sub-chunk, exact one chunk, exact two, one bit over
    ([0, 10, 64, 128, 65], 64, [0, 0, 1, 2, 4, 6],
     [1, 2, 3, 3, 4, 4], [0, 0, 0, 64, 0, 64]),
    ([0, 0], 64, [0, 0, 0], [], []),
    ([200], 100, [0, 2], [0, 0], [0, 100]),
])
def test_chunk_plan(nbits, chunk, first, pay, bit):
    nb = torch.tensor(nbits, dtype=torch.int64)
    n_bytes = sum(-(-n // 8) for n in nbits)
    pay_first, chunk_pay, chunk_bit = ops.huffdec_plan(nb, n_bytes, chunk)
    assert pay_first.tolist() == first
    n = first[-1]
    # cap: one spare chunk per payload plus the buffer's bits in chunks
    assert chunk_pay.numel() == len(nbits) + -(-8 * n_bytes // chunk)
    assert chunk_pay[:n].tolist() == pay
    assert chunk_bit[:n].tolist() == bit
    assert (chunk_pay[n:] == len(nbits)).all()


def test_chunk_plan_holds_every_chunk_of_a_level():
    rng = np.random.default_rng(3)
    nbits = rng.integers(0, 5000, 200)
    n_bytes = int(sum(-(-n // 8) for n in nbits))
    for chunk in (64, 128, 256, 512, 1024, 100):
        pay_first, chunk_pay, chunk_bit = ops.huffdec_plan(
            torch.from_numpy(nbits), n_bytes, chunk)
        counts = np.diff(pay_first.numpy())
        np.testing.assert_array_equal(counts, -(-nbits // chunk))
        assert pay_first[-1] <= chunk_pay.numel()
        for a in (0, 7, 199):
            cs = slice(int(pay_first[a]), int(pay_first[a + 1]))
            assert (chunk_pay[cs] == a).all()
            np.testing.assert_array_equal(
                chunk_bit[cs].numpy(), np.arange(counts[a]) * chunk)


def test_chunk_plan_rejects_bad_size():
    with pytest.raises(ValueError):
        ops.huffdec_plan(torch.zeros(1, dtype=torch.int64), 1, 0)
    with pytest.raises(ValueError):
        huffdec_cases.cases(96)


def _oracle(cb, pays):
    """Per payload: the reference oracle's symbols (None on error) and
    its error kind."""
    from repro.core import entropy as rentropy
    from repro.core import huffman as rhuffman

    rcb = rhuffman.deserialize_codebook(huffman.serialize_codebook(cb))
    outs, errs = [], []
    for buf, nb, nd in pays:
        try:
            outs.append(rentropy.decode_stream(
                rcb, np.frombuffer(buf, np.uint8), nb, nd))
            errs.append(0)
        except ValueError as exc:
            outs.append(None)
            errs.append(KINDS[str(exc)])
    return rcb, outs, errs


def _pallas(rcb, pays):
    """The reference's Pallas windows + walk in interpret mode: (symbols
    per payload, error kinds)."""
    from repro.core import entropy as rentropy
    from repro.kernels import huffdec as rhuffdec
    from repro.kernels import ops as rops

    triples = [(np.frombuffer(b, np.uint8), nb, nd) for b, nb, nd in pays]
    ls, uppers, maxlen = rentropy._decode_tables(rcb)
    bits, nbits_arr = rentropy._bit_matrix(triples, maxlen, pad=1)
    width = int(nbits_arr.max(initial=0)) + 1
    wm = rops.huffdec_windows(bits, maxlen=maxlen, width=width)
    nds = np.array([nd for _, _, nd in triples], dtype=np.int64)
    sidx, err = rhuffdec.decode_walk(
        wm, nbits_arr.astype(np.int32), nds.astype(np.int32),
        uppers.astype(np.int32), ls.astype(np.int32),
        rcb.first_code.astype(np.int32), rcb.first_index.astype(np.int32),
        maxlen=maxlen, steps=int(nds.max()))
    sidx = np.asarray(sidx)
    return ([rcb.symbols[sidx[a, :nd]] for a, nd in enumerate(nds)],
            np.asarray(err).tolist())


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_oracle_on_adversarial_case(name):
    cb, pays = CASES[name]
    args = _args(cb, pays)
    out, err = ops.huffdec(*args)
    rcb, want, want_err = _oracle(cb, pays)
    assert err.tolist() == want_err
    offs = args[4].tolist()
    for w, e, off, (_, _, nd) in zip(want, want_err, offs, pays):
        if e == 0:
            np.testing.assert_array_equal(out[off:off + nd].numpy(), w)
    if rcb.max_length > 30:
        return                      # past the Pallas windows' int32
    got, got_err = _pallas(rcb, pays)
    assert got_err == want_err
    for g, w, e in zip(got, want, want_err):
        if e == 0:
            np.testing.assert_array_equal(g, w)


def test_adversarial_cases_cover_their_spots():
    _, _, errs = _oracle(*CASES["gap_past_first_chunk"])
    assert errs == [2, 0, 1, 0]
    _, _, errs = _oracle(*CASES["truncated_at_chunk_boundary"])
    assert errs == [1, 1, 0, 0]
    assert CASES["depth_57_straddling"][0].max_length == 57
    nbits = [nb for _, nb, _ in CASES["short_and_empty"][1]]
    assert min(nbits) < CHUNK - 1 < CHUNK < max(nbits)
    limits = [nd for _, _, nd in CASES["prefix_limits"][1]]
    assert len(set(limits)) == len(limits) and limits[0] > 3 * CHUNK // 2


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [64, 128, 512, 1024])
def test_kernel_matches_plain_on_adversarial_cases(chunk):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for name, cb, pays in huffdec_cases.cases(chunk, seed=chunk):
        args = _args(cb, pays, "cuda")
        want = ref.huffdec(*args)
        for kw in ({"chunk_bits": chunk}, {"serial": True}):
            got = ops.huffdec(*args, **kw)
            assert torch.equal(got[0], want[0]), (name, kw)
            assert torch.equal(got[1], want[1]), (name, kw)
        if name == "fixed_length_never_syncs":
            ops.huffdec(*args, chunk_bits=chunk)
            assert int(ops.huffdec_stats[2]) == 1


@pytest.mark.cuda
def test_kernel_settles_a_huffman_source_without_serial_walk():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(5)
    symbols = np.arange(-40, 41)
    freqs = np.round(1e6 * np.exp(-np.abs(symbols) / 4.0)).astype(np.int64) + 1
    cb = huffman.build_codebook(symbols=symbols, freqs=freqs)
    pays = []
    for n in rng.integers(0, 40000, 30):
        s = rng.choice(symbols, size=int(n), p=freqs / freqs.sum())
        packed, nb = encode_stream(cb, s)
        pays.append((packed.tobytes(), nb, int(n)))
    args = _args(cb, pays, "cuda")
    out, err = ops.huffdec(*args)
    assert int(ops.huffdec_stats[2]) == 0
    want = ref.huffdec(*args)
    assert torch.equal(out, want[0]) and torch.equal(err, want[1])
