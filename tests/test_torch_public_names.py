"""The reference's public names that the port's modules carry, held to
the reference on the CPU.

* ``configs.base.ModelConfig.attention_free`` / ``supports_long_context``
  for every architecture of the reference's registry;
* ``core.huffman``: ``Codebook.encoder_map``, ``encoded_size_bits``,
  ``code_lengths_for``, ``encode`` and ``decode`` on the inputs of
  ``tests/test_huffman_edges.py`` and ``tests/test_entropy.py``, errors
  included;
* ``core.entropy``: ``EntropyEngine`` and its three named engines,
  ``get_engine`` and ``check_engine_name``; each of the four names on
  ``device="cpu"`` packs the reference's engines' bytes and decodes their
  arrays, and raises the serial oracle's error on the batches of
  ``tests/test_entropy.py``;
* ``core.sz.SZResult.compression_ratio``;
* ``core.opst.merge_subblocks``, ``core.blocks.subblocks_tile_exactly``
  (on the random grids of ``tests/test_partition.py``) and
  ``core.compat.zstd_module``;
* ``serving.engine``'s re-exports of ``AsyncServingCore`` and
  ``ServerBusy`` (the reference's engine carries them beside its LM
  steps).

The reference is imported inside the test bodies only.
"""
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import akdtree, blocks, compat, entropy, huffman, opst
from repro_torch.core.sz import SZResult

ENGINES = ["numpy", "batched", "pallas", "auto"]


def _outcome(fn, *args, **kw):
    """Result-or-error fingerprint, comparable across packages."""
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as exc:
        return ("err", str(exc))


def _same(a, b) -> None:
    assert a[0] == b[0], (a, b)
    if a[0] == "err":
        assert a[1] == b[1]
        return
    assert len(a[1]) == len(b[1])
    for x, y in zip(a[1], b[1]):
        if isinstance(x, tuple):
            assert x == y
        else:
            y = y.numpy() if isinstance(y, torch.Tensor) else y
            np.testing.assert_array_equal(x, y)
            assert np.asarray(y).dtype == np.int64


def _codebooks(data):
    """(reference codebook, port codebook) built from the same stream."""
    from repro.core import huffman as rh

    return rh.build_codebook(data), huffman.build_codebook(data)


# ---------------------------------------------------------------- configs


def test_config_properties_match_reference():
    from repro.configs import ARCH_IDS, get_config

    families = set()
    for arch in ARCH_IDS:
        ref = get_config(arch)
        cfg = ModelConfig(**asdict(ref))
        assert cfg.attention_free == ref.attention_free, arch
        assert cfg.supports_long_context == ref.supports_long_context, arch
        families.add((ref.family, ref.attention_free,
                      ref.supports_long_context))
    # the registry has an attention-free, a long-context and a plain family
    assert {(f, a, s) for f, a, s in families if a or s} == {
        ("ssm", True, True), ("hybrid", False, True)}


# ---------------------------------------------------------------- huffman


STREAMS = {
    "empty": np.zeros(0, dtype=np.int64),
    "single": np.full(11, -7, dtype=np.int64),
    "small": np.random.default_rng(0).integers(-5, 6, size=200),
    "wide": np.random.default_rng(5).integers(-50, 51, size=700),
    "many": np.random.default_rng(17).integers(-9, 10, size=2500),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_huffman_names_match_reference(name):
    from repro.core import huffman as rh

    data = STREAMS[name]
    rcb, cb = _codebooks(data)
    assert cb.encoder_map() == rcb.encoder_map()
    assert cb.encoder_map() is cb.encoder_map()          # cached
    packed, nbits = huffman.encode(cb, data)
    rpacked, rnbits = rh.encode(rcb, data)
    assert nbits == rnbits and packed.tobytes() == rpacked.tobytes()
    assert packed.dtype == rpacked.dtype == np.uint8
    idx = huffman.symbol_indices(cb, data) if data.size else None
    assert huffman.encode(cb, data, indices=idx)[1] == nbits
    np.testing.assert_array_equal(huffman.code_lengths_for(cb, data),
                                  rh.code_lengths_for(rcb, data))
    assert huffman.code_lengths_for(cb, data).dtype == np.int64
    assert huffman.encoded_size_bits(cb, data=data) == \
        rh.encoded_size_bits(rcb, data=data) == nbits
    symbols, freqs = np.unique(data, return_counts=True)
    assert huffman.encoded_size_bits(cb, symbols=symbols, freqs=freqs) == \
        rh.encoded_size_bits(rcb, symbols=symbols, freqs=freqs) == nbits
    assert huffman.encoded_size_bits(cb, symbols=np.zeros(0, np.int64),
                                     freqs=np.zeros(0, np.int64)) == 0
    out = huffman.decode(cb, packed, nbits, data.size)
    np.testing.assert_array_equal(out, rh.decode(rcb, rpacked, rnbits,
                                                 data.size))
    np.testing.assert_array_equal(out, data)


@pytest.mark.parametrize("n_unique", [1, 2, 17, 300])
def test_encoded_size_bits_matches_reference(n_unique):
    from repro.core import huffman as rh

    rng = np.random.default_rng(n_unique)
    data = rng.integers(0, n_unique, size=1000) * 3 - 7
    rcb, cb = _codebooks(data)
    s, f = np.unique(data, return_counts=True)
    assert huffman.encoded_size_bits(cb, data=data) == \
        rh.encoded_size_bits(rcb, data=data)
    assert huffman.encoded_size_bits(cb, symbols=s, freqs=f) == \
        rh.encoded_size_bits(rcb, symbols=s, freqs=f)


def test_huffman_errors_match_reference():
    """The error cases of ``tests/test_huffman_edges.py``: the same
    ``ValueError`` text from both packages."""
    from repro.core import huffman as rh

    rcb, cb = _codebooks(np.zeros(0, dtype=np.int64))
    cases = [((rcb, cb), (np.zeros(0, np.uint8), 0, 3))]
    data = np.full(16, 5, dtype=np.int64)
    rcb, cb = _codebooks(data)
    packed, nbits = rh.encode(rcb, data)
    cases.append(((rcb, cb), (packed, nbits - 9, 16)))
    data = STREAMS["small"]
    rcb, cb = _codebooks(data)
    packed, nbits = rh.encode(rcb, data)
    cases += [((rcb, cb), (packed[:len(packed) // 2], nbits, 200)),
              ((rcb, cb), (np.zeros(0, np.uint8), 0, 200))]
    for (rcb, cb), args in cases:
        want = _outcome(lambda: [rh.decode(rcb, *args)])
        assert want[0] == "err"
        _same(want, _outcome(lambda: [huffman.decode(cb, *args)]))
    for fn in (lambda c, d: huffman.code_lengths_for(c, d),
               lambda c, d: huffman.encode(c, d),
               lambda c, d: huffman.encoded_size_bits(c, d)):
        with pytest.raises(ValueError, match="symbol not in codebook"):
            fn(cb, np.array([1000]))
    with pytest.raises(ValueError, match="symbol not in codebook"):
        rh.code_lengths_for(rcb, np.array([1000]))


# ---------------------------------------------------------------- engines


def _batch(pkg, seed, n_payloads, max_codes, spread=40):
    """``tests/test_entropy.py``'s ``_batch``: a shared codebook over
    mixed-size payloads, built by ``pkg``'s ``build_codebook``."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, max_codes + 1, size=n_payloads)
    pool = rng.integers(-spread, spread + 1, size=int(sizes.sum()) + 1)
    cb = pkg.build_codebook(pool)
    splits = np.cumsum(sizes)[:-1]
    return cb, [p.astype(np.int64) for p in np.split(pool[:-1], splits)]


def test_engine_registry():
    from repro.core import entropy as re

    for name in ("numpy", "batched", "pallas"):
        eng = entropy.get_engine(name, device="cpu")
        assert eng.name == re.get_engine(name).name == name
        assert isinstance(eng, entropy.TorchEngine)
        assert isinstance(eng, entropy.EntropyEngine)
        assert eng.device == torch.device("cpu")
        assert entropy.get_engine(eng) is eng            # passthrough
        assert entropy.get_engine(name, device="cpu") is eng   # cached
        entropy.check_engine_name(eng)
    assert entropy.get_engine("auto", device="cpu") is entropy.get_engine(
        "pallas", device="cpu")
    assert [entropy.NumpyEngine, entropy.BatchedEngine,
            entropy.PallasEngine] == [
        type(entropy.get_engine(n, device="cpu"))
        for n in ("numpy", "batched", "pallas")]
    for fn, rfn in ((lambda: entropy.get_engine("cuda", device="cpu"),
                     lambda: re.get_engine("cuda")),
                    (lambda: entropy.check_engine_name("cuda"),
                     lambda: re.check_engine_name("cuda"))):
        want = _outcome(rfn)
        assert want[0] == "err"
        assert _outcome(fn) == want
    entropy.check_engine_name("auto")
    re.check_engine_name(re.get_engine("numpy"))
    base = entropy.EntropyEngine()
    assert base.name == re.EntropyEngine.name == "abstract"
    cb = huffman.build_codebook(np.arange(3))
    with pytest.raises(NotImplementedError):
        base.encode_payloads(cb, [])
    with pytest.raises(NotImplementedError):
        base.decode_payloads(cb, [])


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed,n_payloads,max_codes", [
    (0, 1, 50), (1, 6, 300), (2, 25, 80)])
def test_engines_match_reference(engine, seed, n_payloads, max_codes):
    """Each name's engine on the CPU packs the bytes of the reference's
    engine of that name and decodes its arrays."""
    from repro.core import entropy as re
    from repro.core import huffman as rh

    rcb, codes = _batch(rh, seed, n_payloads, max_codes)
    cb, _ = _batch(huffman, seed, n_payloads, max_codes)
    eng, ref = entropy.get_engine(engine, device="cpu"), re.get_engine(engine)
    enc = eng.encode_payloads(cb, codes)
    assert enc == ref.encode_payloads(rcb, codes)
    payloads = [(b, nb, c.size) for (b, nb), c in zip(enc, codes)]
    _same(_outcome(ref.decode_payloads, rcb, payloads),
          _outcome(eng.decode_payloads, cb, payloads))
    pairs = [(b, nb) for b, nb, _ in payloads]
    n_codes = [c.size for c in codes]
    _same(_outcome(ref.decode_payloads, rcb, pairs, n_codes),
          _outcome(eng.decode_payloads, cb, pairs, n_codes))


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_edges_match_reference(engine):
    """Empty batches and streams, a single-symbol codebook, and an empty
    codebook asked for symbols."""
    from repro.core import entropy as re
    from repro.core import huffman as rh

    eng, ref = entropy.get_engine(engine, device="cpu"), re.get_engine(engine)
    rcb, cb = rh.build_codebook(np.arange(5)), huffman.build_codebook(
        np.arange(5))
    assert eng.encode_payloads(cb, []) == ref.encode_payloads(rcb, []) == []
    assert eng.decode_payloads(cb, []) == []
    empty = [np.zeros(0, np.int64)] * 6
    assert eng.encode_payloads(cb, empty) == ref.encode_payloads(rcb, empty)
    _same(_outcome(ref.decode_payloads, rcb, [(b"", 0, 0)] * 6),
          _outcome(eng.decode_payloads, cb, [(b"", 0, 0)] * 6))
    data = np.full(9, 3, dtype=np.int64)
    rcb, cb = _codebooks(data)
    enc = eng.encode_payloads(cb, [data])
    assert enc == ref.encode_payloads(rcb, [data]) and enc[0][1] == 9
    _same(_outcome(ref.decode_payloads, rcb, [(enc[0][0], 9, 9)]),
          _outcome(eng.decode_payloads, cb, [(enc[0][0], 9, 9)]))
    rcb, cb = _codebooks(np.zeros(0, dtype=np.int64))
    for batch in ([(b"", 0, 0)] * 5, [(b"", 0, 0), (b"\x00", 3, 2)]):
        _same(_outcome(ref.decode_payloads, rcb, batch),
              _outcome(eng.decode_payloads, cb, batch))


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_errors_match_reference(engine):
    """The error batches of ``tests/test_entropy.py`` (truncations, random
    buffers, an incomplete code): the serial oracle's outcome, error text
    included."""
    from repro.core import entropy as re
    from repro.core import huffman as rh

    eng, oracle = entropy.get_engine(engine, device="cpu"), \
        re.get_engine("numpy")
    rcb, codes = _batch(rh, 7, 8, 120)
    cb, _ = _batch(huffman, 7, 8, 120)
    enc = oracle.encode_payloads(rcb, codes)
    payloads = [(b, nb, c.size) for (b, nb), c in zip(enc, codes)]
    batches = [(rcb, cb, payloads)]
    for victim in (0, 3, len(payloads) - 1):
        for cut in (1, 7, 13):
            broken = list(payloads)
            blob, nbits, n = broken[victim]
            if nbits > cut:
                broken[victim] = (blob, nbits - cut, n)
                batches.append((rcb, cb, broken))
    rng = np.random.default_rng(11)
    pool = rng.integers(-30, 31, size=4000)
    rcb_g, cb_g = _codebooks(pool)
    for _ in range(20):
        batch = []
        for _ in range(int(rng.integers(4, 10))):
            buf = rng.integers(0, 256, size=int(rng.integers(0, 40)),
                               dtype=np.uint8).tobytes()
            nbits = int(rng.integers(0, 8 * max(len(buf), 1) + 8))
            batch.append((buf, nbits, int(rng.integers(0, 60))))
        batches.append((rcb_g, cb_g, batch))
    rcb_i = rh._canonicalize(np.array([1, 2, 3]), np.array([2, 2, 2]))
    cb_i = huffman._canonicalize(np.array([1, 2, 3]), np.array([2, 2, 2]))
    for case in ((bytes([0b11000000]), 8, 4), (bytes([0b11000000]), 2, 1),
                 (bytes([0b00011011]), 8, 4)):
        batches.append((rcb_i, cb_i, [case]))
        batches.append((rcb_i, cb_i, [(bytes([0b00011011]), 8, 4), case] * 3))
    kinds = set()
    for rcb_b, cb_b, batch in batches:
        want = _outcome(oracle.decode_payloads, rcb_b, batch)
        kinds.add(want[1] if want[0] == "err" else "ok")
        _same(want, _outcome(eng.decode_payloads, cb_b, batch))
    assert {"ok", "truncated bitstream", "corrupt bitstream"} <= kinds


def test_she_wrappers_take_every_engine():
    """``she.encode/decode_brick_payloads`` through ``get_engine``: every
    name and an engine instance give the same bytes and codes."""
    from repro_torch.core import she

    cb, codes = _batch(huffman, 9, 10, 150)
    want = she.encode_brick_payloads(cb, codes, engine="numpy", device="cpu")
    for engine in ENGINES + [entropy.get_engine("batched", device="cpu")]:
        enc = she.encode_brick_payloads(cb, codes, engine=engine,
                                        device="cpu")
        assert enc == want
        payloads = [(b, nb, c.size) for (b, nb), c in zip(enc, codes)]
        for got, c in zip(she.decode_brick_payloads(
                cb, payloads, engine=engine, device="cpu"), codes):
            np.testing.assert_array_equal(got.numpy(), c)
    with pytest.raises(ValueError, match="unknown entropy engine"):
        she.encode_brick_payloads(cb, codes, engine="cuda", device="cpu")


# ------------------------------------------------------------------- sz


def test_compression_ratio_matches_reference():
    from repro.core.sz import SZResult as RSZ

    recon = np.zeros((4, 5, 6), np.float32)
    for bits in ((0, 0, 0), (100, 40, 96), (12345, 0, 7)):
        ref = RSZ(recon=recon, codes=np.zeros(0, np.int64),
                  payload_bits=bits[0], codebook_bits=bits[1],
                  meta_bits=bits[2], eb=1e-3, method="x")
        got = SZResult(recon=torch.from_numpy(recon),
                       codes=torch.zeros(0, dtype=torch.int64),
                       payload_bits=bits[0], codebook_bits=bits[1],
                       meta_bits=bits[2], eb=1e-3, method="x")
        for kw in ({}, {"n_values": 77}, {"dtype_bits": 64},
                   {"n_values": 3, "dtype_bits": 16}):
            assert got.compression_ratio(**kw) == ref.compression_ratio(**kw)
            assert isinstance(got.compression_ratio(**kw), float)


# ------------------------------------------------------ partition helpers


def _grids(seed, bshape=(6, 6, 6), unit=4, density=0.4):
    """``tests/test_partition.py``'s ``_random_grid`` in both packages."""
    from repro.core import blocks as rblocks

    rng = np.random.default_rng(seed)
    occ = rng.random(bshape) < density
    data = np.zeros(tuple(b * unit for b in bshape), np.float32)
    mask = np.repeat(np.repeat(np.repeat(occ, unit, 0), unit, 1), unit, 2)
    data[mask] = rng.standard_normal(int(mask.sum())).astype(np.float32) + 5.0
    return (rblocks.make_block_grid(data, mask, unit=unit),
            blocks.make_block_grid(data, mask, unit=unit))


def _port_sbs(sbs):
    return [blocks.SubBlock(origin=tuple(sb.origin), bsize=tuple(sb.bsize))
            for sb in sbs]


@pytest.mark.parametrize("seed,density,bshape", [
    (0, 0.05, (6, 6, 6)), (1, 0.4, (6, 6, 6)), (2, 0.95, (6, 6, 6)),
    (3, 0.5, (3, 12, 5)), (4, 0.7, (5, 5, 5))])
def test_partition_helpers_match_reference(seed, density, bshape):
    """``subblocks_tile_exactly`` on OpST and AKDTree partitions, and on
    partitions with a sub-block dropped or doubled; ``merge_subblocks``'
    stacks."""
    from repro.core import akdtree as rak
    from repro.core import blocks as rblocks
    from repro.core import opst as ropst

    rgrid, grid = _grids(seed, bshape=bshape, density=density)
    for rpart, part in ((ropst.opst_partition, opst.opst_partition),
                        (rak.akdtree_partition, akdtree.akdtree_partition)):
        rsbs, sbs = rpart(rgrid), part(grid)
        assert [(s.origin, s.bsize) for s in sbs] == \
            [(s.origin, s.bsize) for s in rsbs]
        variants = [sbs]
        if sbs:
            variants += [sbs[1:], sbs + sbs[:1]]
        for v in variants:
            rv = [rblocks.SubBlock(origin=s.origin, bsize=s.bsize) for s in v]
            assert blocks.subblocks_tile_exactly(grid, v) == \
                rblocks.subblocks_tile_exactly(rgrid, rv)
        assert blocks.subblocks_tile_exactly(grid, sbs)
        if sbs:
            assert not blocks.subblocks_tile_exactly(grid, sbs[1:])
            assert not blocks.subblocks_tile_exactly(grid, sbs + sbs[:1])
        got = opst.merge_subblocks(grid, _port_sbs(rsbs))
        want = ropst.merge_subblocks(rgrid, rsbs)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_zstd_module_matches_reference():
    from repro.core import compat as rcompat

    assert compat.zstd_module() is rcompat.zstd_module()
    assert (compat.zstd_module() is None) == (not compat.HAVE_ZSTD)


# ---------------------------------------------------------------- serving


def test_engine_reexports_serving_core():
    from repro.serving import engine as rengine

    from repro_torch.serving import core, engine

    assert engine.AsyncServingCore is core.AsyncServingCore
    assert engine.ServerBusy is core.ServerBusy
    for name in ("AsyncServingCore", "ServerBusy"):
        assert name in engine.__all__ and name in rengine.__all__
    assert set(rengine.__all__) <= set(engine.__all__)
