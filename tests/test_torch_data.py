"""The port's data streams (``repro_torch.data``) against the reference's
(``repro.data.pipeline``), on the CPU.

Every stream draws from the same ``np.random.SeedSequence`` as the
reference, so its tensors are the reference's arrays bit for bit: int32
tokens and labels, float32 embeddings, for seeds 0 and 3, hosts 0 of 1
and 0/1 of 2, over the first three steps.  The AMR stream's codes come
from the port's ``core.sz`` on the stream's device (``prequant`` divides
by a device scalar); the ``cuda`` test holds them on the card to the
numpy host path's.  The reference's quirk is kept: a host's rows are
drawn from its own seed, not sliced from the one-host batch.  The
streams read only ``shape.global_batch`` and ``shape.seq_len``.

The reference is imported inside the CPU tests' bodies.
"""
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.data import amr_token_batches, embedding_batches, lm_batches
from repro_torch.data import pipeline as tpipe

SHAPE = SimpleNamespace(global_batch=4, seq_len=32)
#: stream → the smoke arch whose config it is given
STREAMS = {"lm_batches": "deepseek_7b", "embedding_batches": "musicgen_medium",
           "amr_token_batches": "deepseek_7b"}
HOSTS = [(0, 1), (0, 2), (1, 2)]
DTYPES = {"tokens": np.int32, "labels": np.int32, "embeds": np.float32}


def _first(stream, n: int = 3) -> list:
    return list(itertools.islice(stream, n))


@pytest.mark.parametrize("host_id, n_hosts", HOSTS)
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", list(STREAMS))
def test_streams_match_reference(name, seed, host_id, n_hosts):
    from repro.configs import smoke_config as r_smoke
    from repro.data import pipeline as rpipe

    arch = STREAMS[name]
    kw = dict(seed=seed, host_id=host_id, n_hosts=n_hosts)
    want = _first(getattr(rpipe, name)(r_smoke(arch), SHAPE, **kw))
    got = _first(getattr(tpipe, name)(smoke_config(arch), SHAPE, device="cpu",
                                      **kw))
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            arr = g[k].numpy()
            assert arr.dtype == w[k].dtype == DTYPES[k], k
            assert arr.shape == w[k].shape, k
            np.testing.assert_array_equal(arr, w[k])
    # the steps differ from one another
    key = "embeds" if name == "embedding_batches" else "tokens"
    assert not torch.equal(got[0][key], got[1][key])


def test_host_rows_are_their_own_draws():
    """As in the reference, ``_host_slice``'s start goes unused: host 0 of
    2 draws its rows from ``SeedSequence([seed, step, 0])`` with half the
    rows, which are not the first half of the one-host batch."""
    cfg = smoke_config("deepseek_7b")
    whole = next(lm_batches(cfg, SHAPE, seed=3, device="cpu"))
    half = next(lm_batches(cfg, SHAPE, seed=3, host_id=0, n_hosts=2,
                           device="cpu"))
    assert tpipe._host_slice(4, 1, 2) == (2, 2)
    assert half["tokens"].shape == (2, SHAPE.seq_len)
    assert not torch.equal(half["tokens"], whole["tokens"][:2])
    rng = np.random.default_rng(np.random.SeedSequence([3, 0, 0]))
    base = rng.zipf(1.5, size=(2, 1)).clip(max=cfg.vocab_size - 1)
    drift = rng.integers(-8, 9, size=(2, SHAPE.seq_len)).cumsum(axis=1)
    np.testing.assert_array_equal(
        half["tokens"].numpy(), ((base + np.abs(drift)) % cfg.vocab_size))


def test_data_pipeline_deterministic_and_elastic():
    """The reference's ``test_data_pipeline_deterministic_and_elastic``."""
    cfg = smoke_config("deepseek_7b")
    b1 = next(lm_batches(cfg, SHAPE, seed=3, device="cpu"))
    b2 = next(lm_batches(cfg, SHAPE, seed=3, device="cpu"))
    assert torch.equal(b1["tokens"], b2["tokens"])
    half = next(lm_batches(cfg, SHAPE, seed=3, host_id=0, n_hosts=2,
                           device="cpu"))
    assert half["tokens"].shape[0] == SHAPE.global_batch // 2
    # labels are the next tokens, the last one masked
    assert torch.equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    assert bool((b1["labels"][:, -1] == -1).all())


def test_amr_token_pipeline_bridges_planes():
    """The reference's ``test_amr_token_pipeline_bridges_planes``."""
    cfg = smoke_config("deepseek_7b")
    b = next(amr_token_batches(cfg, SHAPE, device="cpu"))
    assert b["tokens"].shape == (4, 32)
    assert bool((b["tokens"] >= 0).all())
    assert bool((b["tokens"] < cfg.vocab_size).all())
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_embedding_stream_shapes():
    cfg = smoke_config("musicgen_medium")
    b = next(embedding_batches(cfg, SHAPE, device="cpu"))
    assert b["embeds"].shape == (4, 32, cfg.d_model)
    assert b["embeds"].dtype == torch.float32
    assert bool((b["labels"][:, -1] == -1).all())


def test_streams_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = smoke_config("deepseek_7b")
    for stream in (lm_batches, embedding_batches, amr_token_batches):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(stream(cfg, SHAPE))


@pytest.mark.cuda
def test_amr_stream_on_card_equals_host_path():
    """The AMR stream's codes computed on the card (``prequant`` dividing
    by a device scalar) equal the CPU's, which equal the numpy host
    path's (:func:`test_streams_match_reference`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cfg = smoke_config("deepseek_7b")
    for seed in (0, 3):
        for eb_rel in (1e-3, 1e-4):
            host = _first(amr_token_batches(cfg, SHAPE, seed=seed,
                                            eb_rel=eb_rel, device="cpu"))
            card = _first(amr_token_batches(cfg, SHAPE, seed=seed,
                                            eb_rel=eb_rel, device="cuda"))
            for h, c in zip(host, card):
                for k in h:
                    assert c[k].device.type == "cuda"
                    assert torch.equal(h[k], c[k].cpu()), (seed, eb_rel, k)
