"""Deterministic, host-sharded synthetic data pipeline.

Every host computes its own shard of every global batch from
``(seed, step, host_id)`` alone — no coordination, bit-reproducible across
restarts (resuming at step k regenerates exactly the batches a failed run
saw), and elastic (re-sharding by ``n_hosts`` is a pure index change).

Streams:
  * :func:`lm_batches` — Zipf-distributed token sequences with a Markov
    bigram structure (so the loss actually falls during the examples).
  * :func:`embedding_batches` — frame/patch embedding stand-ins for the
    stub-frontend archs (vlm/audio).
  * :func:`amr_token_batches` — Plane A ↔ Plane B bridge: tokens are
    quantization codes of a synthetic AMR field (the paper's data feeding
    the framework's model).

Each stream draws from the same ``np.random.SeedSequence`` as
``repro.data.pipeline`` and yields its arrays bit for bit (int32 tokens
and labels, float32 embeddings), as tensors on ``device``.  The streams
read only ``shape.global_batch`` and ``shape.seq_len``.  As in the
reference, a host's rows are drawn from its own seed: :func:`_host_slice`
gives each host its row count, and its start goes unused.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["lm_batches", "embedding_batches", "amr_token_batches"]


def _host_slice(global_batch: int, host_id: int, n_hosts: int):
    per = global_batch // n_hosts
    return host_id * per, per


def lm_batches(cfg, shape, *, seed: int = 0, host_id: int = 0,
               n_hosts: int = 1, device: str | torch.device = "cuda"):
    """Infinite {tokens, labels} iterator; labels are next-token ids."""
    device = resolve_device(device)
    start, per = _host_slice(shape.global_batch, host_id, n_hosts)
    V = cfg.vocab_size
    S = shape.seq_len
    step = 0
    while True:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, host_id]))
        # Markov structure: tokens drift within a band + Zipf jumps
        base = rng.zipf(1.5, size=(per, 1)).clip(max=V - 1)
        drift = rng.integers(-8, 9, size=(per, S)).cumsum(axis=1)
        toks = ((base + np.abs(drift)) % V).astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((per, 1), -1, np.int32)], axis=1)
        yield {"tokens": torch.from_numpy(toks).to(device),
               "labels": torch.from_numpy(labels).to(device)}
        step += 1


def embedding_batches(cfg, shape, *, seed: int = 0, host_id: int = 0,
                      n_hosts: int = 1, device: str | torch.device = "cuda"):
    """{embeds, labels} for input_mode='embeddings' archs (stub frontend)."""
    device = resolve_device(device)
    start, per = _host_slice(shape.global_batch, host_id, n_hosts)
    S, d, V = shape.seq_len, cfg.d_model, cfg.vocab_size
    step = 0
    while True:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, host_id, 1]))
        emb = rng.standard_normal((per, S, d)).astype(np.float32) * 0.02
        labels = rng.integers(0, V, size=(per, S)).astype(np.int32)
        labels[:, -1] = -1
        yield {"embeds": torch.from_numpy(emb).to(device),
               "labels": torch.from_numpy(labels).to(device)}
        step += 1


def amr_token_batches(cfg, shape, *, seed: int = 0, host_id: int = 0,
                      n_hosts: int = 1, eb_rel: float = 1e-3,
                      device: str | torch.device = "cuda"):
    """Tokens = clipped Lorenzo quantization codes of a synthetic AMR field.

    Bridges the planes: the LM learns the code statistics the paper's
    Huffman stage exploits.  Codes are offset/clipped into [0, vocab).
    The field is made on the host; its codes are computed on ``device``
    (``prequant`` divides by a device scalar, so they equal the numpy
    host path's)."""
    from ..core import amr as amr_mod
    from ..core import sz

    device = resolve_device(device)
    start, per = _host_slice(shape.global_batch, host_id, n_hosts)
    V, S = cfg.vocab_size, shape.seq_len
    step = 0
    while True:
        ds = amr_mod.synthetic_amr((32, 32, 32), densities=[0.3, 0.7],
                                   refine_block=4,
                                   seed=seed + 31 * step + host_id)
        field = ds.levels[0].data
        eb = eb_rel * float(field.max() - field.min() + 1e-9)
        codes = sz.lorenzo_nd_codes(sz.prequant(
            torch.from_numpy(field).to(device), eb)).reshape(-1)
        toks_all = torch.clamp(codes + V // 2, 0, V - 1).to(torch.int32)
        need = per * (S + 1)
        reps = -(-need // toks_all.numel())
        toks = toks_all.repeat(reps)[:need].reshape(per, S + 1)
        yield {"tokens": toks[:, :-1].contiguous(),
               "labels": toks[:, 1:].contiguous()}
        step += 1
