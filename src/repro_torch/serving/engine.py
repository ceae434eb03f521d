"""Batched serving engine: prefill, then iterative decode with a bf16 or
int8 KV cache.

:func:`make_prefill_step` and :func:`make_serve_step` are the units of
the reference's engine; :class:`ServingEngine` runs them in a batched
loop (greedy or sampled from an explicit ``torch.Generator``).  An
embedding-input architecture (internvl2-76b, musicgen-medium) is served
through ``prefill`` and ``decode`` with ``embeds=``: its frontend is the
caller's, so ``generate``, which would have to map a sampled token back
to an embedding, raises.

The region-serving counterpart — :class:`AsyncServingCore`, the bounded
worker-pool execution front with 429/503 admission control the HTTP
region endpoint runs on — is re-exported here from
:mod:`repro_torch.serving.core`, as the reference's engine does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import ModelConfig, RunConfig
from ..device import resolve_device
from ..models.model import check_ported, forward, input_key
from .core import AsyncServingCore, ServerBusy
from .kv_cache import quantize_prefill_cache

__all__ = ["AsyncServingCore", "ServerBusy", "make_prefill_step",
           "make_serve_step", "ServingEngine"]


def make_prefill_step(cfg: ModelConfig, run: RunConfig, *,
                      q_chunk: int = 512, kv_chunk: int = 1024):
    """``prefill(params, batch) -> (last-token logits, state)``.

    ``batch["tokens"]``: (B, P) ids, or ``batch["embeds"]``: (B, P,
    d_model) for an embedding-input config.  With ``run.kv_quant`` the
    bf16 cache stack is quantized to int8 (kernel 7, one launch per K or
    V stack)."""
    key = input_key(cfg)

    def prefill(params, batch):
        logits, aux = forward(params, cfg, mode="prefill", q_chunk=q_chunk,
                              kv_chunk=kv_chunk, **{key: batch[key]})
        state = aux["state"]
        if run.kv_quant:
            state = quantize_prefill_cache(cfg, state)
        return logits[:, -1], state

    return prefill


def make_serve_step(cfg: ModelConfig, run: RunConfig, *,
                    kv_chunk: int = 1024):
    """``serve(params, state, batch, cache_len) -> (logits, state)``: one
    decode step of ``batch["tokens"]`` (B, 1) — or ``batch["embeds"]``
    (B, 1, d_model) — at position ``cache_len``, writing its K/V into
    ``state`` in place."""
    key = input_key(cfg)

    def serve(params, state, batch, cache_len):
        logits, aux = forward(params, cfg, mode="decode", state=state,
                              cache_len=cache_len, q_chunk=1,
                              kv_chunk=kv_chunk, **{key: batch[key]})
        return logits[:, -1], aux["state"]

    return serve


def _grow_kv(kv: dict, extra: int) -> dict:
    out = {}
    for name, a in kv.items():
        g = a.new_zeros(a.shape[:2] + (a.shape[2] + extra,) + a.shape[3:])
        g[:, :, :a.shape[2]] = a
        out[name] = g
    return out


def grow_cache(state: dict, extra: int, cfg: ModelConfig) -> dict:
    """The serve-time state with its KV cache's seq axis (index 2 of every
    cache leaf: k/v ``(L, B, S, H, hd)``, scales ``(L, B, S, H)``) padded
    by ``extra`` zero entries.  An ssm state has no cache and comes back
    as it is; a hybrid's ``kv`` half grows and its ``mamba`` half is kept.
    """
    if extra <= 0 or cfg.family == "ssm":
        return state
    if cfg.family == "hybrid":
        return {"mamba": state["mamba"], "kv": _grow_kv(state["kv"], extra)}
    return _grow_kv(state, extra)


@dataclass
class ServingEngine:
    """Minimal batched generation loop over the prefill and serve steps,
    on ``device`` (default ``"cuda"``; raises there without a card)."""

    cfg: ModelConfig
    run: RunConfig
    device: str | torch.device = "cuda"

    def __post_init__(self):
        check_ported(self.cfg)
        self.device = resolve_device(self.device)
        self._prefill = make_prefill_step(self.cfg, self.run)
        self._decode = make_serve_step(self.cfg, self.run)

    def prefill(self, params: dict, prompts=None, capacity: int | None = None,
                *, embeds=None) -> tuple[torch.Tensor, dict]:
        """Last-position logits of ``prompts`` (B, P) ids — or of
        ``embeds`` (B, P, d_model) for an embedding-input config — and
        their cache, grown to ``capacity`` positions."""
        if capacity is None:
            raise TypeError("prefill needs the cache's capacity")
        batch = self._batch(prompts, embeds, 2)
        logits, state = self._prefill(params, batch)
        P = next(iter(batch.values())).shape[1]
        return logits, grow_cache(state, capacity - P, self.cfg)

    def decode(self, params: dict, state: dict, tok: torch.Tensor | None = None,
               cache_len: int | None = None, *, embeds=None
               ) -> tuple[torch.Tensor, dict]:
        """Logits of one new position per sequence at ``cache_len``: the
        token ``tok`` (B,), or the embedding ``embeds`` (B, d_model) for
        an embedding-input config."""
        if cache_len is None:
            raise TypeError("decode needs cache_len")
        if tok is not None:
            tok = torch.as_tensor(tok, device=self.device)[:, None]
        if embeds is not None:
            embeds = torch.as_tensor(embeds, device=self.device)[:, None]
        return self._decode(params, state, self._batch(tok, embeds, 2),
                            cache_len)

    def _batch(self, tokens, embeds, ndim: int) -> dict:
        """The step's batch: ``tokens`` (``ndim`` axes) or ``embeds``
        (one more), whichever the config takes, on the engine's device."""
        key = input_key(self.cfg)
        if key == "tokens":
            if tokens is None or embeds is not None:
                raise ValueError(f"{self.cfg.name} takes token ids")
            t = torch.as_tensor(tokens, device=self.device).long()
            want = ndim
        else:
            if embeds is None or tokens is not None:
                raise ValueError(f"{self.cfg.name} takes frontend "
                                 "embeddings: pass embeds=")
            t = torch.as_tensor(embeds, device=self.device)
            want = ndim + 1
        if t.dim() != want:
            raise ValueError(f"{key}: {t.dim()} axes, expected {want}")
        return {key: t}

    def generate(self, params: dict, prompts, *, new_tokens: int,
                 greedy: bool = True,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """prompts: (B, P) token ids (tensor or array).  Returns
        (B, new_tokens) int64 ids: greedy, or sampled from the softmax of
        the logits with ``generator`` when ``greedy=False``.  As in the
        reference, the loop runs ``new_tokens`` decode steps, the last of
        which only fills the cache.

        :raises ValueError: for an embedding-input config: there is no
            map from a sampled token back to a frontend embedding (nor in
            the reference); run ``prefill`` and ``decode`` with
            ``embeds=`` instead.
        """
        if input_key(self.cfg) != "tokens":
            raise ValueError(
                f"{self.cfg.name} takes frontend embeddings, and generate "
                "has no map from a sampled token to an embedding: call "
                "prefill(params, embeds=..., capacity=...) and "
                "decode(params, state, embeds=..., cache_len=...)")
        B, P = prompts.shape
        logits, state = self.prefill(params, prompts, P + new_tokens)
        outs = []
        tok = torch.argmax(logits, dim=-1)
        for i in range(new_tokens):
            outs.append(tok)
            logits, state = self.decode(params, state, tok, P + i)
            if greedy or generator is None:
                tok = torch.argmax(logits, dim=-1)
            else:
                probs = torch.softmax(logits.float(), dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return torch.stack(outs, dim=1)
