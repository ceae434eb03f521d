"""Batched serving engine: prefill, then iterative decode with a bf16 or
int8 KV cache.

:func:`make_prefill_step` and :func:`make_serve_step` are the units of
the reference's engine; :class:`ServingEngine` runs them in a batched
loop (greedy or sampled from an explicit ``torch.Generator``).  The
reference's region-serving ``AsyncServingCore`` is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import ModelConfig, RunConfig
from ..device import resolve_device
from ..models.model import check_ported, forward
from .kv_cache import quantize_prefill_cache

__all__ = ["make_prefill_step", "make_serve_step", "ServingEngine"]


def make_prefill_step(cfg: ModelConfig, run: RunConfig, *,
                      q_chunk: int = 512, kv_chunk: int = 1024):
    """``prefill(params, batch) -> (last-token logits, state)``.

    ``batch["tokens"]``: (B, P) ids.  With ``run.kv_quant`` the bf16
    cache stack is quantized to int8 (kernel 7, one launch per K or V
    stack)."""
    def prefill(params, batch):
        logits, aux = forward(params, cfg, tokens=batch["tokens"],
                              mode="prefill", q_chunk=q_chunk,
                              kv_chunk=kv_chunk)
        state = aux["state"]
        if run.kv_quant:
            state = quantize_prefill_cache(cfg, state)
        return logits[:, -1], state

    return prefill


def make_serve_step(cfg: ModelConfig, run: RunConfig, *,
                    kv_chunk: int = 1024):
    """``serve(params, state, batch, cache_len) -> (logits, state)``: one
    decode step of ``batch["tokens"]`` (B, 1) at position ``cache_len``,
    writing its K/V into ``state`` in place."""
    def serve(params, state, batch, cache_len):
        logits, aux = forward(params, cfg, tokens=batch["tokens"],
                              mode="decode", state=state,
                              cache_len=cache_len, q_chunk=1,
                              kv_chunk=kv_chunk)
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

    def prefill(self, params: dict, prompts, capacity: int
                ) -> tuple[torch.Tensor, dict]:
        """Last-token logits of ``prompts`` (B, P) and their cache, grown
        to ``capacity`` positions."""
        tokens = torch.as_tensor(prompts, device=self.device).long()
        logits, state = self._prefill(params, {"tokens": tokens})
        return logits, grow_cache(state, capacity - tokens.shape[1],
                                  self.cfg)

    def decode(self, params: dict, state: dict, tok: torch.Tensor,
               cache_len: int) -> tuple[torch.Tensor, dict]:
        """Logits of one new token per sequence, ``tok`` (B,), at
        position ``cache_len``."""
        return self._decode(params, state, {"tokens": tok[:, None]},
                            cache_len)

    def generate(self, params: dict, prompts, *, new_tokens: int,
                 greedy: bool = True,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """prompts: (B, P) token ids (tensor or array).  Returns
        (B, new_tokens) int64 ids: greedy, or sampled from the softmax of
        the logits with ``generator`` when ``greedy=False``.  As in the
        reference, the loop runs ``new_tokens`` decode steps, the last of
        which only fills the cache."""
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
