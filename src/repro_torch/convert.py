"""Carry inputs and compressed state across from the reference package.

The tests hand the same dataset, and the same compressed state, to the
JAX/numpy reference and to this port.  Both helpers read their inputs
duck-typed (attributes and numpy arrays) and import nothing of the
reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.amr import AMRDataset, AMRLevel
from .core.blocks import SubBlock
from .core.huffman import Codebook
from .core.hybrid import AMRCompressionResult, LevelArtifacts, LevelResult
from .core.sz import SZResult
from .device import resolve_device

__all__ = ["dataset_from_arrays", "result_from_reference"]


def dataset_from_arrays(levels, *, name: str = "amr") -> AMRDataset:
    """The port's dataset from ``(data, mask, ratio)`` triples, finest
    level first."""
    return AMRDataset(levels=[
        AMRLevel(data=np.asarray(d, dtype=np.float32),
                 mask=np.asarray(m, dtype=bool), ratio=int(r))
        for d, m, r in levels], name=name)


def _codebook(cb) -> Codebook | None:
    if cb is None:
        return None
    return Codebook(**{k: np.asarray(getattr(cb, k), dtype=np.int64)
                       for k in ("symbols", "lengths", "codes", "first_code",
                                 "first_index", "count")})


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _sz_result(r, device: torch.device) -> SZResult:
    extras = {}
    branch = (r.extras or {}).get("branch")
    if branch is not None:
        extras["branch"] = branch
    if branch == "reg":
        extras["betas"] = _tensor(np.asarray(r.extras["betas"],
                                             dtype=np.float32), device)
    ent = (r.extras or {}).get("entropy")
    if ent is not None:
        extras["entropy"] = {"codebook": _codebook(ent["codebook"]),
                             "packed": bytes(ent["packed"]),
                             "nbits": int(ent["nbits"])}
    return SZResult(recon=_tensor(np.asarray(r.recon, dtype=np.float32),
                                  device),
                    codes=_tensor(np.asarray(r.codes, dtype=np.int64)
                                  .ravel(), device),
                    payload_bits=int(r.payload_bits),
                    codebook_bits=int(r.codebook_bits),
                    meta_bits=int(r.meta_bits), eb=float(r.eb),
                    method=str(r.method), extras=extras)


def result_from_reference(res, *, device: str | torch.device = "cuda",
                          ) -> AMRCompressionResult:
    """The port's ``AMRCompressionResult`` from the reference's: strategy,
    sub-blocks, codes, branches, betas, codebook, the packed payload of
    gsp/global levels and recon, with arrays moved to ``device``."""
    device = resolve_device(device)
    levels = []
    for lr in res.levels:
        art = None
        if lr.artifacts is not None:
            a = lr.artifacts
            art = LevelArtifacts(
                mask=np.asarray(a.mask, dtype=bool),
                orig_shape=tuple(int(s) for s in a.orig_shape),
                grid_shape=tuple(int(s) for s in a.grid_shape),
                unit=int(a.unit), sz_block=int(a.sz_block),
                subblocks=[SubBlock(origin=tuple(int(o) for o in sb.origin),
                                    bsize=tuple(int(s) for s in sb.bsize))
                           for sb in a.subblocks],
                results=[_sz_result(r, device) for r in a.results],
                codebook=_codebook(a.codebook))
        levels.append(LevelResult(
            strategy=str(lr.strategy), algorithm=str(lr.algorithm),
            she=bool(lr.she), payload_bits=int(lr.payload_bits),
            codebook_bits=int(lr.codebook_bits),
            meta_bits=int(lr.meta_bits),
            recon=_tensor(np.asarray(lr.recon, dtype=np.float32), device),
            n_values=int(lr.n_values), density=float(lr.density),
            eb=float(lr.eb), n_subblocks=int(lr.n_subblocks),
            ratio=int(lr.ratio), artifacts=art))
    return AMRCompressionResult(levels=levels, method=str(res.method))
