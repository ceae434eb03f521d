"""Carry inputs and compressed state across from the reference package.

The tests hand the same dataset, the same compressed state and the same
model parameters to the JAX/numpy reference and to this port.  The
helpers read their inputs duck-typed (attributes and numpy arrays) and
import nothing of the reference package.
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
from .models.layers import ParamSpec
from .models.model import model_specs

__all__ = ["dataset_from_arrays", "result_from_reference",
           "params_from_reference"]


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


def _param(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # an ml_dtypes array
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype)


def params_from_reference(tree, cfg, *,
                          device: str | torch.device = "cuda") -> dict:
    """The port's parameter tree for ``cfg`` from the reference's, given
    as nested dicts of numpy arrays (bf16 leaves as ``ml_dtypes`` arrays
    or as float32), with the stacked-layer axis kept.

    Every leaf takes the dtype of its spec in the port's
    :func:`~repro_torch.models.model.model_specs`, so float32 copies of
    bf16 leaves round back exactly.

    :raises ValueError: for a missing or extra key, or a shape that is
        not the spec's.
    """
    device = resolve_device(device)

    def conv(node, spec, path):
        if isinstance(spec, ParamSpec):
            t = _param(node, spec.torch_dtype, device)
            if tuple(t.shape) != spec.shape:
                raise ValueError(f"{path}: shape {tuple(t.shape)}, "
                                 f"expected {spec.shape}")
            return t
        if not isinstance(node, dict) or set(node) != set(spec):
            keys = sorted(node) if isinstance(node, dict) else type(node)
            raise ValueError(f"{path or 'params'}: keys {keys}, "
                             f"expected {sorted(spec)}")
        return {k: conv(v, spec[k], f"{path}/{k}") for k, v in node.items()}

    return conv(tree, model_specs(cfg), "")
