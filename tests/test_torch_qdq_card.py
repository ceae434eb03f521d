"""Kernel 7 and the fused decode-step cache write on the card, against
their plain versions.

Imports no JAX, so that it runs on the card's machine (``pytest
--noconftest -m cuda``); the plain versions are held against the
reference in ``test_torch_qdq.py`` and ``test_torch_lm_serving.py``.
Every test here needs a CUDA device and skips without one.  All
comparisons are exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _values(rows: int, d: int, group: int, seed: int) -> torch.Tensor:
    """float32 (rows, d): normal values, an all-zero group, a group of
    exact .5 ties (max 127·2⁻³, scale 2⁻³) and one next to the ties of
    an inexact scale (max 1, scale 1/127)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, d)) * 3).astype(np.float32)
    x[0, :group] = 0.0
    if rows > 1:
        x[1, :group] = (rng.integers(-127, 127, group) + 0.5) * 2.0 ** -3
        x[1, 0] = 127 * 2.0 ** -3
    if rows > 2:
        x[2, :group] = ((rng.integers(-127, 127, group) + 0.5) / 127.0)
        x[2, 0] = 1.0
    return torch.from_numpy(x)


def _warp_route(x: torch.Tensor, group: int):
    """Kernel 7 on its warp route only (one warp per group), through its C
    entry: the kernel 7 of earlier builds."""
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((x.shape[0], x.shape[1] // group), dtype=torch.float32,
                    device=x.device)
    fn = "group_quant_warp_f32" if x.dtype == torch.float32 else \
        "group_quant_warp_bf16"
    rc = getattr(build.library("qdq"), fn)(
        ops._ptr(x), ops._ptr(q), ops._ptr(s), s.numel(), group,
        ops._stream(x))
    assert rc == 0
    return q, s


# (rows, d, group): groups of 64, 128 and 256, tile-route widths 8…512,
# group counts that are no multiple of a warp's tile (32 / L groups),
# launches large enough for 16 values a lane (groups of 128 and 256), and
# widths the warp route takes
SHAPES = [(1000, 128, 128), (37, 256, 64), (37, 192, 64), (513, 512, 256),
          (77, 1024, 256), (20001, 128, 128), (9001, 256, 256),
          (5, 512, 512), (33, 48, 16), (9, 64, 8), (7, 96, 32),
          (31, 96, 48), (3, 384, 96), (1, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,group", SHAPES)
def test_group_quant_kernel_matches_plain(rows, d, group):
    dev = _card()
    x = _values(rows, d, group, rows + d)
    for xt in (x.to(dev), x.to(dev, torch.bfloat16)):
        q, s = ops.group_quant(xt, group)
        q_p, s_p = ref.group_quant(xt, group)
        assert torch.equal(q, q_p) and torch.equal(s, s_p)
        q_w, s_w = _warp_route(xt, group)
        assert torch.equal(q_w, q_p) and torch.equal(s_w, s_p)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_quant_kernel_on_misaligned_views(dtype):
    dev = _card()
    for group, off in ((128, 1), (64, 2), (256, 3)):
        flat = _values(1, 40 * group + off, group, off).reshape(-1)
        view = flat.to(dev, dtype)[off:].reshape(40, group)
        assert view.data_ptr() % 16
        q, s = ops.group_quant(view, group)
        q_p, s_p = ref.group_quant(view, group)
        assert torch.equal(q, q_p) and torch.equal(s, s_p)
    torch.cuda.synchronize()


def _cache(lead, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return {n: torch.randint(-127, 128, lead, generator=g, device=dev,
                             dtype=torch.int8) if n in ("k", "v") else
            torch.rand(lead[:-1], generator=g, device=dev)
            for n in ("k", "v", "k_scale", "v_scale")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [128, 64, 48])
def test_fused_kv_write_matches_composed_route_on_card(dtype, hd):
    """One launch per call, equal to two plain ``group_quant`` calls and
    slice copies; on a layer of a stacked cache the others stay as they
    were.  hd = 48 takes the warp route."""
    dev = _card()
    L, B, S, H = 3, 4, 40, 8
    for sq, start in ((1, 0), (1, 17), (3, 17), (1, S - 1), (3, S - 3)):
        k = _values(B * sq * H, hd, hd, sq + start).reshape(B, sq, H, hd)
        v = _values(B * sq * H, hd, hd, 7 + start).reshape(B, sq, H, hd)
        k, v = k.to(dev, dtype), v.to(dev, dtype)
        got = _cache((L, B, S, H, hd), start, dev)
        want = {n: t.clone() for n, t in got.items()}
        before = ops.launches["group_quant"]
        ops.quantize_kv_into(k, v, {n: t[1] for n, t in got.items()}, start)
        assert ops.launches["group_quant"] == before + 1
        ref.quantize_kv_into(k, v, {n: t[1] for n, t in want.items()}, start)
        for name in got:
            assert torch.equal(got[name], want[name]), (name, sq, start)
    torch.cuda.synchronize()
