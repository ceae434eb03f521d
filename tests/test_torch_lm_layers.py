"""The LM plane's layers against the reference, on the CPU.

Each function runs on the same numpy inputs through ``repro.models`` and
``repro_torch.models``.  Tolerances, by what can differ:

* float32 in and out: the two frameworks' float32 kernels (``rsqrt``,
  ``pow``/``cos``, matmul summation order) differ in the last bits, so
  results agree to a relative 1e-5 (attention and MLP, whose sums run
  over up to 256 terms) or 1e-6 (elementwise layers);
* bf16 activations: each rounding to bf16 may fall one bf16 step
  (2⁻⁸ relative) apart where the float32 values before it differ in the
  last bit, so single roundings agree to 2⁻⁷ relative and whole blocks
  to the 1e-2 relative max error of the reference's own decode-vs-train
  test (``tests/test_models.py``).
"""
from dataclasses import replace

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as r_smoke
from repro.models import attention as ratt
from repro.models import layers as rlay
from repro.models import moe as rmoe
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tlay
from repro_torch.models import moe as tmoe

DT = {"float32": (np.float32, torch.float32, jnp.float32),
      "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}


def _arr(shape, seed, dtype="float32", scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return x.astype(np.float32).astype(DT[dtype][0])


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_linear(dtype):
    x = _arr((3, 5, 64), 1, dtype, 2.0)
    gamma = _arr((64,), 2, dtype)
    w = _arr((64, 48), 3, dtype, 0.2)
    b = _arr((48,), 4, dtype)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    got = tlay.rmsnorm(_t(x), _t(gamma))
    want = rlay.rmsnorm(jnp.asarray(x), jnp.asarray(gamma))
    assert got.dtype == DT[dtype][1]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    got = tlay.linear(_t(x), _t(w), _t(b))
    want = rlay.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    assert _rel(want, got) <= (1e-6 if dtype == "float32" else 2 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope(dtype, theta):
    pos = np.arange(3, 40, dtype=np.int32)
    cos, sin = tlay.rope_freqs(torch.from_numpy(pos), 32, theta)
    rcos, rsin = rlay.rope_freqs(jnp.asarray(pos), 32, theta)
    np.testing.assert_allclose(cos.numpy(), _np(rcos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), _np(rsin), rtol=0, atol=1e-6)
    x = _arr((2, pos.size, 4, 32), 5, dtype)
    got = tlay.apply_rope(_t(x), cos, sin)
    want = rlay.apply_rope(jnp.asarray(x), rcos, rsin)
    assert got.dtype == DT[dtype][1]
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["deepseek_7b", "starcoder2_3b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(arch, dtype):
    """SwiGLU (deepseek) and tanh-GELU (starcoder2) blocks."""
    cfg = replace(r_smoke(arch), dtype=dtype)
    specs = rmoe.mlp_specs(cfg)
    params = {k: _arr(s.shape, i + 10, dtype,
                      1.0 if s.init == "ones" else s.shape[0] ** -0.5)
              for i, (k, s) in enumerate(sorted(specs.items()))}
    x = _arr((2, 6, cfg.d_model), 9, dtype, 3.0)
    want = rmoe.mlp_apply({k: jnp.asarray(v) for k, v in params.items()},
                          jnp.asarray(x), cfg)
    got = tmoe.mlp_apply({k: _t(v) for k, v in params.items()}, _t(x), cfg)
    assert set(tmoe.mlp_specs(cfg)) == set(specs)
    assert _rel(want, got) <= (1e-5 if dtype == "float32" else 1e-2)


def _qkv(B, Sq, Sk, H, Hkv, D, dtype, seed):
    return (_arr((B, Sq, H, D), seed, dtype, 2.0),
            _arr((B, Sk, Hkv, D), seed + 1, dtype, 2.0),
            _arr((B, Sk, Hkv, D), seed + 2, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,q_chunk,kv_chunk,Hkv", [
    (24, 512, 1024, 4),      # one block: the smoke tests' prefill
    (40, 16, 8, 2),          # triangular schedule, ragged chunks, GQA
    (33, 8, 16, 1)])         # more kv than q per chunk, MQA
def test_flash_attention_prefill(dtype, S, q_chunk, kv_chunk, Hkv):
    q, k, v = _qkv(2, S, S, 4, Hkv, 32, dtype, S)
    want = ratt.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, q_chunk=q_chunk,
                                kv_chunk=kv_chunk)
    got = tatt.flash_attention(_t(q), _t(k), _t(v), causal=True,
                               q_chunk=q_chunk, kv_chunk=kv_chunk)
    assert got.shape == q.shape and got.dtype == DT[dtype][1]
    assert _rel(want, got) <= (1e-5 if dtype == "float32" else 1e-2)


def test_flash_attention_offset_valid_len_and_int8():
    """A query block at an offset against a partly valid K/V, plain and
    int8: the reference dequantizes the int8 K/V per chunk inside its
    loop, the port attends the K/V that ``dequantize_heads`` (kernel 8)
    gives back."""
    q, k, v = _qkv(2, 5, 30, 4, 2, 32, "float32", 7)
    kq_r, ks_r = ratt._quantize_heads(jnp.asarray(k))
    vq_r, vs_r = ratt._quantize_heads(jnp.asarray(v))
    kq, ks = tatt.quantize_heads(_t(k))
    vq, vs = tatt.quantize_heads(_t(v))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(kq_r))
    np.testing.assert_array_equal(vs.numpy(), np.asarray(vs_r))
    for scales in (False, True):
        kw_r = dict(k_scale=ks_r, v_scale=vs_r) if scales else {}
        want = ratt.flash_attention(
            jnp.asarray(q), kq_r if scales else jnp.asarray(k),
            vq_r if scales else jnp.asarray(v), causal=True, q_offset=20,
            kv_valid_len=25, q_chunk=4, kv_chunk=8, **kw_r)
        kt = (tatt.dequantize_heads(kq, ks, torch.float32) if scales
              else _t(k))
        vt = (tatt.dequantize_heads(vq, vs, torch.float32) if scales
              else _t(v))
        got = tatt.flash_attention(_t(q), kt, vt, causal=True, q_offset=20,
                                   kv_valid_len=25, q_chunk=4, kv_chunk=8)
        assert _rel(want, got) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True])
def test_decode_attention(dtype, quantized):
    """One new query (and two) against a cache of which 19 of 26 entries
    are valid, bf16 or int8 (scores scaled by k_scale, p · v_scale in
    float32)."""
    for Sq in (1, 2):
        q, k, v = _qkv(3, Sq, 26, 4, 2, 32, dtype, 11 + Sq)
        k = k.astype(ml_dtypes.bfloat16)
        v = v.astype(ml_dtypes.bfloat16)
        kw_r, kw = {}, {}
        kr, vr, kt, vt = jnp.asarray(k), jnp.asarray(v), _t(k), _t(v)
        if quantized:
            kr, ks_r = ratt._quantize_heads(kr)
            vr, vs_r = ratt._quantize_heads(vr)
            kt, ks = tatt.quantize_heads(kt)
            vt, vs = tatt.quantize_heads(vt)
            np.testing.assert_array_equal(kt.numpy(), np.asarray(kr))
            kw_r = dict(k_scale=ks_r, v_scale=vs_r)
            kw = dict(k_scale=ks, v_scale=vs)
        want = ratt.decode_attention(jnp.asarray(q), kr, vr, valid_len=19,
                                     **kw_r)
        got = tatt.decode_attention(_t(q), kt, vt, valid_len=19, **kw)
        assert got.shape == q.shape and got.dtype == DT[dtype][1]
        assert _rel(want, got) <= (1e-5 if dtype == "float32" else 1e-2)


def test_attention_specs_and_cache_layout():
    for arch in ("deepseek_7b", "starcoder2_3b", "llama3_405b"):
        cfg = r_smoke(arch)
        r_specs, t_specs = ratt.attn_specs(cfg), tatt.attn_specs(cfg)
        assert {k: (s.shape, s.dtype, s.init) for k, s in r_specs.items()} \
            == {k: (s.shape, s.dtype, s.init) for k, s in t_specs.items()}
        for quantized in (False, True):
            r_c = ratt.init_kv_cache(cfg, 2, 9, quantized=quantized)
            t_c = tatt.init_kv_cache(cfg, 2, 9, device=torch.device("cpu"),
                                     quantized=quantized)
            assert {k: (a.shape, str(a.dtype)) for k, a in r_c.items()} == {
                k: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
                for k, a in t_c.items()}
