"""Kernels 7/8 (per-group int8 quantize/dequantize) against the reference.

The plain versions of the port (``device="cpu"``) are held against the
JAX package's oracles (``repro.kernels.ref``), its KV-cache conversions
(``repro.serving.kv_cache``) and its gradient-compression leaf quantizer
(``repro.optim.grad_compress``) on the same numpy inputs, exactly:
codes, scales and dequantized values, with ties at .5 built on purpose
and all-zero groups.  Against its Pallas kernels in interpret mode
(``repro.kernels.ops``) the comparison is exact too, with one divergence
inside the reference stated and checked: under ``jax.jit`` XLA computes
the scale ``amax / 127`` as ``amax · float32(1/127)``, one ulp away from
the oracle's division in a few percent of the groups; there the scale
is checked against that rule and the codes are compared where the
scales agree.  The fused decode-step write (``ops.quantize_kv_into``)
runs its plain version here, held against the composed route and the
reference's eager decode write.  The CUDA kernels run only on a card:
``test_qdq_kernels_match_plain_on_card`` (and, without JAX,
``test_torch_qdq_card.py``) is marked ``cuda`` and skips without one.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.optim import grad_compress as rgc
from repro.serving import kv_cache as rkv
from repro_torch.kernels import ops, ref
from repro_torch.serving import kv_cache as tkv

CASES = [((256, 512), 128), ((512, 256), 128), ((64, 128), 64),
         ((256, 1024), 256), ((256, 64), 32)]


def _x(shape, seed, scale=3.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return x.astype(np.float32)


def _ties(rows: int, group: int) -> np.ndarray:
    """Groups whose quotients x / scale land on or next to .5.

    Even rows: max 127 · 2⁻³, so the scale 2⁻³ is exact and every
    quotient k + 0.5 is an exact tie (half to even must agree).  Odd
    rows: max 1, so the scale 1/127 is inexact and the quotients of
    (k + 0.5)/127 fall next to the ties, where a division and a product
    with the reciprocal can round apart.
    """
    rng = np.random.default_rng(7)
    x = np.empty((rows, group), np.float32)
    for r in range(rows):
        k = rng.integers(-127, 127, group) + 0.5
        if r % 2 == 0:
            x[r] = k * 2.0 ** -3
            x[r, 0] = 127 * 2.0 ** -3
        else:
            x[r] = (k / 127.0).astype(np.float32)
            x[r, 0] = 1.0
    return x


def _plain(x: np.ndarray, group: int):
    q, s = ops.group_quant(torch.from_numpy(x), group)
    return q.numpy(), s.numpy()


def _jit_scale(x: np.ndarray, group: int) -> np.ndarray:
    """The scale the reference's jitted code computes: XLA rewrites
    ``amax / 127.0`` into ``amax * float32(1/127)``."""
    amax = np.abs(x.astype(np.float32)).reshape(
        x.shape[0], -1, group).max(axis=-1)
    return np.where(amax > 0, amax * (np.float32(1) / np.float32(127)),
                    np.float32(1)).astype(np.float32)


def _assert_quant_equal(x: np.ndarray, group: int):
    """The plain kernel 7/8 against the reference's oracles (exact) and
    its Pallas kernels (exact wherever the jitted scale equals the
    oracle's; see ``test_pallas_scale_is_jit_reciprocal``)."""
    q, s = _plain(x, group)
    q_r, s_r = rref.group_quant_ref(jnp.asarray(x), group)
    np.testing.assert_array_equal(q, np.asarray(q_r))
    np.testing.assert_array_equal(s, np.asarray(s_r))
    d = ops.group_dequant(torch.from_numpy(q), torch.from_numpy(s),
                          group).numpy()
    np.testing.assert_array_equal(
        d, np.asarray(rref.group_dequant_ref(q_r, s_r, group)))
    _assert_pallas_equal(x, group, q, s)
    return q, s, d


def _assert_pallas_equal(x, group, q, s):
    q_k, s_k = (np.array(a) for a in
                rops.group_quant(jnp.asarray(x), group=group))
    np.testing.assert_array_equal(s_k, _jit_scale(x, group))
    same = np.repeat(s_k == s, group, axis=1)
    np.testing.assert_array_equal(q[same], q_k[same])
    # kernel 8 on the Pallas kernel's own codes and scales
    d = ops.group_dequant(torch.from_numpy(q_k), torch.from_numpy(s_k),
                          group).numpy()
    np.testing.assert_array_equal(
        d, np.asarray(rops.group_dequant(q_k, s_k, group=group)))


@pytest.mark.parametrize("shape,group", CASES)
def test_group_quant_matches_reference(shape, group):
    x = _x(shape, hash((shape, group)) % 2**31)
    q, s, d = _assert_quant_equal(x, group)
    # the quantization error bound of the reference's own test
    bound = np.repeat(s, group, axis=1) * 0.5 + 1e-7
    assert (np.abs(d - x) <= bound).all()
    assert q.dtype == np.int8 and s.dtype == np.float32


@pytest.mark.parametrize("group", [32, 128, 256])
def test_group_quant_ties_and_zero_groups(group):
    x = _ties(256, group)
    x[3] = 0.0                                  # an all-zero group
    x[5, : group // 2] = 0.0
    q, s, d = _assert_quant_equal(x, group)
    assert s[3, 0] == 1.0 and not q[3].any() and not d[3].any()
    even = np.arange(0, 256, 2)
    assert (s[even, 0] == 2.0 ** -3).all()
    # exact ties of the even rows round half to even
    want = np.round(x[even] / 2.0 ** -3)
    np.testing.assert_array_equal(q[even].astype(np.float64), want)


@pytest.mark.parametrize("group", [64, 128])
def test_group_quant_bf16_input(group):
    """A bf16 input quantizes as its float32 values, as the Pallas kernel
    (which casts to float32 first) does."""
    xb = _x((256, 256), 11).astype(ml_dtypes.bfloat16)
    xt = torch.from_numpy(xb.view(np.uint16).copy()).view(torch.bfloat16)
    q, s = ops.group_quant(xt, group)
    x32 = xb.astype(np.float32)
    q_r, s_r = rref.group_quant_ref(jnp.asarray(x32), group)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
    np.testing.assert_array_equal(q.numpy(), _plain(x32, group)[0])
    _assert_pallas_equal(xb, group, q.numpy(), s.numpy())


def test_pallas_scale_is_jit_reciprocal():
    """The one divergence inside the reference: under ``jax.jit`` XLA
    turns ``amax / 127.0`` into a product with float32(1/127), so the
    Pallas kernel (and every jitted caller) rounds some scales one ulp
    away from the eager oracle, whose true division the port keeps."""
    x = _x((256, 512), 3)
    q, s = _plain(x, 128)
    q_k, s_k = (np.asarray(a) for a in rops.group_quant(jnp.asarray(x)))
    differ = s_k != s
    assert differ.any() and not differ.all()
    np.testing.assert_array_equal(
        np.abs(s_k.view(np.int32) - s.view(np.int32))[differ], 1)
    np.testing.assert_array_equal(s, np.asarray(
        rref.group_quant_ref(jnp.asarray(x), 128)[1]))


def test_group_quant_checks_shapes():
    with pytest.raises(ValueError):
        ops.group_quant(torch.zeros(4, 100), 64)
    with pytest.raises(ValueError):
        ops.group_quant(torch.zeros(4, 2, 64), 64)
    with pytest.raises(TypeError):
        ops.group_quant(torch.zeros(4, 64, dtype=torch.float64), 64)
    with pytest.raises(ValueError):
        ops.group_dequant(torch.zeros(4, 128, dtype=torch.int8),
                          torch.ones(4, 1), 64)
    # any number of rows: the TPU kernel's n % row_tile rule is not kept
    q, s = ops.group_quant(torch.ones(5, 64), 32)
    assert q.shape == (5, 64) and s.shape == (5, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_cache_conversions_match_reference(dtype):
    """quantize_kv / dequantize_kv / quantize_prefill_cache of the port
    equal the reference's on the same (L, B, S, H, hd) stack."""
    from repro_torch.configs import smoke_config

    shape = (2, 3, 7, 4, 32)
    k = _x(shape, 1, scale=2.0)
    v = _x(shape, 2, scale=2.0)
    k[0, 1, 2, 3] = 0.0                         # an all-zero head vector
    if dtype == "bfloat16":
        kn, vn = k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
        to_t = (lambda a: torch.from_numpy(a.view(np.uint16).copy())
                .view(torch.bfloat16))
    else:
        kn, vn = k, v
        to_t = torch.from_numpy
    q_r, s_r = rkv.quantize_kv(jnp.asarray(kn))
    q, s = tkv.quantize_kv(to_t(kn))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
    assert q.shape == shape and s.shape == shape[:-1]
    for out_dtype, t_dtype in ((jnp.bfloat16, torch.bfloat16),
                               (jnp.float32, torch.float32)):
        d_r = np.asarray(rkv.dequantize_kv(q_r, s_r, out_dtype)
                         .astype(jnp.float32))
        d = tkv.dequantize_kv(q, s, t_dtype).float().numpy()
        np.testing.assert_array_equal(d, d_r)
    cfg = smoke_config("deepseek_7b")
    st_r = rkv.quantize_prefill_cache(
        cfg, {"k": jnp.asarray(kn), "v": jnp.asarray(vn)})
    st = tkv.quantize_prefill_cache(cfg, {"k": to_t(kn), "v": to_t(vn)})
    assert set(st) == set(st_r) == {"k", "v", "k_scale", "v_scale"}
    for name in st:
        np.testing.assert_array_equal(st[name].numpy(),
                                      np.asarray(st_r[name]))


@pytest.mark.parametrize("shape", [(64, 64), (3, 5, 7), (1000,)])
def test_group_quant_serves_grad_compression(shape):
    """At group 256 on a flattened, zero-padded leaf the plain kernel 7
    equals ``grad_compress._quant_leaf``: one kernel serves the KV cache
    and the gradient compression."""
    g = _x(shape, 5, scale=0.01)
    q_r, s_r = rgc._quant_leaf(jnp.asarray(g))
    flat = torch.from_numpy(g.reshape(-1))
    flat = torch.cat([flat, flat.new_zeros((-flat.numel()) % 256)])
    q, s = ops.group_quant(flat.reshape(-1, 256), 256)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(s.numpy()[:, 0], np.asarray(s_r))
    d_r = rgc._dequant_leaf(q_r, s_r, shape)
    d = ops.group_dequant(q, s, 256).reshape(-1)[:g.size].reshape(shape)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_r))


def _kv_step(B, Sq, H, hd, dtype, seed):
    """A decode step's K and V (B, Sq, H, hd) as (numpy, torch) pairs, with
    an all-zero head vector and exact .5 ties in K."""
    k = _x((B, Sq, H, hd), seed, scale=2.0)
    v = _x((B, Sq, H, hd), seed + 1, scale=2.0)
    k[0, 0, 0] = 0.0
    k[-1, -1, -1] = _ties(2, hd)[0]
    if dtype == "bfloat16":
        kn, vn = k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
        to_t = (lambda a: torch.from_numpy(a.view(np.uint16).copy())
                .view(torch.bfloat16))
    else:
        kn, vn, to_t = k, v, torch.from_numpy
    return (kn, to_t(kn)), (vn, to_t(vn))


def _int8_cache(lead, seed):
    """An int8 cache with random contents (B, S, H, hd) / (B, S, H), so
    that the entries a write must leave alone are checked too."""
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(rng.integers(-127, 128, lead).astype(np.int8))
            if n in ("k", "v") else
            torch.from_numpy(rng.random(lead[:-1]).astype(np.float32))
            for n in ("k", "v", "k_scale", "v_scale")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, 3])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_fused_kv_write_matches_composed_route(dtype, sq, where):
    """The fused decode-step write (one kernel-7 launch on the card) equals
    the composed route, two ``quantize_heads`` and four slice copies, and
    the reference's decode write (``_quantize_heads`` and
    ``dynamic_update_slice_in_dim``, run eagerly) at the cache's first
    position, in the middle and at capacity − Sq."""
    from repro.models import attention as ratt
    from repro_torch.models.attention import quantize_heads

    B, S, H, hd = 2, 11, 3, 64
    start = {"first": 0, "middle": 4, "last": S - sq}[where]
    (kn, k), (vn, v) = _kv_step(B, sq, H, hd, dtype, seed=sq)
    got = _int8_cache((B, S, H, hd), 9)
    ops.quantize_kv_into(k, v, got, start)
    want = _int8_cache((B, S, H, hd), 9)
    for name, x in (("k", k), ("v", v)):
        q, sc = quantize_heads(x)
        want[name][:, start:start + sq] = q
        want[name + "_scale"][:, start:start + sq] = sc
    ref_cache = {n: jnp.asarray(t.numpy()) for n, t in
                 _int8_cache((B, S, H, hd), 9).items()}
    for name, x in (("k", kn), ("v", vn)):
        q, sc = ratt._quantize_heads(jnp.asarray(x))
        ref_cache[name] = jax.lax.dynamic_update_slice_in_dim(
            ref_cache[name], q, start, axis=1)
        ref_cache[name + "_scale"] = jax.lax.dynamic_update_slice_in_dim(
            ref_cache[name + "_scale"], sc.astype(jnp.float32), start, axis=1)
    for name in got:
        assert torch.equal(got[name], want[name]), name
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(ref_cache[name]))


def test_fused_kv_write_into_a_layer_of_the_stack():
    """Written into one layer of a stacked (L, B, S, H, hd) cache (the
    batch stride is the layer's), the other layers are left alone."""
    L, B, S, H, hd, start = 3, 2, 6, 2, 128, 5
    (_, k), (_, v) = _kv_step(B, 1, H, hd, "bfloat16", seed=4)
    stack = _int8_cache((L, B, S, H, hd), 5)
    want = {n: t.clone() for n, t in stack.items()}
    ops.quantize_kv_into(k, v, {n: t[1] for n, t in stack.items()}, start)
    ref.quantize_kv_into(k, v, {n: t[1] for n, t in want.items()}, start)
    for name in stack:
        assert torch.equal(stack[name], want[name]), name
    assert not torch.equal(stack["k"][1], _int8_cache((L, B, S, H, hd),
                                                      5)["k"][1])


def test_fused_kv_write_checks_inputs():
    B, Sq, H, hd, S = 2, 3, 2, 32, 8
    (_, k), (_, v) = _kv_step(B, Sq, H, hd, "float32", seed=2)
    cache = _int8_cache((B, S, H, hd), 1)
    for start in (S - Sq + 1, S, -1):
        with pytest.raises(ValueError, match="past the cache"):
            ops.quantize_kv_into(k, v, cache, start)
    with pytest.raises(TypeError):
        ops.quantize_kv_into(k.double(), v.double(), cache, 0)
    with pytest.raises(ValueError):
        ops.quantize_kv_into(k, v.bfloat16(), cache, 0)
    with pytest.raises(TypeError):
        ops.quantize_kv_into(k, v, dict(cache, v=cache["v"].short()), 0)
    with pytest.raises(TypeError):
        ops.quantize_kv_into(k, v, dict(cache, k_scale=cache["k_scale"]
                                        .double()), 0)
    strided = k.transpose(0, 1).contiguous().transpose(0, 1)
    assert strided.shape == k.shape and not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ops.quantize_kv_into(strided, v, cache, 0)
    wide = torch.zeros(B, S, H, 2 * hd, dtype=torch.int8)[..., :hd]
    with pytest.raises(ValueError, match="contiguous"):
        ops.quantize_kv_into(k, v, dict(cache, k=wide), 0)
    with pytest.raises(ValueError, match="does not match"):
        ops.quantize_kv_into(k, v, dict(cache, v=cache["v"][:1]), 0)
    # nothing was written by the refused calls
    assert all(torch.equal(t, _int8_cache((B, S, H, hd), 1)[n])
               for n, t in cache.items())


@pytest.mark.cuda
def test_qdq_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    # groups of 16…512 take every pack width (1, 2, 4, 8 values a lane)
    extra = [((1000, 384), 128), ((7, 96), 32), ((33, 48), 16),
             ((5, 512), 512)]
    for (rows, d), group in CASES + extra:
        for x in (torch.from_numpy(_x((rows, d), rows + d)),
                  torch.from_numpy(_ties(rows, d))):
            x[3 % rows] = 0.0
            for xt in (x.to(dev), x.to(dev, torch.bfloat16)):
                q, s = ops.group_quant(xt, group)
                q_p, s_p = ref.group_quant(xt, group)
                assert torch.equal(q, q_p) and torch.equal(s, s_p)
                assert torch.equal(ops.group_dequant(q, s, group),
                                   ref.group_dequant(q, s, group))
    # a base pointer off the 16-byte alignment takes the narrow packs
    flat = torch.from_numpy(_x((64 * 128 + 1,), 6)).to(dev, torch.bfloat16)
    off = flat[1:].reshape(64, 128)
    assert off.data_ptr() % 16
    q, s = ops.group_quant(off, 128)
    q_p, s_p = ref.group_quant(off, 128)
    assert torch.equal(q, q_p) and torch.equal(s, s_p)
    torch.cuda.synchronize()
