"""The RWKV6 and Mamba2 blocks against the reference, on the CPU.

``repro_torch.models.rwkv`` (``rwkv6_specs``, ``init_rwkv_state``,
``rwkv6_apply``) and ``repro_torch.models.ssm`` (``mamba2_specs``,
``init_mamba_state``, ``mamba2_apply``) against ``repro.models.rwkv`` and
``repro.models.ssm``, at the smoke widths of rwkv6-7b and zamba2-2.7b, on
the same numpy-seeded parameters and inputs
(``tests/card_reference/make_card_reference.py``: ``recurrent_tree``,
``recurrent_inputs``).

The reference initialises the leaves the recurrences read to zeros
(``mu_*``, ``w0``, ``u_bonus``, ``a_log``, ``dt_bias``) or ones
(``d_skip``).  With ``mu = 0`` the token shift has no effect, with
``u_bonus = 0`` the same-step bonus vanishes and with ``a_log = 0`` every
Mamba2 head decays alike, so a port that got any of these wrong would
pass there.  Every test here draws them non-zero.

Tolerances: float32 outputs and state leaves within 1e-5 relative
(``max|port − ref| / max|ref|``; only the float32 summation order of the
products differs), bf16 within 1e-2, the tolerance of the reference's own
bf16 tests; the chunked forms against the same block's step-by-step
decode within 2e-3, as ``tests/test_models.py`` holds the reference.

The reference is imported inside the test bodies only and runs eagerly
(its chunk loop is a jitted float32 scan).
"""
import importlib.util
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import layers as tlay
from repro_torch.models import model as tmodel
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "make_card_reference",
    os.path.join(HERE, "card_reference", "make_card_reference.py"))
fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture)

ARCHS = {"rwkv": "rwkv6_7b", "mamba": "zamba2_2_7b"}
DTYPES = ["float32", "bfloat16"]
TOL = fixture.TOL["block"]
CHUNK = fixture.RECURRENT_CHUNK
SEED = fixture.RECURRENT_SEED


def _cfgs(block: str, dtype: str):
    """(reference cfg, port cfg) of the block's smoke config."""
    from repro.configs import smoke_config as r_smoke

    arch = ARCHS[block]
    return (replace(r_smoke(arch), dtype=dtype),
            replace(smoke_config(arch), dtype=dtype))


def _specs(block: str, cfg) -> dict:
    return (trwkv.rwkv6_specs(cfg) if block == "rwkv"
            else tssm.mamba2_specs(cfg))


def _params(block: str, cfg, seed: int = SEED) -> dict:
    """Float32 numpy leaves for the block's specs, the recurrence's
    leaves drawn non-zero."""
    return fixture.recurrent_tree(fixture.spec_leaves(_specs(block, cfg)),
                                  seed)


def _as_ref(p: dict, specs: dict) -> dict:
    import jax.numpy as jnp

    return {k: jnp.asarray(v).astype(specs[k].dtype) for k, v in p.items()}


def _as_port(p: dict, specs: dict) -> dict:
    return {k: torch.from_numpy(v).to(specs[k].torch_dtype)
            for k, v in p.items()}


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    import jax.numpy as jnp
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(a, b) -> float:
    a, b = _f32(a), _f32(b)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


def _ref_apply(block: str, rcfg, p: dict, x: np.ndarray, mode: str,
               state: dict | None, chunk: int = CHUNK):
    import jax.numpy as jnp

    from repro.models import rwkv as rrwkv
    from repro.models import ssm as rssm

    if block == "rwkv":
        fn, specs = rrwkv.rwkv6_apply, rrwkv.rwkv6_specs(rcfg)
    else:
        fn, specs = rssm.mamba2_apply, rssm.mamba2_specs(rcfg)
    st = None if state is None else {
        k: jnp.asarray(v).astype(jnp.bfloat16 if k == "conv"
                                 else jnp.float32) for k, v in state.items()}
    return fn(_as_ref(p, specs), jnp.asarray(x).astype(rcfg.dtype), rcfg,
              mode=mode, state=st, chunk=chunk)


def _port_apply(block: str, cfg, p: dict, x: np.ndarray, mode: str,
                state: dict | None, chunk: int = CHUNK):
    fn = trwkv.rwkv6_apply if block == "rwkv" else tssm.mamba2_apply
    specs = _specs(block, cfg)
    st = None if state is None else {
        k: torch.from_numpy(v).to(torch.bfloat16 if k == "conv"
                                  else torch.float32)
        for k, v in state.items()}
    return fn(_as_port(p, specs),
              torch.from_numpy(x).to(tlay.DTYPES[cfg.dtype]), cfg,
              mode=mode, state=st, chunk=chunk)


def _inputs(cfg, S: int):
    x, state, _ = fixture.recurrent_inputs(cfg)
    return x[:, :S], state


@pytest.mark.parametrize("block", list(ARCHS))
def test_specs_match_reference(block):
    from repro.models import rwkv as rrwkv
    from repro.models import ssm as rssm

    rcfg, cfg = _cfgs(block, "bfloat16")
    want = (rrwkv.rwkv6_specs(rcfg) if block == "rwkv"
            else rssm.mamba2_specs(rcfg))
    got = _specs(block, cfg)
    assert list(got) == list(want)
    for k, s in got.items():
        w = want[k]
        assert (s.shape, s.axes, s.dtype, s.init, s.scale) == (
            w.shape, w.axes, w.dtype, w.init, w.scale), k


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", list(ARCHS))
def test_apply_matches_reference(block, dtype, mode):
    """Train from zeros, prefill from a non-zero carried state, decode of
    one token from it: the output and every state leaf.  40 positions at
    chunk 8 for train and prefill; the carried conv state holds
    bf16-representable values, as the reference stores it."""
    rcfg, cfg = _cfgs(block, dtype)
    p = _params(block, cfg)
    x, state = _inputs(cfg, 1 if mode == "decode" else 40)
    if mode == "train":
        state = None
    want, want_st = _ref_apply(block, rcfg, p, x, mode, state)
    got, got_st = _port_apply(block, cfg, p, x, mode, state)
    assert got.dtype == tlay.DTYPES[dtype] and tuple(got.shape) == x.shape
    assert _rel(want, got) <= TOL[dtype], _rel(want, got)
    assert set(got_st) == set(want_st)
    for k in want_st:
        assert tuple(got_st[k].shape) == want_st[k].shape, k
        assert _rel(want_st[k], got_st[k]) <= TOL[dtype], (
            k, _rel(want_st[k], got_st[k]))


@pytest.mark.parametrize("S", [1, 13, 40])
@pytest.mark.parametrize("block", list(ARCHS))
def test_lengths_off_the_chunk(block, S):
    """A length of 1 and lengths that are not multiples of the chunk, in
    train mode, float32: the zero padding to whole chunks changes
    nothing."""
    rcfg, cfg = _cfgs(block, "float32")
    p = _params(block, cfg, SEED + 10)
    x, _ = _inputs(cfg, S)
    want, want_st = _ref_apply(block, rcfg, p, x, "train", None)
    got, got_st = _port_apply(block, cfg, p, x, "train", None)
    assert _rel(want, got) <= TOL["float32"]
    for k in want_st:
        assert _rel(want_st[k], got_st[k]) <= TOL["float32"], k


def test_rwkv_decay_hits_both_clip_bounds():
    """``w0`` at -15 and +6 in alternate channels: ``exp(logw)`` falls
    below 1e-4 and rises above 2.5, and the clipped decay matches the
    reference in the chunked form and in decode."""
    rcfg, cfg = _cfgs("rwkv", "float32")
    p = _params("rwkv", cfg)
    d = cfg.d_model
    p["w0"] = np.where(np.arange(d) % 2 == 0, -15.0, 6.0).astype(np.float32)
    x, state = _inputs(cfg, 40)
    # the case reaches both bounds: logw from the block's own steps
    tp = _as_port(p, _specs("rwkv", cfg))
    xn = tlay.rmsnorm(torch.from_numpy(x), tp["ln_t"].float(), cfg.norm_eps)
    xprev = trwkv._token_shift(xn, torch.from_numpy(state["shift_t"]))
    xw = trwkv._mix(xn, xprev, tp["mu_w"].float())
    raw = torch.exp(tp["w0"] + tlay.linear(
        torch.tanh(tlay.linear(xw, tp["wA"].float())), tp["wB"].float()))
    assert float(raw.min()) < 1e-4 and float(raw.max()) > 2.5
    for mode, xs in (("prefill", x), ("decode", x[:, :1])):
        want, want_st = _ref_apply("rwkv", rcfg, p, xs, mode, state)
        got, got_st = _port_apply("rwkv", cfg, p, xs, mode, state)
        assert _rel(want, got) <= TOL["float32"], mode
        for k in want_st:
            assert _rel(want_st[k], got_st[k]) <= TOL["float32"], (mode, k)


@pytest.mark.parametrize("block", list(ARCHS))
def test_chunked_matches_sequential(block):
    """The port's chunked form (train, chunk 8, 40 positions) equals its
    own step-by-step decode from the zero state, within 2e-3, outputs
    and the recurrent state (float32; the conv state is carried in
    float32 here, as the reference's own oracle carries it)."""
    _, cfg = _cfgs(block, "float32")
    tp = _as_port(_params(block, cfg), _specs(block, cfg))
    x, _ = _inputs(cfg, 40)
    x = torch.from_numpy(x)
    if block == "rwkv":
        fn, st = trwkv.rwkv6_apply, trwkv.init_rwkv_state(cfg, 2,
                                                          device="cpu")
    else:
        fn, st = tssm.mamba2_apply, tssm.init_mamba_state(cfg, 2,
                                                          device="cpu")
    st = {k: v.float() for k, v in st.items()}
    out_chunk, st_chunk = fn(tp, x, cfg, mode="train", chunk=CHUNK)
    outs = []
    for t in range(x.shape[1]):
        o, st = fn(tp, x[:, t:t + 1], cfg, mode="decode", state=st)
        outs.append(o)
    out_seq = torch.cat(outs, dim=1)
    np.testing.assert_allclose(out_chunk.numpy(), out_seq.numpy(),
                               rtol=2e-3, atol=2e-3)
    for k in st:
        np.testing.assert_allclose(st_chunk[k].numpy(), st[k].numpy(),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("block", list(ARCHS))
def test_carried_state_splits_a_sequence(block):
    """Two prefills of 17 and 23 positions, the second from the first's
    state (carried as the block returns it), give the one 40-position
    prefill's last 23 outputs and its state (float32, 1e-5).  A token
    shift that carried the wrong position (``shift_t``/``shift_c`` not the
    last normalised inputs, or the conv state not the last three conv
    inputs) breaks the join."""
    _, cfg = _cfgs(block, "float32")
    tp = _as_port(_params(block, cfg), _specs(block, cfg))
    fn = trwkv.rwkv6_apply if block == "rwkv" else tssm.mamba2_apply
    x = torch.from_numpy(_inputs(cfg, 40)[0])
    whole, whole_st = fn(tp, x, cfg, mode="prefill", chunk=CHUNK)
    _, st = fn(tp, x[:, :17], cfg, mode="prefill", chunk=CHUNK)
    second, second_st = fn(tp, x[:, 17:], cfg, mode="prefill", state=st,
                           chunk=CHUNK)
    assert _rel(whole[:, 17:], second) <= TOL["float32"]
    for k in whole_st:
        assert _rel(whole_st[k], second_st[k]) <= TOL["float32"], k


def test_rwkv_shift_t_is_the_last_normalised_input():
    """``shift_t`` is the time mix's normalised input at the last
    position, not the raw input or another position (``shift_c``, the
    channel mix's, is held to the reference's in
    :func:`test_apply_matches_reference` and by the join above); a decode
    step from a prefill's state gives the longer prefill's last output."""
    _, cfg = _cfgs("rwkv", "float32")
    tp = _as_port(_params("rwkv", cfg), _specs("rwkv", cfg))
    x = torch.from_numpy(_inputs(cfg, 9)[0])
    out, st = trwkv.rwkv6_apply(tp, x, cfg, mode="prefill", chunk=CHUNK)
    xn = tlay.rmsnorm(x, tp["ln_t"], cfg.norm_eps)
    assert torch.equal(st["shift_t"], xn[:, -1])
    assert not torch.equal(st["shift_t"], xn[:, -2])
    _, st8 = trwkv.rwkv6_apply(tp, x[:, :-1], cfg, mode="prefill",
                               chunk=CHUNK)
    y, _ = trwkv.rwkv6_apply(tp, x[:, -1:], cfg, mode="decode", state=st8)
    assert _rel(out[:, -1:], y) <= TOL["float32"]


def test_conv_state_is_bf16_in_a_float32_model():
    """The Mamba2 conv state is bf16 whatever the model's dtype, as the
    reference keeps it: in one block's state and in the hybrid's state
    stack, where a float32 prefill stores its last three conv inputs
    rounded to bf16 (ROADMAP.md, queue 3)."""
    _, cfg = _cfgs("mamba", "float32")
    st = tssm.init_mamba_state(cfg, 2, device="cpu")
    assert st["conv"].dtype == torch.bfloat16
    assert st["ssm"].dtype == torch.float32
    full = tmodel.init_decode_state(cfg, 2, 5, device="cpu")
    assert full["mamba"]["conv"].dtype == torch.bfloat16
    groups = cfg.n_layers // cfg.shared_attn_every
    assert tuple(full["mamba"]["conv"].shape[:2]) == (groups,
                                                     cfg.shared_attn_every)
    p = _params("mamba", cfg)
    x, _ = _inputs(cfg, 11)
    _, new = _port_apply("mamba", cfg, p, x, "prefill", None)
    assert new["conv"].dtype == torch.float32           # the block's own
    stack = tmodel.init_decode_state(cfg, 2, 11, device="cpu")
    tmodel._put(stack["mamba"], (0, 0), new)
    assert torch.equal(stack["mamba"]["conv"][0, 0],
                       new["conv"].to(torch.bfloat16))
    assert not torch.equal(stack["mamba"]["conv"][0, 0].float(), new["conv"])
