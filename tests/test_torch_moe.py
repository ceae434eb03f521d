"""The mixture-of-experts layer against the reference, on the CPU.

``repro_torch.models.moe`` (``moe_specs``, ``_moe_group``, ``moe_apply``)
and ``repro_torch.models.model.param_counts`` against
``repro.models.moe`` and ``repro.models.model`` on the same numpy-seeded
parameters and inputs, at the smoke width of granite-moe-1b-a400m and
qwen3-moe-30b-a3b (8 experts, top-2) and at qwen3's 128 experts, top-8.

Tolerances: float32 outputs within 1e-5 relative (only the float32
summation order of the products differs), the routing (``sel``,
``keep``, ``dest``) exactly equal, ``aux`` within 1e-6; bf16 outputs
within 1e-2 relative, the tolerance of the reference's own bf16 tests.
The reference's routing is read by wrapping ``jax.lax.top_k`` (the
choices) and ``jax.numpy.where`` (the slots) while its ``_moe_group``
runs eagerly.

The reference is imported inside the test bodies only.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import PORTED_IDS, get_config, smoke_config
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe

ARCHS = ["granite_moe_1b_a400m", "qwen3_moe_30b_a3b"]
TOL = {"bfloat16": 1e-2, "float32": 1e-5}


def _cfgs(arch: str, dtype: str, **change):
    """(reference cfg, port cfg) of ``arch``'s smoke config."""
    from repro.configs import smoke_config as r_smoke

    return (replace(r_smoke(arch), dtype=dtype, **change),
            replace(smoke_config(arch), dtype=dtype, **change))


def _params(cfg, seed: int, scale: float = 1.0) -> dict:
    """Float32 numpy leaves for ``moe_specs(cfg)``: ones for the norm,
    ``N(0, 1) · scale / √fan_in`` for the router and the experts."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in tmoe.moe_specs(cfg).items():
        if spec.init == "ones":
            out[name] = np.ones(spec.shape, np.float32)
        else:
            out[name] = (rng.standard_normal(spec.shape) * scale
                         / np.sqrt(spec.shape[-2])).astype(np.float32)
    return out


def _as_ref(p: dict, cfg) -> dict:
    import jax.numpy as jnp

    from repro.models import moe as rmoe

    specs = rmoe.moe_specs(cfg)
    return {k: jnp.asarray(v).astype(specs[k].dtype) for k, v in p.items()}


def _as_port(p: dict, cfg) -> dict:
    specs = tmoe.moe_specs(cfg)
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


def _ref_group(p: dict, tokens: np.ndarray, cfg, monkeypatch):
    """The reference's ``_moe_group`` on ``tokens``, run eagerly:
    ``(out, aux, sel, dest)``, with ``sel`` from its ``jax.lax.top_k`` call
    and ``dest`` from its ``jnp.where`` of the slots."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as rmoe

    seen = {"top_k": [], "where": []}
    top_k, where = jax.lax.top_k, jnp.where

    def rec_top_k(*a, **kw):
        out = top_k(*a, **kw)
        seen["top_k"].append(out)
        return out

    def rec_where(*a, **kw):
        out = where(*a, **kw)
        seen["where"].append(out)
        return out

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jnp, "where", rec_where)
    x = jnp.asarray(tokens).astype(cfg.dtype)
    out, aux = rmoe._moe_group(_as_ref(p, cfg), x, cfg)
    monkeypatch.undo()
    (_, sel), = seen["top_k"]
    dest = [w for w in seen["where"]
            if w.ndim == 1 and jnp.issubdtype(w.dtype, jnp.integer)]
    assert len(dest) == 1, [w.shape for w in seen["where"]]
    return out, aux, np.asarray(sel), np.asarray(dest[0])


def _port_group(p: dict, tokens: np.ndarray, cfg):
    """The port's ``_moe_group`` and its routing: ``(out, aux, sel, keep,
    dest, capacity)``."""
    tp = _as_port(p, cfg)
    x = torch.from_numpy(tokens).to(tp["w_up"].dtype)
    sel, keep, dest, _, capacity, aux = tmoe._routing(tp, x[None], cfg)
    out, aux2 = tmoe._moe_group(tp, x, cfg)
    assert torch.equal(aux[0], aux2)
    return out, aux2, sel[0].numpy(), keep.numpy(), dest.numpy(), capacity


def _same_group(p, tokens, rcfg, tcfg, monkeypatch, *, routing: bool):
    """Hold the port's group to the reference's; returns the port's
    routing."""
    r_out, r_aux, r_sel, r_dest = _ref_group(p, tokens, rcfg, monkeypatch)
    t_out, t_aux, t_sel, t_keep, t_dest, cap = _port_group(p, tokens, tcfg)
    if routing:
        np.testing.assert_array_equal(t_sel, r_sel)
        np.testing.assert_array_equal(t_dest, r_dest)
        np.testing.assert_array_equal(
            t_keep, r_dest != tcfg.n_experts * cap)
    assert tuple(t_out.shape) == tuple(r_out.shape) == tokens.shape
    assert _rel(r_out, t_out) <= TOL[tcfg.dtype], _rel(r_out, t_out)
    assert abs(float(r_aux) - float(t_aux)) <= 1e-6
    return t_sel, t_keep, t_dest, cap


def test_moe_specs_match_reference():
    from repro.configs import get_config as r_get
    from repro.configs import smoke_config as r_smoke
    from repro.models import moe as rmoe

    for arch in ARCHS:
        for tcfg, rcfg in ((smoke_config(arch), r_smoke(arch)),
                           (get_config(arch), r_get(arch))):
            got, want = tmoe.moe_specs(tcfg), rmoe.moe_specs(rcfg)
            assert list(got) == list(want)
            for k in want:
                g, w = got[k], want[k]
                assert (g.shape, g.axes, g.dtype, g.init, g.scale) == (
                    w.shape, w.axes, w.dtype, w.init, w.scale), k
            assert got["router"].dtype == "float32"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,experts", [
    ("granite_moe_1b_a400m", None), ("qwen3_moe_30b_a3b", None),
    ("qwen3_moe_30b_a3b", (128, 8))],
    ids=["granite", "qwen3", "qwen3_128x8"])
def test_moe_group_matches_reference(arch, experts, dtype, monkeypatch):
    """One group of 64 tokens at the default capacity factor: the routing
    exactly equal in float32 (in bf16 the router reads bf16 tokens, which
    both frameworks hold alike here), outputs and ``aux`` within the
    tolerances."""
    change = {} if experts is None else dict(n_experts=experts[0],
                                             experts_per_token=experts[1])
    rcfg, tcfg = _cfgs(arch, dtype, **change)
    p = _params(tcfg, seed=11)
    tokens = np.random.default_rng(12).standard_normal(
        (64, tcfg.d_model)).astype(np.float32)
    _, keep, _, cap = _same_group(p, tokens, rcfg, tcfg, monkeypatch,
                                  routing=True)
    assert cap == max(int(tcfg.capacity_factor * 64
                          * tcfg.experts_per_token / tcfg.n_experts), 4)
    assert keep.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n,group_size,groups", [
    (48, 4096, 1), (24, 16, 3), (18, 16, 9)],
    ids=["one_group", "n24_gs16_to_8", "n18_gs16_to_2"])
def test_moe_apply_matches_reference(arch, dtype, n, group_size, groups):
    """``moe_apply`` on (2, n/2, d): the group size halves until it
    divides the token count (24 tokens in groups of 8, 18 in groups of
    2), capacity is provisioned per group, and ``aux`` is the mean over
    the groups."""
    import jax.numpy as jnp

    from repro.models import moe as rmoe

    rcfg, tcfg = _cfgs(arch, dtype)
    p = _params(tcfg, seed=21)
    x = np.random.default_rng(22).standard_normal(
        (2, n // 2, tcfg.d_model)).astype(np.float32)
    r_out, r_aux = rmoe.moe_apply(_as_ref(p, rcfg),
                                  jnp.asarray(x).astype(dtype), rcfg,
                                  group_size=group_size)
    tp = _as_port(p, tcfg)
    t_out, t_aux = tmoe.moe_apply(tp, torch.from_numpy(x).to(
        tp["w_up"].dtype), tcfg, group_size=group_size)
    assert tuple(t_out.shape) == x.shape and t_out.dtype == tp["w_up"].dtype
    assert _rel(r_out, t_out) <= TOL[dtype], _rel(r_out, t_out)
    assert abs(float(r_aux) - float(t_aux)) <= 1e-6
    gs = min(group_size, n)
    while n % gs:
        gs //= 2
    assert n // gs == groups


@pytest.mark.parametrize("seed", range(4))
def test_bf16_router_near_ties(seed, monkeypatch):
    """bf16 tokens on a router with near-equal columns: the outputs stay
    within 1e-2 of the reference's.  The two frameworks' float32 router
    sums may differ in the last bit, which flips such near-ties: the
    counts of choices in another order and of tokens routed to another
    set of experts are printed (ROADMAP.md, queue 3, records them)."""
    rcfg, tcfg = _cfgs("granite_moe_1b_a400m", "bfloat16")
    p = _params(tcfg, seed=100 + seed)
    # pairs of router columns one float32 step apart
    r = p["router"]
    r[:, 1::2] = np.nextafter(r[:, 0::2], np.float32(np.inf))
    tokens = np.random.default_rng(200 + seed).standard_normal(
        (64, tcfg.d_model)).astype(np.float32)
    r_out, r_aux, r_sel, _ = _ref_group(p, tokens, rcfg, monkeypatch)
    t_out, t_aux, t_sel, *_ = _port_group(p, tokens, tcfg)
    order = int((r_sel != t_sel).sum())
    chosen = int((np.sort(r_sel, 1) != np.sort(t_sel, 1)).any(1).sum())
    print(f"seed {seed}: {order} of {r_sel.size} choices in another order, "
          f"{chosen} of {len(r_sel)} tokens with another set of experts")
    assert _rel(r_out, t_out) <= TOL["bfloat16"], (order, chosen,
                                                   _rel(r_out, t_out))
    assert abs(float(r_aux) - float(t_aux)) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tie_order_picks_lower_experts(dtype, monkeypatch):
    """Exactly equal probabilities: a zero token (every logit 0) routes
    to experts 0…k-1, and a router whose columns 3 and 1 are equal routes
    the tie to expert 1 before 3, as ``jax.lax.top_k`` does."""
    rcfg, tcfg = _cfgs("qwen3_moe_30b_a3b", dtype)
    p = _params(tcfg, seed=31)
    p["router"][:, 3] = p["router"][:, 1]
    tokens = np.random.default_rng(32).standard_normal(
        (16, tcfg.d_model)).astype(np.float32)
    tokens[::4] = 0.0
    sel, *_ = _same_group(p, tokens, rcfg, tcfg, monkeypatch, routing=True)
    k = tcfg.experts_per_token
    np.testing.assert_array_equal(sel[::4], np.tile(np.arange(k),
                                                    (4, 1)))
    both = [(row.tolist().index(1), row.tolist().index(3))
            for row in sel if 1 in row and 3 in row]
    assert all(i1 < i3 for i1, i3 in both)
    # the port's stable sort against torch.topk, which promises no order
    probs = torch.full((1, tcfg.n_experts), 1.0 / tcfg.n_experts)
    assert tmoe._route(probs, k)[1].tolist() == [list(range(k))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_capacity_overflow_drops_the_same_tokens(dtype, monkeypatch):
    """A group where every token's first choices are experts 0 and 1:
    each keeps its first ``capacity`` assignments in token order, the
    same as the reference's, and a token whose every choice dropped
    gets a zero output."""
    rcfg, tcfg = _cfgs("granite_moe_1b_a400m", dtype)
    p = _params(tcfg, seed=41)
    g = 16
    tokens = np.random.default_rng(42).standard_normal(
        (g, tcfg.d_model)).astype(np.float32)
    # logits of ~50: at ~300 (a component of 4–7) one float32 step of a
    # logit moves the gates between experts 0 and 1 by ~1e-5 in either
    # package (ROADMAP.md, queue 3)
    tokens[:, 0] = 1.0
    p["router"][0, :2] = 50.0
    p["router"][0, 2:] = -50.0
    sel, keep, dest, cap = _same_group(p, tokens, rcfg, tcfg, monkeypatch,
                                       routing=True)
    k = tcfg.experts_per_token
    assert cap == 5 and (np.sort(sel, axis=1) == [0, 1]).all()
    per_token = keep.reshape(g, k)
    np.testing.assert_array_equal(per_token.any(1), np.arange(g) < cap)
    assert int(keep.sum()) == 2 * cap
    assert (dest[~keep] == tcfg.n_experts * cap).all()
    out, *_ = _port_group(p, tokens, tcfg)
    assert not out[cap:].any() and out[:cap].abs().amax(1).min() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groups_in_one_pass_drop_per_group(dtype):
    """Small groups go through several at a time, each with its own
    capacity: 24 tokens in groups of 8 (two groups a pass), every token
    choosing experts 0 and 1, drop the last 4 tokens of each group, as
    the reference's scan over the groups does; and the pass equals the
    groups taken one by one."""
    import jax.numpy as jnp

    from repro.models import moe as rmoe

    rcfg, tcfg = _cfgs("granite_moe_1b_a400m", dtype)
    p = _params(tcfg, seed=61)
    p["router"][0, :2] = 10.0
    p["router"][0, 2:] = -10.0
    x = np.random.default_rng(62).standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32)
    x[..., 0] = 3.0
    r_out, r_aux = rmoe.moe_apply(_as_ref(p, rcfg),
                                  jnp.asarray(x).astype(dtype), rcfg,
                                  group_size=16)
    tp = _as_port(p, tcfg)
    xt = torch.from_numpy(x).to(tp["w_up"].dtype)
    t_out, t_aux = tmoe.moe_apply(tp, xt, tcfg, group_size=16)
    assert _rel(r_out, t_out) <= TOL[dtype]
    assert abs(float(r_aux) - float(t_aux)) <= 1e-6
    flat = t_out.reshape(3, 8, -1)
    assert not flat[:, 4:].any() and bool(flat[:, :4].abs().amax(-1).gt(0)
                                          .all())
    from repro_torch.models.layers import rmsnorm
    groups = rmsnorm(xt, tp["ln"], tcfg.norm_eps).reshape(3, 8, -1)
    at_once, aux = tmoe._moe_groups(tp, groups[:2], tcfg)
    for i in range(2):
        one, one_aux = tmoe._moe_group(tp, groups[i], tcfg)
        assert _rel(one, at_once[i]) <= 1e-6
        assert abs(float(one_aux) - float(aux[i])) <= 1e-7


def test_moe_aux_in_train_mode_matches_reference():
    """A float32 granite-moe smoke model in train mode: logits within
    1e-4 and ``moe_aux`` (the layers' mean) within 1e-6 of the
    reference's, on a numpy-seeded parameter tree."""
    import jax.numpy as jnp

    from repro.models import model as rmodel

    from repro_torch.convert import params_from_reference

    rcfg, tcfg = _cfgs("granite_moe_1b_a400m", "float32")
    rng = np.random.default_rng(51)
    specs = rmodel.model_specs(rcfg)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        if node.init == "ones":
            return np.ones(node.shape, np.float32)
        return (rng.standard_normal(node.shape)
                / np.sqrt(node.shape[-2])).astype(np.float32)

    tree = draw(specs)
    tokens = rng.integers(0, rcfg.vocab_size, (2, 16))
    r_logits, r_aux = rmodel.forward(
        _jnp_tree(tree), rcfg,
        tokens=jnp.asarray(tokens), mode="train")
    t_logits, t_aux = tmodel.forward(
        params_from_reference(tree, tcfg, device="cpu"), tcfg,
        tokens=torch.from_numpy(tokens), mode="train")
    assert _rel(r_logits, t_logits) <= 1e-4
    want = float(r_aux["moe_aux"])
    assert want > 0 and abs(float(t_aux["moe_aux"]) - want) <= 1e-6


def _jnp_tree(tree):
    import jax.numpy as jnp
    return {k: _jnp_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def test_param_counts_match_reference():
    """(total, active) equal to the reference's for every ported
    architecture at full size, from the specs alone; and the two MoE
    configs' figures that ``chip_smoke.py`` checks."""
    from repro.configs import get_config as r_get
    from repro.models import model as rmodel

    for arch in PORTED_IDS:
        got = tmodel.param_counts(get_config(arch))
        assert got == rmodel.param_counts(r_get(arch)), arch
        assert (got[0] == got[1]) == (not get_config(arch).n_experts)
    assert tmodel.param_counts(get_config("granite_moe_1b_a400m")) == (
        1384963072, 478993408)
    qwen8 = replace(get_config("qwen3_moe_30b_a3b"), n_layers=8)
    assert tmodel.param_counts(qwen8) == (5531797504, 1001949184)
    assert tmodel.param_counts(qwen8) == rmodel.param_counts(
        replace(r_get("qwen3_moe_30b_a3b"), n_layers=8))
