"""The LM serving slice against the reference, on the CPU.

Smoke configs of the token-input decoders — deepseek-7b (MHA, SwiGLU),
starcoder2-3b (GQA kv=2, QKV bias, GELU), qwen1.5-32b (MHA, QKV bias),
llama3-405b (GQA, rope θ 5·10⁵), the mixture-of-experts
granite-moe-1b-a400m and qwen3-moe-30b-a3b (8 experts, top-2 at smoke
size, the default capacity factor, so that both frameworks drop the same
assignments), rwkv6-7b (ssm: a recurrent state, no KV cache) and
zamba2-2.7b (hybrid: six groups of two Mamba2 layers and a shared
attention block at smoke size) — run
through ``repro.serving.engine`` and ``repro_torch.serving.engine`` with
the same parameters (the reference's ``init_from_specs`` at
``PRNGKey(0)``, carried over as float32 copies by
``params_from_reference``) and the same seeded prompts.  For rwkv6-7b
and zamba2-2.7b the leaves the recurrences read, which the reference
initialises to zeros or ones (``mu_*``, ``w0``, ``u_bonus``, ``a_log``,
``dt_bias``, ``d_skip``), are redrawn non-zero
(``tests/card_reference/make_card_reference.py``:
``with_recurrence_leaves``): at zero the token shift, the bonus and the
per-head decay rates would go untested.

The reference runs in a child process (this file run as a script) with
``--xla_allow_excess_precision=false``, so that it rounds to bf16 where
its code says so.  With XLA's default, a jitted program may skip a
rounding inside a fusion (the attention output projection and the
residual sum reach the next ``rmsnorm`` unrounded), and that alone moves
the reference's own bf16 smoke logits by 1.2–3.5 %: more than the
tolerance below, and no property of either program's algorithm.

Tolerances (one table, ``make_card_reference.TOL`` and ``ARCH_TOL``):

* bf16 models: relative max error ≤ 1e-2 on logits, the tolerance of
  the reference's own decode-vs-train test (``tests/test_models.py``):
  bf16 roundings may fall one step apart where the two frameworks'
  float32 sums differ in the last bit;
* float32 models: ≤ 1e-4, where only float32 summation order differs, so
  a wrong order of operations (a missed rounding of the cache to bf16,
  the int8 scales applied elsewhere) cannot hide;
* zamba2-2.7b at its full smoke depth: bf16 logits ≤ 1e-1 and float32
  decode steps ≤ 1e-2, as its six groups amplify a rounding difference
  about twofold each (the reference's own bf16 logits move by 0.20–0.66
  between XLA's two legal precision modes); cut to its first group
  (``zamba2_2_7b@1``: two Mamba2 layers, the shared attention and the
  shared MLP) it is held at the two bounds above;
* the int8 cache: codes and scales equal wherever both frameworks
  quantized the same bf16 K/V vector (every vector of the first layer);
* greedy generation: the first token equal;
* decode against train on the port's own path: 1e-2 in bf16; in float32
  1e-4 for rwkv6-7b (the reference reads 2.5e-6 there) and, for
  zamba2-2.7b, the bound that its bf16 conv state sets (see
  :func:`test_decode_matches_train_logits_float32`).
"""
import importlib.util
import os
import subprocess
import sys
from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as R_ARCH_IDS
from repro.configs import get_config as r_get
from repro.configs import smoke_config as r_smoke
from repro_torch.configs import PORTED_IDS, RunConfig, get_config, smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.models import layers as tlay
from repro_torch.models import model as tmodel
from repro_torch.serving import ServingEngine, make_prefill_step, make_serve_step
from repro_torch.serving.engine import grow_cache

_spec = importlib.util.spec_from_file_location(
    "make_card_reference", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "card_reference",
        "make_card_reference.py"))
fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture)

ARCHS = ["deepseek_7b", "starcoder2_3b", "qwen1_5_32b", "llama3_405b",
         "granite_moe_1b_a400m", "qwen3_moe_30b_a3b", "rwkv6_7b",
         "zamba2_2_7b"]
MOE_ARCHS = ["granite_moe_1b_a400m", "qwen3_moe_30b_a3b"]
RECURRENT_ARCHS = ["rwkv6_7b", "zamba2_2_7b"]
#: the seed of the recurrence's leaves in the recurrent archs' trees
RECURRENCE_SEED = 7
DTYPES = ["bfloat16", "float32"]
B, P, T, NEW = 2, 9, 4, 6
#: zamba2-2.7b cut to its first group (two Mamba2 layers, the shared
#: attention and the shared MLP): held at the models' tolerance, where
#: its full smoke depth takes its own (make_card_reference.ARCH_TOL)
HYBRID_ONE_GROUP = "zamba2_2_7b@1"
#: the models compared with the reference: every arch at its smoke
#: config, and ``arch@g``, an arch cut to its first ``g`` groups
MODELS = ARCHS + [HYBRID_ONE_GROUP]


def _cfg(smoke, model: str, dtype: str):
    """``model``'s config from ``smoke`` (either package's
    ``smoke_config``) in ``dtype``."""
    arch, _, groups = model.partition("@")
    cfg = replace(smoke(arch), dtype=dtype)
    if groups:
        cfg = replace(cfg, n_layers=int(groups) * cfg.shared_attn_every)
    return cfg


def _tokens(cfg, seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _inputs(cfg):
    return {"train": _tokens(cfg, 3, (B, 12)), "prompts": _tokens(cfg, 1, (B, P)),
            "forced": _tokens(cfg, 2, (B, T)), "gen": _tokens(cfg, 4, (B, 8))}


def _reference_outputs(path: str) -> None:
    """Run the reference on every case and save its outputs to ``path``
    (the child process's work; XLA flags are set by the parent)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import RunConfig as RRun
    from repro.models import layers as rlay
    from repro.models import model as rmodel
    from repro.serving import engine as rengine

    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))

    def flat(tree):
        return {"/".join(k.key for k in path_): leaf for path_, leaf
                in jax.tree_util.tree_leaves_with_path(tree)}

    out = {}
    for arch in MODELS:
        for dtype in DTYPES:
            cfg = _cfg(r_smoke, arch, dtype)
            tag = f"{arch}/{dtype}"
            specs = rmodel.model_specs(cfg)
            params = rlay.init_from_specs(specs, jax.random.PRNGKey(0))
            if cfg.family in ("ssm", "hybrid"):
                params = jax.tree.map(
                    lambda a, s: jnp.asarray(a).astype(s.dtype),
                    fixture.with_recurrence_leaves(
                        jax.tree.map(f32, params), RECURRENCE_SEED), specs)
            for name, leaf in flat(params).items():
                out[f"{tag}/params/{name}"] = f32(leaf)
            inp = _inputs(cfg)
            logits, aux = rmodel.forward(params, cfg, mode="train",
                                         tokens=jnp.asarray(inp["train"]))
            out[f"{tag}/train"] = f32(logits)
            out[f"{tag}/train_aux"] = f32(aux["moe_aux"])
            for kv_quant in (False, True):
                run = RRun(kv_quant=kv_quant)
                qtag = f"{tag}/{int(kv_quant)}"
                # the prefill runs eagerly, as the engine's unit; the
                # decode step jitted once for all positions
                lg, state = rengine.make_prefill_step(cfg, run)(
                    params, {"tokens": jnp.asarray(inp["prompts"])})
                out[f"{qtag}/prefill"] = f32(lg)
                for name, a in flat(state).items():
                    out[f"{qtag}/state/{name}"] = (
                        np.asarray(a) if a.dtype == jnp.int8 else f32(a))
                st = rengine.ServingEngine(cfg, run)._grow_cache(state, T)
                serve = jax.jit(rengine.make_serve_step(cfg, run))
                for i in range(T):
                    lg, st = serve(params, st, {"tokens": jnp.asarray(
                        inp["forced"][:, i:i + 1])}, jnp.int32(P + i))
                    out[f"{qtag}/decode{i}"] = f32(lg)
                if dtype == "bfloat16":
                    for name, a in flat(st).items():
                        out[f"{qtag}/dstate/{name}"] = (
                            np.asarray(a) if a.dtype == jnp.int8 else f32(a))
                if dtype == "bfloat16":
                    out[f"{qtag}/generate"] = np.asarray(
                        rengine.ServingEngine(cfg, run).generate(
                            params, jnp.asarray(inp["gen"]),
                            new_tokens=NEW))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm_ref") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(src)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


_PORT: dict = {}


def _rel(a: np.ndarray, b: torch.Tensor) -> float:
    b = b.float().numpy()
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


def _ref_tree(ref, arch: str, dtype: str) -> dict:
    """The reference's parameters (float32 copies) as nested dicts."""
    prefix = f"{arch}/{dtype}/params/"
    tree: dict = {}
    for k, v in ref.items():
        if k.startswith(prefix):
            node = tree
            *parents, leaf = k[len(prefix):].split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = v
    return tree


def _port_model(ref, arch: str, dtype: str):
    """(port cfg, port params) from the reference's parameters."""
    key = (arch, dtype)
    if key not in _PORT:
        cfg = _cfg(smoke_config, arch, dtype)
        _PORT[key] = (cfg, params_from_reference(_ref_tree(ref, arch, dtype),
                                                 cfg, device="cpu"))
    return _PORT[key]


def _clone(state: dict) -> dict:
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in state.items()}


def _port_runs(ref, arch: str, dtype: str, kv_quant: bool) -> dict:
    """The port's prefill of P tokens and T teacher-forced decode steps
    (from a copy of the prefill's state: decode writes in place)."""
    key = (arch, dtype, kv_quant)
    if key not in _PORT:
        cfg, params = _port_model(ref, arch, dtype)
        inp = _inputs(cfg)
        run = RunConfig(kv_quant=kv_quant)
        lg, state = make_prefill_step(cfg, run)(
            params, {"tokens": torch.from_numpy(inp["prompts"])})
        res = {"prefill": lg, "state": state, "decode": []}
        step = make_serve_step(cfg, run)
        st = grow_cache(_clone(state), T, cfg)
        for i in range(T):
            lg, st = step(params, st, {"tokens": torch.from_numpy(
                inp["forced"][:, i:i + 1])}, P + i)
            res["decode"].append(lg)
        res["dstate"] = st
        _PORT[key] = res
    return _PORT[key]


def test_configs_match_reference():
    """Every arch of the reference's registry loads, field for field the
    reference's config and smoke config; an unknown id raises."""
    for arch in R_ARCH_IDS:
        assert asdict(get_config(arch)) == asdict(r_get(arch))
        assert asdict(smoke_config(arch)) == asdict(r_smoke(arch))
    with pytest.raises(KeyError):
        get_config("gpt2")
    assert PORTED_IDS == list(R_ARCH_IDS)
    assert set(PORTED_IDS) == set(ARCHS) | {"internvl2_76b",
                                           "musicgen_medium"}


def test_model_specs_and_init():
    """The spec tree equals the reference's; initialisation scales each
    layer's leaf as the reference's ``_init_leaf`` scales an unstacked
    one (fan-in = the layer's input width; norms ones, biases zeros)."""
    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}/{k}"))
            else:
                out[f"{prefix}/{k}"] = (tuple(v.shape), v.dtype, v.init)
        return out

    from repro.models import model as rmodel

    for arch in ARCHS:
        assert flat(tmodel.model_specs(smoke_config(arch))) == flat(
            rmodel.model_specs(r_smoke(arch)))
    # an expert leaf (layers, experts, in, out) takes one expert matrix's
    # input width; the router stays float32
    cfg = smoke_config("granite_moe_1b_a400m")
    mlp = tlay.init_from_specs(tmodel.model_specs(cfg),
                               torch.Generator().manual_seed(0),
                               device="cpu")["layers"]["mlp"]
    assert mlp["router"].dtype == torch.float32
    assert tuple(mlp["w_up"].shape) == (cfg.n_layers, cfg.n_experts,
                                        cfg.d_model, cfg.d_ff)
    for w, fan_in in ((mlp["router"], cfg.d_model),
                      (mlp["w_gate"], cfg.d_model),
                      (mlp["w_up"], cfg.d_model),
                      (mlp["w_down"], cfg.d_ff)):
        for expert in w.float().flatten(0, 1 if w.dim() == 4 else 0):
            std = float(expert.std())
            assert abs(std * fan_in ** 0.5 - 1.0) < 0.1, std
    # a hybrid's Mamba2 leaf (groups, layers, in, out) is drawn a layer at
    # a time at the layer's input width, not at the group count
    cfg = smoke_config("zamba2_2_7b")
    params = tlay.init_from_specs(tmodel.model_specs(cfg),
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
    groups = cfg.n_layers // cfg.shared_attn_every
    w_in = params["layers"]["w_in"]
    assert w_in.shape[:3] == (groups, cfg.shared_attn_every, cfg.d_model)
    for layer in w_in.float().flatten(0, 1):
        assert abs(float(layer.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert params["layers"]["a_log"].dtype == torch.float32
    assert set(params) == {"final_ln", "lm_head", "embed", "layers",
                           "shared_attn", "shared_mlp"}
    assert params["shared_attn"]["wq"].dim() == 2
    cfg = smoke_config("starcoder2_3b")
    params = tlay.init_from_specs(tmodel.model_specs(cfg),
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
    lay = params["layers"]
    assert torch.equal(lay["attn"]["ln"], torch.ones_like(lay["attn"]["ln"]))
    assert not lay["attn"]["bq"].any()
    for w, fan_in in ((params["embed"], cfg.vocab_size),
                      (lay["mlp"]["w_up"], cfg.d_model),
                      (lay["mlp"]["w_down"], cfg.d_ff)):
        assert w.dtype == torch.bfloat16
        std = float(w.float().std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.05, std


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MODELS)
def test_train_logits_match_reference(ref, arch, dtype):
    """Train logits, and the MoE layers' load-balance loss (0 for a
    dense model): within 1e-6 of the reference's in float32; in bf16
    within 1e-2 of it, relative, as the router reads the bf16 activations
    whose roundings may fall one step apart."""
    cfg, params = _port_model(ref, arch, dtype)
    got, aux = tmodel.forward(params, cfg, mode="train",
                              tokens=torch.from_numpy(_inputs(cfg)["train"]))
    want = ref[f"{arch}/{dtype}/train"]
    assert tuple(got.shape) == want.shape and aux["state"] is None
    rel = _rel(want, got)
    assert rel <= fixture.tol("logits", dtype, arch), rel
    want_aux = float(ref[f"{arch}/{dtype}/train_aux"])
    tol_aux = 1e-6 if dtype == "float32" else fixture.tol(
        "logits", dtype) * want_aux
    assert abs(float(aux["moe_aux"]) - want_aux) <= tol_aux, (aux, want_aux)
    assert (want_aux > 0) == bool(cfg.n_experts)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_cache",
                                                        "int8_cache"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MODELS)
def test_prefill_and_decode_logits_match_reference(ref, arch, dtype,
                                                   kv_quant):
    """Prefill's last-position logits, then the logits of each decode
    step teacher-forced with the same tokens."""
    port = _port_runs(ref, arch, dtype, kv_quant)
    tag = f"{arch}/{dtype}/{int(kv_quant)}"
    assert tuple(port["prefill"].shape) == ref[f"{tag}/prefill"].shape
    rel = _rel(ref[f"{tag}/prefill"], port["prefill"])
    assert rel <= fixture.tol("logits", dtype, arch), rel
    rels = [_rel(ref[f"{tag}/decode{i}"], lg)
            for i, lg in enumerate(port["decode"])]
    assert max(rels) <= fixture.tol("steps", dtype, arch), rels
    for lg in port["decode"]:
        assert bool(torch.isfinite(lg.float()).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_cache_codes_match_reference(ref, arch):
    """Wherever the two prefills produced the same bf16 K/V vector, the
    int8 caches of the serving path hold the same codes and scales; and
    the decode steps' writes (the fused ``ops.quantize_kv_into``) hold the
    reference's codes at layer 0 (a hybrid: at its first group's cache
    slot).  Of a hybrid's state only the ``kv`` half is quantized; an ssm
    state has no KV cache, and the int8 setting leaves it as it is."""
    cfg, _ = _port_model(ref, arch, "bfloat16")
    bf = _port_runs(ref, arch, "bfloat16", False)["state"]
    q8 = _port_runs(ref, arch, "bfloat16", True)["state"]
    tag = f"{arch}/bfloat16"
    if cfg.family == "ssm":
        assert set(q8) == {"wkv", "shift_t", "shift_c"}
        for name in q8:
            assert torch.equal(q8[name], bf[name])
            np.testing.assert_array_equal(ref[f"{tag}/1/state/{name}"],
                                          ref[f"{tag}/0/state/{name}"])
        return
    kv_key = ""
    if cfg.family == "hybrid":
        assert set(q8) == {"mamba", "kv"}
        for name in q8["mamba"]:
            assert torch.equal(q8["mamba"][name], bf["mamba"][name])
        bf, q8, kv_key = bf["kv"], q8["kv"], "kv/"
    assert set(q8) == {"k", "v", "k_scale", "v_scale"}
    for name in ("k", "v"):
        same = (ref[f"{tag}/0/state/{kv_key}{name}"] == bf[name].float(
            ).numpy()).all(axis=-1)
        if cfg.family == "hybrid":
            # the first slot's K/V come after a group of Mamba2 layers,
            # whose bf16 roundings may fall one step apart
            assert same[0].mean() > 0.5, same.mean()
        else:
            # the first layer's K/V come from the same embedding through
            # rmsnorm, linear and rope: bit for bit
            assert same[0].all(), same.mean()
        np.testing.assert_array_equal(
            q8[name].numpy()[same], ref[f"{tag}/1/state/{kv_key}{name}"][same])
        np.testing.assert_array_equal(
            q8[name + "_scale"].numpy()[same],
            ref[f"{tag}/1/state/{kv_key}{name}_scale"][same])
        assert q8[name].dtype == torch.int8
    bf_d = _port_runs(ref, arch, "bfloat16", False)["dstate"]
    q8_d = _port_runs(ref, arch, "bfloat16", True)["dstate"]
    if cfg.family == "hybrid":
        bf_d, q8_d = bf_d["kv"], q8_d["kv"]
    steps = slice(P, P + T)
    for name in ("k", "v"):
        x = bf_d[name][0, :, steps]                 # (B, T, H, hd) bf16
        hd = x.shape[-1]
        same = (ref[f"{tag}/0/dstate/{kv_key}{name}"][0, :, steps]
                == x.float().numpy()).all(axis=-1).reshape(-1)
        assert (same.mean() > 0.5 if cfg.family == "hybrid"
                else same.all()), same.mean()
        q, sc = kref.group_quant(x.reshape(-1, hd), hd)
        got_q = q8_d[name][0, :, steps].reshape(-1, hd)
        got_s = q8_d[name + "_scale"][0, :, steps].reshape(-1)
        assert torch.equal(got_q, q) and torch.equal(got_s, sc[:, 0])
        # the reference's decode step runs jitted, so its scales follow
        # XLA's amax · float32(1/127) (ROADMAP §3); its codes equal the
        # port's wherever the scales do
        amax = x.float().abs().amax(dim=-1).reshape(-1).numpy()
        want_s = ref[f"{tag}/1/dstate/{kv_key}{name}_scale"][
            0, :, steps].reshape(-1)
        np.testing.assert_array_equal(want_s[same], np.where(
            amax > 0, amax * (np.float32(1) / np.float32(127)),
            np.float32(1)).astype(np.float32)[same])
        agree = (want_s == got_s.numpy()) & same
        assert agree.mean() > 0.5 * same.mean(), agree.mean()
        np.testing.assert_array_equal(
            got_q.numpy()[agree],
            ref[f"{tag}/1/dstate/{kv_key}{name}"][0, :, steps].reshape(
                -1, hd)[agree])


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_cache",
                                                        "int8_cache"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_first_token_matches_reference(ref, arch, kv_quant):
    cfg, params = _port_model(ref, arch, "bfloat16")
    want = ref[f"{arch}/bfloat16/{int(kv_quant)}/generate"]
    ops.reset_launches()
    got = ServingEngine(cfg, RunConfig(kv_quant=kv_quant), device="cpu"
                        ).generate(params, _inputs(cfg)["gen"],
                                   new_tokens=NEW).numpy()
    assert got.shape == want.shape == (B, NEW)
    share = float((got == want).mean())
    assert (got[:, 0] == want[:, 0]).all(), (
        f"first tokens {got[:, 0]} vs {want[:, 0]}; agreeing share over "
        f"{NEW} new tokens {share}")
    # CPU tensors run the plain versions: no kernel launches
    assert ops.launches["group_quant"] == 0


def test_sampled_generation_uses_the_generator(ref):
    cfg, params = _port_model(ref, "deepseek_7b", "bfloat16")
    eng = ServingEngine(cfg, RunConfig(kv_quant=True), device="cpu")
    prompts = _tokens(cfg, 5, (B, 6))
    a, b = (eng.generate(params, prompts, new_tokens=5, greedy=False,
                         generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert torch.equal(a, b) and a.shape == (B, 5)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


def test_params_from_reference_dtypes_and_checks(ref):
    """bf16 leaves arriving as ``ml_dtypes`` arrays or as float32 copies
    give the same bf16 tensors; a wrong shape or key set raises."""
    import ml_dtypes

    cfg, params = _port_model(ref, "starcoder2_3b", "bfloat16")
    tree32 = _ref_tree(ref, "starcoder2_3b", "bfloat16")
    as_bf16 = lambda t: {k: as_bf16(v) if isinstance(v, dict)
                         else v.astype(ml_dtypes.bfloat16)
                         for k, v in t.items()}
    back = params_from_reference(as_bf16(tree32), cfg, device="cpu")
    for name in ("embed", "lm_head"):
        assert back[name].dtype == torch.bfloat16
        assert torch.equal(back[name], params[name])
    assert torch.equal(back["layers"]["attn"]["bq"],
                       params["layers"]["attn"]["bq"])
    with pytest.raises(ValueError, match="lm_head"):
        params_from_reference(dict(tree32, lm_head=tree32["lm_head"][:, :5]),
                              cfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_reference({k: v for k, v in tree32.items()
                               if k != "embed"}, cfg, device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_from_reference_moe_tree(ref, arch):
    """An MoE tree carries across: the router stays float32 (its spec's
    dtype) and equals the reference's exactly; the expert leaves are bf16
    with the (layers, experts, …) axes kept."""
    cfg, params = _port_model(ref, arch, "bfloat16")
    tree = _ref_tree(ref, arch, "bfloat16")
    mlp = params["layers"]["mlp"]
    assert set(mlp) == {"ln", "router", "w_gate", "w_up", "w_down"}
    assert mlp["router"].dtype == torch.float32
    np.testing.assert_array_equal(mlp["router"].numpy(),
                                  tree["layers"]["mlp"]["router"])
    for name in ("w_gate", "w_up", "w_down"):
        assert mlp[name].dtype == torch.bfloat16
        assert mlp[name].shape[:2] == (cfg.n_layers, cfg.n_experts)
        np.testing.assert_array_equal(mlp[name].float().numpy(),
                                      tree["layers"]["mlp"][name])
    bad = dict(tree, layers=dict(tree["layers"], mlp={
        k: v for k, v in tree["layers"]["mlp"].items() if k != "router"}))
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(bad, cfg, device="cpu")


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_params_from_reference_recurrent_tree(ref, arch):
    """An RWKV6 or hybrid tree carries across: the leaves whose specs say
    float32 (``w0``, ``u_bonus``; ``a_log``, ``dt_bias``, ``d_skip``) stay
    float32 and equal the reference's exactly in a bf16 model; the
    hybrid's Mamba2 leaves keep their two stacked axes beside the
    unstacked shared blocks."""
    cfg, params = _port_model(ref, arch, "bfloat16")
    tree = _ref_tree(ref, arch, "bfloat16")
    lay = params["layers"]
    f32_leaves = (("w0", "u_bonus") if cfg.family == "ssm"
                  else ("a_log", "dt_bias", "d_skip"))
    for name in f32_leaves:
        assert lay[name].dtype == torch.float32
        np.testing.assert_array_equal(lay[name].numpy(),
                                      tree["layers"][name])
        assert np.abs(tree["layers"][name]).min() > 0   # redrawn non-zero
    lead = ((cfg.n_layers,) if cfg.family == "ssm" else
            (cfg.n_layers // cfg.shared_attn_every, cfg.shared_attn_every))
    for name, w in lay.items():
        assert tuple(w.shape[:len(lead)]) == lead, name
        if name not in f32_leaves:
            assert w.dtype == torch.bfloat16, name
    if cfg.family == "hybrid":
        assert params["shared_attn"]["wq"].shape == tuple(
            tree["shared_attn"]["wq"].shape)


@pytest.mark.parametrize("change, runs", [
    ({"family": "vlm", "input_mode": "embeddings"}, True),
    ({"family": "vision"}, False),
    ({"input_mode": "patches"}, False)],
    ids=["embeddings", "unknown_family", "unknown_input"])
def test_unported_families_raise(change, runs):
    """A family or an input mode the reference does not have raises; an
    embedding-input dense stack builds (no token table) and serves."""
    cfg = replace(smoke_config("deepseek_7b"), **change)
    if not runs:
        with pytest.raises(NotImplementedError, match="reference"):
            tmodel.model_specs(cfg)
        with pytest.raises(NotImplementedError):
            ServingEngine(cfg, RunConfig(), device="cpu")
        return
    specs = tmodel.model_specs(cfg)
    assert "embed" not in specs and set(specs["layers"]) == {"attn", "mlp"}
    eng = ServingEngine(cfg, RunConfig(), device="cpu")
    params = tlay.init_from_specs(specs, torch.Generator().manual_seed(0),
                                  device="cpu")
    emb = torch.randn((B, P, cfg.d_model),
                      generator=torch.Generator().manual_seed(1))
    logits, _ = eng.prefill(params, capacity=P + 1, embeds=emb)
    assert tuple(logits.shape) == (B, cfg.vocab_size)
    with pytest.raises(ValueError, match="embeds"):
        eng.generate(params, _tokens(cfg, 1, (B, P)), new_tokens=2)


def _decode_vs_train(cfg, params) -> float:
    """A prefill of S-1 tokens plus one decode step against the train
    logits at position S-1: relative max error."""
    S = 24
    tokens = torch.from_numpy(_tokens(cfg, 1, (B, S)))
    full, _ = tmodel.forward(params, cfg, tokens=tokens, mode="train")
    _, aux = tmodel.forward(params, cfg, tokens=tokens[:, :S - 1],
                            mode="prefill")
    dec, _ = tmodel.forward(params, cfg, tokens=tokens[:, S - 1:],
                            mode="decode",
                            state=grow_cache(aux["state"], 1, cfg),
                            cache_len=S - 1)
    return _rel(full[:, -1].float().numpy(), dec[:, 0])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_train_logits(ref, arch):
    """The port's own serve path: a prefill of S-1 tokens plus one decode
    step gives the train logits at position S-1 within 1e-2, as the
    reference's ``tests/test_models.py::test_decode_matches_train_logits``
    holds the reference.  MoE runs at a drop-free capacity there (factor
    64), since capacity is provisioned per token group and a prefill and
    a decode step group their tokens differently.  zamba2-2.7b keeps the
    reference test's 2e-2 for it (it reads 1.06e-2 here)."""
    cfg, params = _port_model(ref, arch, "bfloat16")
    if cfg.n_experts:
        cfg = replace(cfg, capacity_factor=64.0)
    rel = _decode_vs_train(cfg, params)
    assert rel <= fixture.tol("decode_vs_train", "bfloat16", arch), rel


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_decode_matches_train_logits_float32(ref, arch, monkeypatch):
    """The same in float32: rwkv6-7b within 1e-4 (the reference's own
    tolerance; it reads 2.5e-6 at smoke size); zamba2-2.7b within the
    bound its bf16 conv state sets (``make_card_reference.ARCH_TOL``),
    and, with the conv state kept in float32 instead, within 2e-3: the
    bf16 conv
    state is the cause.  RWKV's block runs in float32 and carries float32
    states, so only the chunked and the step form's summation orders
    differ (it reads 1.6e-6); zamba2's decode reads its conv state
    rounded to bf16, which the train path never does (the reference keeps
    it bf16 whatever the model's dtype; ROADMAP.md, queue 3): it reads
    2.98e-2, and 5.2e-4 with a float32 conv state."""
    cfg, params = _port_model(ref, arch, "float32")
    rel = _decode_vs_train(cfg, params)
    assert rel <= fixture.tol("decode_vs_train", "float32", arch), rel
    if cfg.family == "hybrid":
        init = tmodel.init_mamba_state
        monkeypatch.setattr(tmodel, "init_mamba_state", lambda *a, **kw: {
            k: v.float() for k, v in init(*a, **kw).items()})
        rel32 = _decode_vs_train(cfg, params)
        assert rel32 <= 2e-3 and rel32 < rel / 10, (rel32, rel)


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = smoke_config("deepseek_7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, RunConfig(kv_quant=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlay.init_from_specs(tmodel.model_specs(cfg), torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_reference({}, cfg)
    from repro_torch.core import entropy
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entropy.get_engine()


if __name__ == "__main__":
    _reference_outputs(sys.argv[1])
