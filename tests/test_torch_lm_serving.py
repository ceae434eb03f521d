"""The LM serving slice against the reference, on the CPU.

Smoke configs of the dense token-input decoders without experts —
deepseek-7b (MHA, SwiGLU), starcoder2-3b (GQA kv=2, QKV bias, GELU),
qwen1.5-32b (MHA, QKV bias) and llama3-405b (GQA, rope θ 5·10⁵) — run
through ``repro.serving.engine`` and ``repro_torch.serving.engine`` with
the same parameters (the reference's ``init_from_specs`` at
``PRNGKey(0)``, carried over as float32 copies by
``params_from_reference``) and the same seeded prompts.

The reference runs in a child process (this file run as a script) with
``--xla_allow_excess_precision=false``, so that it rounds to bf16 where
its code says so.  With XLA's default, a jitted program may skip a
rounding inside a fusion (the attention output projection and the
residual sum reach the next ``rmsnorm`` unrounded), and that alone moves
the reference's own bf16 smoke logits by 1.2–3.5 %: more than the
tolerance below, and no property of either program's algorithm.

Tolerances:

* bf16 models: relative max error ≤ 1e-2 on logits, the tolerance of
  the reference's own decode-vs-train test (``tests/test_models.py``):
  bf16 roundings may fall one step apart where the two frameworks'
  float32 sums differ in the last bit;
* float32 models: ≤ 1e-4, where only float32 summation order differs, so
  a wrong order of operations (a missed rounding of the cache to bf16,
  the int8 scales applied elsewhere) cannot hide;
* the int8 cache: codes and scales equal wherever both frameworks
  quantized the same bf16 K/V vector (every vector of the first layer);
* greedy generation: the first token equal.
"""
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
from repro_torch.models import layers as tlay
from repro_torch.models import model as tmodel
from repro_torch.serving import ServingEngine, make_prefill_step, make_serve_step
from repro_torch.serving.engine import grow_cache

ARCHS = ["deepseek_7b", "starcoder2_3b", "qwen1_5_32b", "llama3_405b"]
DTYPES = ["bfloat16", "float32"]
B, P, T, NEW = 2, 9, 4, 6
TOL = {"bfloat16": 1e-2, "float32": 1e-4}


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
    out = {}
    for arch in ARCHS:
        for dtype in DTYPES:
            cfg = replace(r_smoke(arch), dtype=dtype)
            tag = f"{arch}/{dtype}"
            params = rlay.init_from_specs(rmodel.model_specs(cfg),
                                          jax.random.PRNGKey(0))
            for path_, leaf in jax.tree_util.tree_leaves_with_path(params):
                name = "/".join(k.key for k in path_)
                out[f"{tag}/params/{name}"] = f32(leaf)
            inp = _inputs(cfg)
            logits, _ = rmodel.forward(params, cfg, mode="train",
                                       tokens=jnp.asarray(inp["train"]))
            out[f"{tag}/train"] = f32(logits)
            for kv_quant in (False, True):
                run = RRun(kv_quant=kv_quant)
                qtag = f"{tag}/{int(kv_quant)}"
                # the prefill runs eagerly, as the engine's unit; the
                # decode step jitted once for all positions
                lg, state = rengine.make_prefill_step(cfg, run)(
                    params, {"tokens": jnp.asarray(inp["prompts"])})
                out[f"{qtag}/prefill"] = f32(lg)
                for name, a in state.items():
                    out[f"{qtag}/state/{name}"] = (
                        np.asarray(a) if a.dtype == jnp.int8 else f32(a))
                st = jax.tree.map(
                    lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, T)]
                                      + [(0, 0)] * (a.ndim - 3)), state)
                serve = jax.jit(rengine.make_serve_step(cfg, run))
                for i in range(T):
                    lg, st = serve(params, st, {"tokens": jnp.asarray(
                        inp["forced"][:, i:i + 1])}, jnp.int32(P + i))
                    out[f"{qtag}/decode{i}"] = f32(lg)
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
        cfg = replace(smoke_config(arch), dtype=dtype)
        _PORT[key] = (cfg, params_from_reference(_ref_tree(ref, arch, dtype),
                                                 cfg, device="cpu"))
    return _PORT[key]


def _port_runs(ref, arch: str, dtype: str, kv_quant: bool) -> dict:
    """The port's prefill of P tokens and T teacher-forced decode steps."""
    key = (arch, dtype, kv_quant)
    if key not in _PORT:
        cfg, params = _port_model(ref, arch, dtype)
        inp = _inputs(cfg)
        run = RunConfig(kv_quant=kv_quant)
        lg, state = make_prefill_step(cfg, run)(
            params, {"tokens": torch.from_numpy(inp["prompts"])})
        res = {"prefill": lg, "state": state, "decode": []}
        step = make_serve_step(cfg, run)
        st = grow_cache(state, T)
        for i in range(T):
            lg, st = step(params, st, {"tokens": torch.from_numpy(
                inp["forced"][:, i:i + 1])}, P + i)
            res["decode"].append(lg)
        _PORT[key] = res
    return _PORT[key]


def test_configs_match_reference():
    for arch in R_ARCH_IDS:
        if arch in PORTED_IDS:
            assert asdict(get_config(arch)) == asdict(r_get(arch))
            assert asdict(smoke_config(arch)) == asdict(r_smoke(arch))
        else:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                get_config(arch)
    with pytest.raises(KeyError):
        get_config("gpt2")
    assert set(PORTED_IDS) == set(ARCHS)


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
@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_reference(ref, arch, dtype):
    cfg, params = _port_model(ref, arch, dtype)
    got, aux = tmodel.forward(params, cfg, mode="train",
                              tokens=torch.from_numpy(_inputs(cfg)["train"]))
    want = ref[f"{arch}/{dtype}/train"]
    assert tuple(got.shape) == want.shape and aux["state"] is None
    rel = _rel(want, got)
    assert rel <= TOL[dtype], rel


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_cache",
                                                        "int8_cache"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(ref, arch, dtype,
                                                   kv_quant):
    """Prefill's last-position logits, then the logits of each decode
    step teacher-forced with the same tokens."""
    port = _port_runs(ref, arch, dtype, kv_quant)
    tag = f"{arch}/{dtype}/{int(kv_quant)}"
    assert tuple(port["prefill"].shape) == ref[f"{tag}/prefill"].shape
    rels = [_rel(ref[f"{tag}/prefill"], port["prefill"])] + [
        _rel(ref[f"{tag}/decode{i}"], lg)
        for i, lg in enumerate(port["decode"])]
    assert max(rels) <= TOL[dtype], rels
    for lg in port["decode"]:
        assert bool(torch.isfinite(lg.float()).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_cache_codes_match_reference(ref, arch):
    """Wherever the two prefills produced the same bf16 K/V vector, the
    int8 caches of the serving path hold the same codes and scales."""
    bf = _port_runs(ref, arch, "bfloat16", False)["state"]
    q8 = _port_runs(ref, arch, "bfloat16", True)["state"]
    assert set(q8) == {"k", "v", "k_scale", "v_scale"}
    tag = f"{arch}/bfloat16"
    for name in ("k", "v"):
        same = (ref[f"{tag}/0/state/{name}"] == bf[name].float().numpy()
                ).all(axis=-1)
        # the first layer's K/V come from the same embedding through
        # rmsnorm, linear and rope: bit for bit
        assert same[0].all(), same.mean()
        np.testing.assert_array_equal(q8[name].numpy()[same],
                                      ref[f"{tag}/1/state/{name}"][same])
        np.testing.assert_array_equal(
            q8[name + "_scale"].numpy()[same],
            ref[f"{tag}/1/state/{name}_scale"][same])
        assert q8[name].dtype == torch.int8


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


def test_unported_families_raise():
    cfg = replace(smoke_config("deepseek_7b"), family="moe", n_experts=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodel.model_specs(cfg)
    with pytest.raises(NotImplementedError):
        ServingEngine(cfg, RunConfig(), device="cpu")


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


if __name__ == "__main__":
    _reference_outputs(sys.argv[1])
