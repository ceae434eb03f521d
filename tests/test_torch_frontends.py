"""The embedding-input decoders against the reference, on the CPU.

internvl2-76b (vlm) and musicgen-medium (audio, an ungated GELU MLP) are
the dense stack fed by frontend embeddings (``input_mode="embeddings"``):
no ``embed`` table, and the embeddings are cast to the model's dtype
before the first block.  At their smoke configs, on the same
numpy-seeded parameters (``make_card_reference.model_tree``) and the
same seeded embeddings (N(0, 1) · 0.02 in float32, as the reference's
stub frontend makes them), ``repro_torch``'s ``forward`` (train,
prefill, decode) and ``ServingEngine.prefill``/``decode`` are held
against ``repro.models.model.forward`` and the reference engine's
``make_prefill_step``/``make_serve_step``.

The reference runs in a child process (this file run as a script) with
``--xla_allow_excess_precision=false``, as in
``tests/test_torch_lm_serving.py``.  Tolerances, from the shared table
(``make_card_reference.TOL``, ``ARCH_TOL``): train and prefill logits
within 1e-4 relative max error in float32 and 1e-2 in bf16
(``"logits"``); decode steps (``"steps"``) within 1e-2 in bf16 and 2e-3
in float32, since a float32 model's decode reads the bf16 cache, where
1–3 of the second layer's 4,608 K/V values round to the other bf16
neighbour (their float32 values differ in the last bit; 1.9e-4 read
here, 8.4e-4 on the card); the int8
cache's codes and scales equal wherever the two
prefills produced the same bf16 K/V vector (every vector of the first
layer).
"""
import importlib.util
import os
import subprocess
import sys
from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

from repro_torch.configs import RunConfig, get_config, smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.kernels import ops
from repro_torch.models import model as tmodel
from repro_torch.serving import ServingEngine
from repro_torch.serving.engine import grow_cache

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "make_card_reference",
    os.path.join(HERE, "card_reference", "make_card_reference.py"))
fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture)

ARCHS = ["musicgen_medium", "internvl2_76b"]
DTYPES = ["float32", "bfloat16"]
B, P, T, S_TRAIN = 2, 9, 4, 12
SEED = fixture.FRONTEND_SEED
#: the reference's param_counts at full size, and internvl2-76b cut to
#: the 16 layers that chip_smoke.py serves
FULL_COUNTS = {"internvl2_76b": 69503033344, "musicgen_medium": 1362249216}
INTERNVL2_16_LAYERS = 14741151744


def _cfg(smoke, arch: str, dtype: str):
    return replace(smoke(arch), dtype=dtype)


def _inputs(cfg) -> dict:
    """Train embeddings (B, 12, d), a prompt (B, P, d) and the embeddings
    of T teacher-forced decode steps (B, T, d)."""
    rng = np.random.default_rng(SEED + 3)
    d = cfg.d_model
    return {"train": fixture.embeddings(rng, (B, S_TRAIN, d)),
            "prompt": fixture.embeddings(rng, (B, P, d)),
            "forced": fixture.embeddings(rng, (B, T, d))}


def _reference_outputs(path: str) -> None:
    """Run the reference on every case and save its outputs to ``path``
    (the child process's work; XLA flags are set by the parent)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import RunConfig as RRun
    from repro.configs import smoke_config as r_smoke
    from repro.models import model as rmodel
    from repro.serving import engine as rengine

    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    out = {}
    for arch in ARCHS:
        for dtype in DTYPES:
            cfg = _cfg(r_smoke, arch, dtype)
            specs = rmodel.model_specs(cfg)
            params = fixture._as_reference(
                fixture.model_tree(specs, cfg, SEED), specs)
            inp = {k: jnp.asarray(v) for k, v in _inputs(cfg).items()}
            tag = f"{arch}/{dtype}"
            logits, _ = rmodel.forward(params, cfg, embeds=inp["train"],
                                       mode="train")
            out[f"{tag}/train"] = f32(logits)
            logits, aux = rmodel.forward(params, cfg, embeds=inp["prompt"],
                                         mode="prefill")
            out[f"{tag}/forward_prefill"] = f32(logits)
            run = RRun(kv_quant=False)
            state = rengine.ServingEngine(cfg, run)._grow_cache(
                aux["state"], 1)
            logits, _ = rmodel.forward(params, cfg,
                                       embeds=inp["forced"][:, :1],
                                       mode="decode", state=state,
                                       cache_len=jnp.int32(P))
            out[f"{tag}/forward_decode"] = f32(logits)
            for kv_quant in (False, True):
                run = RRun(kv_quant=kv_quant)
                qtag = f"{tag}/{int(kv_quant)}"
                lg, state = rengine.make_prefill_step(cfg, run)(
                    params, {"embeds": inp["prompt"]})
                out[f"{qtag}/prefill"] = f32(lg)
                if dtype == "bfloat16":
                    for name, a in state.items():
                        out[f"{qtag}/state/{name}"] = (
                            np.asarray(a) if a.dtype == jnp.int8 else f32(a))
                st = rengine.ServingEngine(cfg, run)._grow_cache(state, T)
                serve = jax.jit(rengine.make_serve_step(cfg, run))
                for i in range(T):
                    lg, st = serve(params, st,
                                   {"embeds": inp["forced"][:, i:i + 1]},
                                   jnp.int32(P + i))
                    out[f"{qtag}/decode{i}"] = f32(lg)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("frontend_ref") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(os.path.join(HERE, "..", "src"))]
        + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _rel(a: np.ndarray, b: torch.Tensor) -> float:
    b = b.float().numpy()
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


_PORT: dict = {}


def _port_model(arch: str, dtype: str):
    """(port cfg, port params) on the numpy-seeded tree."""
    key = (arch, dtype)
    if key not in _PORT:
        cfg = _cfg(smoke_config, arch, dtype)
        tree = fixture.model_tree(tmodel.model_specs(cfg), cfg, SEED)
        _PORT[key] = (cfg, params_from_reference(tree, cfg, device="cpu"))
    return _PORT[key]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    from repro.configs import get_config as r_get
    from repro.configs import smoke_config as r_smoke

    assert asdict(get_config(arch)) == asdict(r_get(arch))
    assert asdict(smoke_config(arch)) == asdict(r_smoke(arch))
    cfg = get_config(arch)
    assert cfg.input_mode == "embeddings" and cfg.family in ("vlm", "audio")


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_param_counts_match_reference(arch):
    """The spec tree equals the reference's and has no ``embed`` leaf;
    ``param_counts`` gives the reference's figures at full size (and at
    internvl2-76b's 16 of 80 layers, the depth the card serves)."""
    from repro.configs import get_config as r_get
    from repro.configs import smoke_config as r_smoke
    from repro.models import model as rmodel

    def leaves(specs):
        return {k: (tuple(v.shape), v.dtype, v.init) for k, v in
                fixture.flat(specs).items()}

    for cfg, rcfg in ((smoke_config(arch), r_smoke(arch)),
                      (get_config(arch), r_get(arch))):
        specs = tmodel.model_specs(cfg)
        assert "embed" not in specs
        assert leaves(specs) == leaves(rmodel.model_specs(rcfg))
    got = tmodel.param_counts(get_config(arch))
    assert got == rmodel.param_counts(r_get(arch)) == (FULL_COUNTS[arch],) * 2
    if arch == "internvl2_76b":
        cut = tmodel.param_counts(replace(get_config(arch), n_layers=16))
        assert cut == rmodel.param_counts(replace(r_get(arch), n_layers=16))
        assert cut == (INTERNVL2_16_LAYERS,) * 2
    if arch == "musicgen_medium":
        # the ungated GELU MLP: no w_gate
        assert set(tmodel.model_specs(get_config(arch))["layers"]["mlp"]) \
            == {"ln", "w_up", "w_down"}


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(ref, arch, dtype, mode):
    """``forward`` with ``embeds=`` in each mode: train logits, a prefill's
    last-position logits, and one decode step after it (bf16 cache)."""
    cfg, params = _port_model(arch, dtype)
    inp = _inputs(cfg)
    tag = f"{arch}/{dtype}"
    if mode == "train":
        got, aux = tmodel.forward(params, cfg, embeds=_t(inp["train"]),
                                  mode="train")
        want, kind = ref[f"{tag}/train"], "logits"
        assert aux["state"] is None and float(aux["moe_aux"]) == 0.0
    else:
        got, aux = tmodel.forward(params, cfg, embeds=_t(inp["prompt"]),
                                  mode="prefill")
        want, kind = ref[f"{tag}/forward_prefill"], "logits"
        if mode == "decode":
            got, _ = tmodel.forward(params, cfg,
                                    embeds=_t(inp["forced"][:, :1]),
                                    mode="decode",
                                    state=grow_cache(aux["state"], 1, cfg),
                                    cache_len=P)
            want, kind = ref[f"{tag}/forward_decode"], "steps"
    assert tuple(got.shape) == want.shape
    assert got.dtype == tmodel.DTYPES[dtype]
    rel = _rel(want, got)
    assert rel <= fixture.tol(kind, dtype, arch), rel


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_cache",
                                                        "int8_cache"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(ref, arch, dtype, kv_quant):
    """``ServingEngine.prefill`` (embeds (B, P, d)) and 4 ``decode`` steps
    (embeds (B, d)) against the reference's prefill and serve steps; on
    CPU tensors the plain versions run, so no kernel launches."""
    cfg, params = _port_model(arch, dtype)
    inp = _inputs(cfg)
    eng = ServingEngine(cfg, RunConfig(kv_quant=kv_quant), device="cpu")
    ops.reset_launches()
    logits, state = eng.prefill(params, embeds=_t(inp["prompt"]),
                                capacity=P + T)
    tag = f"{arch}/{dtype}/{int(kv_quant)}"
    assert tuple(logits.shape) == ref[f"{tag}/prefill"].shape
    rel = _rel(ref[f"{tag}/prefill"], logits)
    assert rel <= fixture.tol("logits", dtype), rel
    assert set(state) == ({"k", "v", "k_scale", "v_scale"} if kv_quant
                          else {"k", "v"})
    assert state["k"].shape[:3] == (cfg.n_layers, B, P + T)
    rels = []
    for i in range(T):
        logits, state = eng.decode(params, state,
                                   embeds=_t(inp["forced"][:, i]),
                                   cache_len=P + i)
        rels.append(_rel(ref[f"{tag}/decode{i}"], logits))
    assert max(rels) <= fixture.tol("steps", dtype, arch), rels
    assert sum(ops.launches.values()) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_cache_codes_match_reference(ref, arch):
    """The first layer's K/V come from the same embeddings through
    rmsnorm, linear and rope, bit for bit, so the int8 prefill caches
    hold the reference's codes and scales there."""
    cfg, params = _port_model(arch, "bfloat16")
    inp = _inputs(cfg)
    run_b, run_q = RunConfig(kv_quant=False), RunConfig(kv_quant=True)
    from repro_torch.serving import make_prefill_step

    _, bf = make_prefill_step(cfg, run_b)(params,
                                          {"embeds": _t(inp["prompt"])})
    _, q8 = make_prefill_step(cfg, run_q)(params,
                                          {"embeds": _t(inp["prompt"])})
    tag = f"{arch}/bfloat16"
    for name in ("k", "v"):
        np.testing.assert_array_equal(bf[name][0].float().numpy(),
                                      ref[f"{tag}/0/state/{name}"][0])
        np.testing.assert_array_equal(q8[name][0].numpy(),
                                      ref[f"{tag}/1/state/{name}"][0])
        np.testing.assert_array_equal(q8[name + "_scale"][0].numpy(),
                                      ref[f"{tag}/1/state/{name}_scale"][0])
        assert q8[name].dtype == torch.int8


@pytest.mark.parametrize("arch", ARCHS)
def test_embeddings_cast_to_model_dtype(arch):
    """The embeddings are cast to the model's dtype before the first
    block: float32 and float64 inputs give the logits of their bf16
    rounding, bit for bit."""
    cfg, params = _port_model(arch, "bfloat16")
    emb = _t(_inputs(cfg)["train"])
    want, _ = tmodel.forward(params, cfg, embeds=emb.bfloat16(),
                             mode="train")
    for x in (emb, emb.double()):
        got, _ = tmodel.forward(params, cfg, embeds=x, mode="train")
        assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_raises_in_both_packages(arch):
    """Neither package maps a sampled token back to a frontend
    embedding: the reference's ``generate`` fails on its missing
    ``batch["embeds"]``, the port's raises and names ``prefill``/``decode``
    with ``embeds=``."""
    import jax.numpy as jnp

    from repro.configs import RunConfig as RRun
    from repro.configs import smoke_config as r_smoke
    from repro.models import layers as rlay
    from repro.models import model as rmodel
    from repro.serving import engine as rengine

    cfg, params = _port_model(arch, "bfloat16")
    prompts = np.zeros((B, P), np.int64)
    with pytest.raises(ValueError, match="prefill.*embeds.*decode"):
        ServingEngine(cfg, RunConfig(), device="cpu").generate(
            params, prompts, new_tokens=2)
    rcfg = r_smoke(arch)
    import jax

    rparams = rlay.init_from_specs(rmodel.model_specs(rcfg),
                                   jax.random.PRNGKey(0))
    with pytest.raises(KeyError, match="embeds"):
        rengine.ServingEngine(rcfg, RRun()).generate(
            rparams, jnp.asarray(prompts), new_tokens=2)


def test_inputs_of_the_wrong_kind_raise():
    """Token ids for an embedding-input config, embeddings for a token
    one, or embeddings of the wrong width raise."""
    cfg, params = _port_model("musicgen_medium", "float32")
    emb = _t(_inputs(cfg)["train"])
    tok = torch.zeros((B, S_TRAIN), dtype=torch.long)
    with pytest.raises(ValueError, match="embeds"):
        tmodel.forward(params, cfg, tokens=tok, mode="train")
    with pytest.raises(ValueError, match=r"\(B, S, 128\)"):
        tmodel.forward(params, cfg, embeds=emb[..., :64], mode="train")
    eng = ServingEngine(cfg, RunConfig(), device="cpu")
    with pytest.raises(ValueError, match="embeds"):
        eng.prefill(params, tok, capacity=S_TRAIN)
    with pytest.raises(ValueError, match="axes"):
        eng.prefill(params, embeds=emb[0], capacity=S_TRAIN)
    dcfg = smoke_config("deepseek_7b")
    with pytest.raises(ValueError, match="token ids"):
        tmodel.forward({}, dcfg, embeds=emb, mode="train")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_train_logits(arch):
    """The port's own serve path: a prefill of S-1 positions plus one
    decode step gives the train logits at position S-1 within 1e-2 in
    bf16, as the reference's own decode-vs-train test holds it."""
    cfg, params = _port_model(arch, "bfloat16")
    emb = _t(_inputs(cfg)["train"])
    full, _ = tmodel.forward(params, cfg, embeds=emb, mode="train")
    _, aux = tmodel.forward(params, cfg, embeds=emb[:, :-1], mode="prefill")
    dec, _ = tmodel.forward(params, cfg, embeds=emb[:, -1:], mode="decode",
                            state=grow_cache(aux["state"], 1, cfg),
                            cache_len=S_TRAIN - 1)
    rel = _rel(full[:, -1].float().numpy(), dec[:, 0])
    assert rel <= fixture.tol("decode_vs_train", "bfloat16"), rel


if __name__ == "__main__":
    _reference_outputs(sys.argv[1])
