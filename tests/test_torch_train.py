"""The single-card train step against the reference's unsharded
functions, on the CPU.

``repro_torch.optim`` (AdamW, Adafactor, the int8 gradient exchange) and
``repro_torch.launch.train`` (``loss_fn``, the gradients, microbatching,
remat, the plain and the replicated step) against ``repro.optim`` and
``repro.launch.train``.  The reference's step builders need a mesh, and
its sharded train tests are red on this tree (ROADMAP.md, queue 3); its
``loss_fn`` under ``jax.value_and_grad``, its ``_microbatched_grads`` and
its update functions run without one, and are what the port is held to.

Models: one smoke config of each family — deepseek-7b (dense, tokens),
granite-moe-1b-a400m (MoE), rwkv6-7b (ssm), zamba2-2.7b cut to one group
(hybrid, as ``ARCH_TOL`` cuts it), internvl2-76b and musicgen-medium
(embeddings) — on numpy-seeded trees and batches
(``make_card_reference.model_tree``, ``train_batch``), run by the
reference in a child process (this file run as a script) with
``--xla_allow_excess_precision=false``.  The optimizer and exchange tests
run the reference eagerly in the test bodies.

Tolerances (the shared table, ``make_card_reference.TOL``):

* the schedule, the bias corrections and Adafactor's ``beta2``: float32,
  equal to the reference's wherever no ``cos``/``pow`` of a non-trivial
  argument enters (the warmup), else within one ulp (XLA's ``cos`` and
  ``pow`` differ from libm's in the last bit);
* losses 1e-6 (float32) and 1e-4 (bf16) relative; gradients, each leaf's
  relative max error, 1e-5 and 2.5e-2;
* an optimizer step from the same gradients: each float32 parameter
  within 1e-5 of its update's largest magnitude plus one ulp of itself;
  a bf16 parameter equal, or one bf16 step away in at most 1 % of a
  leaf's values (where the float32 update straddles a rounding);
* a whole train step: the reference's update applied to the step's
  own gradients (which the gradient tolerance holds), at the update's
  tolerance: Adam's first step divides each gradient by its own
  magnitude, so a gradient near ``eps`` turns a 1e-8 relative difference
  of its leaf into a visible one;
* the gradient exchange's codes, scales, mean and residuals: bit for bit
  against the reference's eager ``_quant_leaf``/``_dequant_leaf``.
"""
import importlib.util
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import RunConfig, smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.optim import adafactor as tada
from repro_torch.optim import adamw as tadam
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim.tree import replica

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "make_card_reference",
    os.path.join(HERE, "card_reference", "make_card_reference.py"))
fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture)

#: one smoke model of each family; ``arch@g``: cut to its first g groups
MODELS = ["deepseek_7b", "granite_moe_1b_a400m", "rwkv6_7b",
          "zamba2_2_7b@1", "internvl2_76b", "musicgen_medium"]
DTYPES = ["float32", "bfloat16"]
#: (model, dtype) pairs the microbatched gradients are held at
MICRO = [("deepseek_7b", "float32"), ("musicgen_medium", "float32"),
         ("granite_moe_1b_a400m", "bfloat16")]
SEED = 31
BATCH = (4, 16)
#: the model whose two batch halves the reference also runs, one a
#: replica of the compressed step
PODS_MODEL = ("musicgen_medium", "float32")


def _cfg(smoke, model: str, dtype: str):
    arch, _, groups = model.partition("@")
    cfg = replace(smoke(arch), dtype=dtype)
    if groups:
        cfg = replace(cfg, n_layers=int(groups) * cfg.shared_attn_every)
    return cfg


def _batch(cfg) -> dict:
    return fixture.train_batch(cfg, BATCH, SEED + 1)


def _halves(batch: dict) -> list:
    """The batch's two halves along its leading axis, as the two-replica
    step splits it."""
    h = BATCH[0] // 2
    return [{k: v[r * h:(r + 1) * h] for k, v in batch.items()}
            for r in range(2)]


def _reference_outputs(path: str) -> None:
    """Loss, metrics and gradients of every model (and the microbatched
    ones of ``MICRO``) from the reference, saved to ``path``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import RunConfig as RRun
    from repro.configs import smoke_config as r_smoke
    from repro.launch.train import _microbatched_grads, loss_fn
    from repro.models import model as rmodel

    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    out = {}

    def save(tag, loss, metrics, grads):
        out[f"{tag}/loss"] = f32(loss)
        for k, v in metrics.items():
            out[f"{tag}/{k}"] = f32(v)
        for k, v in fixture.flat(grads).items():
            out[f"{tag}/grads/{k}"] = f32(v)
            out[f"{tag}/dtype/{k}"] = np.asarray(str(v.dtype))

    for model in MODELS:
        for dtype in DTYPES:
            cfg = _cfg(r_smoke, model, dtype)
            specs = rmodel.model_specs(cfg)
            params = fixture._as_reference(
                fixture.model_tree(specs, cfg, SEED), specs)
            batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
            (loss, metrics), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, batch, cfg, RRun())
            save(f"{model}/{dtype}", loss, metrics, grads)
            if (model, dtype) in MICRO:
                loss, metrics, grads = _microbatched_grads(
                    params, batch, cfg, RRun(microbatches=2))
                save(f"{model}/{dtype}/mb2", loss, metrics, grads)
            if (model, dtype) == PODS_MODEL:
                for r, half in enumerate(_halves(batch)):
                    (loss, metrics), grads = jax.value_and_grad(
                        loss_fn, has_aux=True)(params, half, cfg, RRun())
                    save(f"{model}/{dtype}/half{r}", loss, metrics, grads)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("train_ref") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(os.path.join(HERE, "..", "src"))]
        + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _rel(want: np.ndarray, got) -> float:
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    want = np.asarray(want, np.float64)
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-30))


def _np(x) -> np.ndarray:
    """float32 numpy copy of a tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    import jax.numpy as jnp
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


_PORT: dict = {}


def _port_model(model: str, dtype: str):
    key = (model, dtype)
    if key not in _PORT:
        cfg = _cfg(smoke_config, model, dtype)
        tree = fixture.model_tree(tmodel.model_specs(cfg), cfg, SEED)
        _PORT[key] = (cfg, params_from_reference(tree, cfg, device="cpu"))
    return _PORT[key]


def _port_batch(cfg) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in _batch(cfg).items()}


# ----------------------------------------------------------- scalars

def test_lr_schedule_and_beta2_match_reference():
    import jax.numpy as jnp

    from repro.optim import adafactor as rada
    from repro.optim import adamw as radam

    for warm, total in ((3, 50), (1, 10), (100, 10_000), (0, 7)):
        rcfg = radam.AdamWConfig(lr=1e-3, warmup_steps=warm,
                                 total_steps=total)
        cfg = tadam.AdamWConfig(lr=1e-3, warmup_steps=warm,
                                total_steps=total)
        for step in list(range(0, 60)) + [total, total + 5, 5000]:
            want = np.asarray(radam.lr_schedule(rcfg, jnp.int32(step)))
            got = tadam.lr_schedule(cfg, step)
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            if step <= warm:
                # the warmup: cos(0) = 1, the rest is float32 arithmetic
                assert got.numpy() == want, (warm, step)
            else:
                # one ulp of cos(πt), through 0.45 · lr, and the rounding
                # of the result (the sum 0.1 + 0.9 · cos cancels near
                # t = 1, so ulps of the result alone would not bound it)
                err = abs(float(got) - float(want))
                assert err <= 1e-3 * 2 ** -24 + float(np.spacing(want)), (
                    warm, step, err)
    for decay in (0.8, 0.5):
        rcfg = rada.AdafactorConfig(decay=decay)
        cfg = tada.AdafactorConfig(decay=decay)
        for step in range(1, 200):
            t = jnp.int32(step).astype(jnp.float32)
            want = np.asarray(1.0 - t ** (-rcfg.decay))
            got = tada.adafactor_beta2(cfg, step).numpy()
            assert _ulps(got, want) <= 1, (decay, step)
            if step in (1, 4, 16) and decay == 0.5:
                assert got == want          # exact powers
    for b in (0.9, 0.95, 0.999):
        for step in range(1, 100):
            want = np.asarray(1 - b ** jnp.int32(step).astype(jnp.float32))
            got = (1 - b ** torch.tensor(step, dtype=torch.float32)).numpy()
            assert _ulps(got, want) <= 1, (b, step)


# ----------------------------------------------------------- optimizers

SHAPES = {"w": (48, 40), "stack": {"a": (3, 24, 40), "col": (2, 5, 1)},
          "v1": (70,), "one": (1,)}
OPTIMIZERS = {
    "adamw": lambda m: (m.AdamWConfig(lr=1e-2, warmup_steps=2,
                                      total_steps=5),),
    "adafactor_b0": lambda m: (m.AdafactorConfig(
        lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.01),),
    "adafactor_b09": lambda m: (m.AdafactorConfig(
        lr=1e-2, warmup_steps=2, total_steps=5, beta1=0.9,
        weight_decay=0.01, moments_dtype="float32"),),
}


def _draw(rng, shapes) -> dict:
    return {k: _draw(rng, v) if isinstance(v, dict)
            else rng.standard_normal(v).astype(np.float32)
            for k, v in shapes.items()}


def _check_update(want_new, got_new, old, dtype: str, tol: float) -> None:
    """Each leaf of ``got_new`` against ``want_new`` (see the module's
    tolerances); ``old`` the parameters before the step."""
    w_of, g_of, o_of = (fixture.flat(t) for t in (want_new, got_new, old))
    for path in w_of:
        w, g, o = _np(w_of[path]), _np(g_of[path]), _np(o_of[path])
        assert g.shape == w.shape, path
        if dtype == "bfloat16":
            step = np.spacing(np.abs(w).astype(np.float32)) * 2 ** 16
            diff = np.abs(g - w)
            assert (diff <= step).all(), path
            assert (diff > 0).mean() <= 0.01, (path, (diff > 0).mean())
        else:
            limit = tol * np.abs(w - o).max() + np.spacing(np.abs(w))
            assert (np.abs(g - w) <= limit).all(), (
                path, float(np.abs(g - w).max()), float(limit.max()))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_match_reference(name, dtype):
    """Three steps of ``adamw_update`` / ``adafactor_update`` on the same
    numpy parameters and gradients: 2-D, stacked 3-D (factored per
    layer), a (…, 5, 1) leaf and 1-D leaves (kept whole), beta1 0 (no
    first moment) and 0.9; the state's layout equals the reference's."""
    import jax.numpy as jnp

    from repro.optim import adafactor as rada
    from repro.optim import adamw as radam

    rmod, tmod = ((radam, tadam) if name == "adamw" else (rada, tada))
    rcfg, = OPTIMIZERS[name](rmod)
    cfg, = OPTIMIZERS[name](tmod)
    rinit, rupd = ((radam.adamw_init, radam.adamw_update) if name == "adamw"
                   else (rada.adafactor_init, rada.adafactor_update))
    tinit, tupd = ((tadam.adamw_init, tadam.adamw_update) if name == "adamw"
                   else (tada.adafactor_init, tada.adafactor_update))
    rng = np.random.default_rng(7)
    tdt = getattr(torch, dtype)
    as_r = lambda t: {k: as_r(v) if isinstance(v, dict)
                      else jnp.asarray(v).astype(dtype) for k, v in t.items()}
    as_t = lambda t: {k: as_t(v) if isinstance(v, dict)
                      else torch.from_numpy(v).to(tdt) for k, v in t.items()}
    p0 = _draw(rng, SHAPES)
    rp, tp = as_r(p0), as_t(p0)
    rs, ts = rinit(rp, rcfg), tinit(tp, cfg)
    assert {k: tuple(np.shape(v)) for k, v in fixture.flat(
        {k: v for k, v in ts.items() if k != "step"}).items()} == {
        k: tuple(np.shape(v)) for k, v in fixture.flat(
            {k: v for k, v in rs.items() if k != "step"}).items()}
    assert ("mu" in ts) == ("mu" in rs)
    for _ in range(3):
        g = _draw(rng, SHAPES)
        r_old, t_old = rp, tp
        rp, rs, rstats = rupd(rp, as_r(g), rs, rcfg)
        tp, ts, tstats = tupd(tp, as_t(g), ts, cfg)
        assert int(ts["step"]) == int(rs["step"])
        assert _ulps(tstats["lr"].numpy(), np.asarray(rstats["lr"])) <= 1
        assert abs(float(tstats["grad_norm"]) - float(rstats["grad_norm"])
                   ) <= 1e-5 * float(rstats["grad_norm"])
        _check_update(rp, tp, r_old, dtype,
                      fixture.TOL["update"]["float32"])
        # the inputs are left as they are (the functional form)
        for path, leaf in fixture.flat(t_old).items():
            assert leaf.dtype == tdt


def test_inplace_update_equals_functional():
    cfg = tadam.AdamWConfig(lr=1e-2, warmup_steps=1)
    rng = np.random.default_rng(3)
    p = {k: torch.from_numpy(v) for k, v in _draw(rng, {"a": (8, 6),
                                                         "b": (5,)}).items()}
    g = {k: torch.from_numpy(v) for k, v in _draw(rng, {"a": (8, 6),
                                                         "b": (5,)}).items()}
    state = tadam.adamw_init(p, cfg)
    new, new_state, _ = tadam.adamw_update(p, g, state, cfg)
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    stats = tadam.adamw_update_(p, g, state, cfg)
    assert float(stats["lr"]) == float(tadam.lr_schedule(cfg, 1))
    for k in p:
        assert torch.equal(p[k], new[k])
        assert torch.equal(state["mu"][k], new_state["mu"][k])


# ----------------------------------------------------------- loss, grads

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", MODELS)
def test_loss_and_grads_match_reference(ref, model, dtype):
    """``loss_fn`` and its gradients against ``jax.value_and_grad(
    loss_fn, has_aux=True)``: float32 logits, the ``labels >= 0`` mask (the
    last position is -1), ``ce + 0.01 · moe_aux``; every gradient leaf in
    its parameter's dtype."""
    cfg, params = _port_model(model, dtype)
    loss, metrics, grads = ttrain.value_and_grad(
        params, _port_batch(cfg), cfg, RunConfig())
    tag = f"{model}/{dtype}"
    tol_l = fixture.tol("loss", dtype)
    assert _rel(ref[f"{tag}/loss"], loss) <= tol_l
    assert _rel(ref[f"{tag}/ce"], metrics["ce"]) <= tol_l
    want_aux = float(ref[f"{tag}/moe_aux"])
    assert (want_aux > 0) == bool(cfg.n_experts)
    assert abs(float(metrics["moe_aux"]) - want_aux) <= tol_l * max(
        want_aux, 1e-30)
    got = fixture.flat(grads)
    prefix = f"{tag}/grads/"
    want = {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}
    assert set(got) == set(want)
    worst = {}
    for path, g in got.items():
        assert str(g.dtype).split(".")[-1] == str(
            ref[f"{tag}/dtype/{path}"]), path
        assert bool(torch.isfinite(g.float()).all()), path
        worst[path] = _rel(want[path], g)
    assert max(worst.values()) <= fixture.tol(
        "grads", dtype, model.partition("@")[0]), worst


@pytest.mark.parametrize("model", ["deepseek_7b", "granite_moe_1b_a400m",
                                   "rwkv6_7b", "zamba2_2_7b",
                                   "musicgen_medium"])
def test_remat_gradients_equal(model):
    """``remat`` (each layer under ``torch.utils.checkpoint``; a hybrid's
    groups and each Mamba2 layer in them) gives the gradients of the
    plain backward bit for bit, in bf16 and at zamba2's full smoke
    depth."""
    cfg = _cfg(smoke_config, model, "bfloat16")
    tree = fixture.model_tree(tmodel.model_specs(cfg), cfg, SEED)
    params = params_from_reference(tree, cfg, device="cpu")
    batch = _port_batch(cfg)
    outs = [ttrain.value_and_grad(params, batch, cfg, RunConfig(remat=r))
            for r in ("none", "layer")]
    assert torch.equal(outs[0][0], outs[1][0])
    g0, g1 = (fixture.flat(o[2]) for o in outs)
    for path in g0:
        assert torch.equal(g0[path], g1[path]), path


@pytest.mark.parametrize("model, dtype", MICRO)
def test_microbatched_grads_match_reference(ref, model, dtype):
    """``microbatches=2`` (gradients accumulated in float32, the mean
    taken) against the reference's ``_microbatched_grads``; the result is
    float32 whatever the parameters' dtype, as there."""
    cfg, params = _port_model(model, dtype)
    run = RunConfig(microbatches=2)
    loss, metrics, grads = ttrain._microbatched_grads(
        params, _port_batch(cfg), cfg, run)
    tag = f"{model}/{dtype}/mb2"
    assert _rel(ref[f"{tag}/loss"], loss) <= fixture.tol("loss", dtype)
    assert _rel(ref[f"{tag}/ce"], metrics["ce"]) <= fixture.tol("loss", dtype)
    for path, g in fixture.flat(grads).items():
        assert g.dtype == torch.float32
        assert str(ref[f"{tag}/dtype/{path}"]) == "float32"
        assert _rel(ref[f"{tag}/grads/{path}"], g) <= fixture.tol(
            "grads", dtype), path


def test_microbatches_split_the_batch():
    """Two microbatches of a float32 model equal the mean of the two
    halves' gradients, and come within the float32 gradient tolerance of
    the one-batch gradients (the halves hold the same number of counted
    labels, so the mean of their losses is the whole batch's)."""
    cfg, params = _port_model("deepseek_7b", "float32")
    batch = _port_batch(cfg)
    _, _, whole = ttrain._microbatched_grads(params, batch, cfg, RunConfig())
    loss2, _, two = ttrain._microbatched_grads(
        params, batch, cfg, RunConfig(microbatches=2))
    halves = [ttrain.value_and_grad(params, {k: v[i * 2:(i + 1) * 2]
                                             for k, v in batch.items()},
                                    cfg, RunConfig()) for i in range(2)]
    assert torch.equal(loss2, (halves[0][0] + halves[1][0])
                       / torch.tensor(2.0))
    for path, g in fixture.flat(two).items():
        h0, h1 = (fixture.flat(h[2])[path] for h in halves)
        assert torch.equal(g, (h0 + h1) / torch.tensor(2.0)), path
        assert _rel(fixture.flat(whole)[path].numpy(), g) <= fixture.tol(
            "grads", "float32"), path


# ----------------------------------------------------------- exchange

def _exchange_leaves():
    """Leaves that are not a multiple of 256 values, one that is, and
    one with all-zero groups (scale 1.0)."""
    rng = np.random.default_rng(11)
    zero = np.zeros((3, 300), np.float32)
    zero[1, 7] = -2.5
    return {"odd": rng.standard_normal((7, 37)).astype(np.float32),
            "whole": rng.standard_normal((4, 128)).astype(np.float32),
            "one": np.float32([3.0]),
            "zeros": zero,
            "bf16": rng.standard_normal((5, 61)).astype(np.float32)}


def test_quantize_tree_matches_reference():
    """``quantize_tree``/``dequantize_tree`` (kernels 7 and 8 at group
    256; their plain versions here) bit for bit against the reference's
    eager ``_quant_leaf``/``_dequant_leaf``."""
    import jax.numpy as jnp

    from repro.optim import grad_compress as rgc

    leaves = _exchange_leaves()
    tree = {"a": {k: torch.from_numpy(v) for k, v in leaves.items()
                  if k != "bf16"},
            "bf16": torch.from_numpy(leaves["bf16"]).bfloat16()}
    ops.reset_launches()
    qs = tgc.quantize_tree(tree)
    shapes = {"a": {k: v.shape for k, v in tree["a"].items()},
              "bf16": tree["bf16"].shape}
    back = tgc.dequantize_tree(qs, shapes)
    for path, leaf in fixture.flat(tree).items():
        rq, rs = rgc._quant_leaf(jnp.asarray(_np(leaf)).astype(
            "bfloat16" if path == "bf16" else "float32"))
        q, s = fixture.flat(qs)[path]
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        assert q.shape == (-(-leaf.numel() // 256), 256)
        want = np.asarray(rgc._dequant_leaf(rq, rs, tuple(leaf.shape)))
        np.testing.assert_array_equal(fixture.flat(back)[path].numpy(), want)
    zq, zs = fixture.flat(qs)["a/zeros"]
    assert zs.numpy().tolist() == [
        1.0, float(np.float32(2.5) / np.float32(127)), 1.0, 1.0]
    assert sum(ops.launches.values()) == 0      # CPU: plain versions


def test_compress_pod_reduce_single_pod_is_identity():
    from repro.optim import grad_compress as rgc

    g = {"w": torch.randn(3, 4), "b": {"x": torch.randn(5)}}
    ef = tgc.init_error_feedback(g)
    for kw in ({"n_pods": 1}, {"n_pods": 4, "pod_axis": None}):
        out, new_ef = tgc.compress_pod_reduce(g, ef, **kw)
        assert out is g and new_ef is ef
    assert rgc.compress_pod_reduce(g, ef, pod_axis=None, n_pods=1) == (g, ef)
    assert all(float(v.abs().max()) == 0 for v in fixture.flat(ef).values())


@pytest.mark.parametrize("dtype", DTYPES)
def test_two_pod_exchange_matches_reference(dtype):
    """The two-replica exchange (``compress_pod_reduce(n_pods=2)``, one
    kernel-7 and one kernel-8 call a leaf) against the reference's
    ``_quant_leaf``/``_dequant_leaf`` composed as ``exchange.one`` composes
    them, run eagerly: the mean and each replica's new residual bit for
    bit; every residual within half a quantization step of its group."""
    import jax.numpy as jnp

    leaves = _exchange_leaves()
    rng = np.random.default_rng(12)
    g2 = {k: np.stack([v, rng.standard_normal(v.shape).astype(np.float32)])
          for k, v in leaves.items()}
    e2 = {k: (1e-2 * rng.standard_normal(v.shape)).astype(np.float32)
          for k, v in g2.items()}
    grads = {k: torch.from_numpy(v.copy()).to(getattr(torch, dtype))
             for k, v in g2.items()}
    ef = {k: torch.from_numpy(v.copy()) for k, v in e2.items()}
    calls = {"q": 0, "d": 0}
    real_q, real_d = tgc.ops.group_quant, tgc.ops.group_dequant

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    tgc.ops.group_quant = count("q", real_q)
    tgc.ops.group_dequant = count("d", real_d)
    gc = {k: grads[k].float() + ef[k] for k in g2}
    try:
        mean, new_ef = tgc.compress_pod_reduce(grads, ef, n_pods=2)
    finally:
        tgc.ops.group_quant, tgc.ops.group_dequant = real_q, real_d
    assert calls == {"q": len(g2), "d": len(g2)}
    # written in place, as the step needs for memory
    assert mean is grads and new_ef is ef
    r_grads = [{k: jnp.asarray(v[r]).astype(dtype) for k, v in g2.items()}
               for r in range(2)]
    r_efs = [{k: jnp.asarray(v[r]) for k, v in e2.items()} for r in range(2)]
    want_mean, want_e = fixture.reference_exchange(r_grads, r_efs)
    for k in g2:
        assert mean[k].dtype == getattr(torch, dtype)
        assert mean[k].shape == grads[k].shape
        for r in range(2):
            np.testing.assert_array_equal(_np(mean[k][r]),
                                          _np(want_mean[k]))
            np.testing.assert_array_equal(new_ef[k][r].numpy(),
                                          np.asarray(want_e[r][k]))
        for r in range(2):
            _, s = tgc.quant_leaf(gc[k][r])
            flat = new_ef[k][r].reshape(-1)
            pad = (-flat.numel()) % 256
            per_group = torch.nn.functional.pad(flat, (0, pad)).reshape(
                -1, 256).abs().amax(-1)
            assert bool((per_group <= s * (0.5 + 2 ** -15)).all()), k


# ----------------------------------------------------------- train steps

def _state_copy(tree):
    return {k: _state_copy(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def test_train_step_matches_reference_composition():
    """``make_train_step`` (AdamW, remat, float32 musicgen smoke): its loss
    is the reference's, and its new parameters are the reference's
    ``adamw_update`` of the step's own gradients; the step writes the new
    values into the trees it is given."""
    import jax.numpy as jnp

    from repro.optim import adamw as radam

    cfg, params = _port_model("musicgen_medium", "float32")
    params = _state_copy(params)
    opt = tadam.AdamWConfig(lr=1e-2, warmup_steps=1)
    run = RunConfig(remat="layer")
    step, opt_cfg = ttrain.make_train_step(cfg, run, opt)
    assert opt_cfg is opt
    state = tadam.adamw_init(params, opt)
    old = _state_copy(params)
    batch = _port_batch(cfg)
    loss, _, grads = ttrain.value_and_grad(old, batch, cfg, run)
    out_p, out_s, metrics = step(params, state, batch)
    assert out_p is params and out_s is state and int(state["step"]) == 1
    assert torch.equal(metrics["loss"], loss)
    as_r = lambda t: {k: as_r(v) if isinstance(v, dict)
                      else jnp.asarray(v.numpy()) for k, v in t.items()}
    ropt = radam.AdamWConfig(lr=1e-2, warmup_steps=1)
    rp = as_r(old)
    rnew, _, rstats = radam.adamw_update(rp, as_r(grads),
                                         radam.adamw_init(rp, ropt), ropt)
    assert _ulps(metrics["lr"].numpy(), np.asarray(rstats["lr"])) <= 1
    _check_update(rnew, params, old, "float32",
                  fixture.TOL["update"]["float32"])


def test_train_steps_lower_the_loss():
    """Five AdamW steps on one fixed batch lower the loss (the reference's
    ``test_loss_decreases``, which is red there: it needs a mesh);
    Adafactor with two microbatches too."""
    for opt_name, run, opt in (
            ("adamw", RunConfig(), tadam.AdamWConfig(lr=1e-2,
                                                     warmup_steps=1)),
            ("adafactor", RunConfig(optimizer="adafactor", microbatches=2),
             tada.AdafactorConfig(lr=1e-2, warmup_steps=1))):
        cfg = smoke_config("deepseek_7b")
        params, state = ttrain.init_train_state(
            cfg, run, torch.Generator().manual_seed(0), opt, device="cpu")
        assert ("mu" in state) == (opt_name == "adamw")
        step, _ = ttrain.make_train_step(cfg, run, opt)
        batch = _port_batch(cfg)
        losses = []
        for _ in range(5):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            assert np.isfinite(float(m["grad_norm"]))
        assert losses[-1] < losses[0], (opt_name, losses)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_compressed_step_matches_reference_composition(ref, optimizer):
    """``make_train_step_compressed`` with two replicas (float32 musicgen
    smoke) against the reference's functions composed as its compressed
    step composes them: each replica's loss and gradients on its own half
    of the batch are the reference's ``jax.value_and_grad(loss_fn)`` of
    that half (at the loss and gradient tolerances); the step's error
    feedback is, bit for bit, the reference's eager exchange of those
    gradients, and the step's mean loss the mean of the halves'; each
    replica's new parameters are the reference's update with the
    exchanged mean, at the update's tolerance.  As in
    :func:`test_train_step_matches_reference_composition`, the exchange
    and the update take the step's own gradients: a 1e-7 difference of a
    gradient can move an int8 code by one step."""
    import jax.numpy as jnp

    from repro.optim import adafactor as rada
    from repro.optim import adamw as radam

    model, dtype = PODS_MODEL
    cfg, params = _port_model(model, dtype)
    run = RunConfig(optimizer=optimizer, remat="none")
    if optimizer == "adamw":
        opt = tadam.AdamWConfig(lr=1e-2, warmup_steps=1)
        ropt = radam.AdamWConfig(lr=1e-2, warmup_steps=1)
        rinit, rupd = radam.adamw_init, radam.adamw_update
    else:
        opt = tada.AdafactorConfig(lr=1e-2, warmup_steps=1)
        ropt = rada.AdafactorConfig(lr=1e-2, warmup_steps=1)
        rinit, rupd = rada.adafactor_init, rada.adafactor_update
    _, init, _ = ttrain.make_optimizer(run, opt)
    p_r = ttrain._replicate(_state_copy(params), 2)
    o_r = ttrain._replicate(init(params, opt), 2)
    e_r = tgc.init_error_feedback(p_r)
    batch = _port_batch(cfg)
    own = [ttrain.value_and_grad(params, half, cfg, run)
           for half in _halves(batch)]
    tol_l, tol_g = fixture.tol("loss", dtype), fixture.tol("grads", dtype)
    for r, (loss, _, grads) in enumerate(own):
        tag = f"{model}/{dtype}/half{r}"
        assert _rel(ref[f"{tag}/loss"], loss) <= tol_l, r
        for path, g in fixture.flat(grads).items():
            assert _rel(ref[f"{tag}/grads/{path}"], g) <= tol_g, (r, path)
    step, _ = ttrain.make_train_step_compressed(cfg, run, 2, opt)
    _, _, _, metrics = step(p_r, o_r, e_r, batch)
    want_loss = (float(ref[f"{model}/{dtype}/half0/loss"])
                 + float(ref[f"{model}/{dtype}/half1/loss"])) / 2
    assert abs(float(metrics["loss"]) - want_loss) <= tol_l * abs(want_loss)
    as_r = lambda t: {k: as_r(v) if isinstance(v, dict)
                      else jnp.asarray(v.numpy()) for k, v in t.items()}
    zeros = as_r(tgc.init_error_feedback(params))
    want_mean, want_e = fixture.reference_exchange(
        [as_r(g) for _, _, g in own], [zeros, zeros])
    for path, e in fixture.flat(e_r).items():
        for r in range(2):
            np.testing.assert_array_equal(e[r].numpy(),
                                          np.asarray(want_e[r][path]))
    rp = as_r(params)
    rnew, _, _ = rupd(rp, fixture.nested(want_mean), rinit(rp, ropt), ropt)
    for r in range(2):
        _check_update(rnew, replica(p_r, r), params, dtype,
                      fixture.TOL["update"][dtype])


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_compressed_step(optimizer):
    """The replicated step with two replicas: kernels 7 and 8 called once
    a leaf and step (their plain versions here), the same update on both
    replicas, so they stay bit-identical, and non-zero error feedback;
    one replica is the plain step.  The step's values against the
    reference: :func:`test_compressed_step_matches_reference_composition`."""
    cfg = smoke_config("musicgen_medium")
    run = RunConfig(optimizer=optimizer, remat="none")
    opt = (tadam.AdamWConfig(lr=1e-2, warmup_steps=1) if optimizer == "adamw"
           else tada.AdafactorConfig(lr=1e-2, warmup_steps=1))
    p_r, o_r, e_r = ttrain.init_replica_state(
        cfg, run, 2, torch.Generator().manual_seed(0), opt, device="cpu")
    for tree in (p_r, o_r, e_r):
        for path, leaf in fixture.flat(tree).items():
            assert leaf.shape[0] == 2, path
    p0 = _state_copy(replica(p_r, 0))
    o0 = _state_copy(replica(o_r, 0))
    batch = _port_batch(cfg)
    step, _ = ttrain.make_train_step_compressed(cfg, run, 2, opt)
    n_leaves = len(fixture.flat(p_r))
    calls = {"q": 0, "d": 0}
    real_q, real_d = tgc.ops.group_quant, tgc.ops.group_dequant

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    tgc.ops.group_quant = count("q", real_q)
    tgc.ops.group_dequant = count("d", real_d)
    try:
        for _ in range(2):
            step(p_r, o_r, e_r, batch)
    finally:
        tgc.ops.group_quant, tgc.ops.group_dequant = real_q, real_d
    assert calls == {"q": 2 * n_leaves, "d": 2 * n_leaves}
    for path, leaf in fixture.flat(p_r).items():
        assert torch.equal(leaf[0], leaf[1]), path
    assert any(float(v.abs().max()) > 0
               for v in fixture.flat(e_r).values())
    # one replica: no exchange, the plain step on the same state
    p1, o1, e1 = ttrain.init_replica_state(
        cfg, run, 1, torch.Generator().manual_seed(0), opt, device="cpu")
    step1, _ = ttrain.make_train_step_compressed(cfg, run, 1, opt)
    step1(p1, o1, e1, batch)
    plain, _ = ttrain.make_train_step(cfg, run, opt)
    plain(p0, o0, batch)
    for path, leaf in fixture.flat(p1).items():
        assert torch.equal(leaf[0], fixture.flat(p0)[path]), path
    assert all(float(v.abs().max()) == 0 for v in fixture.flat(e1).values())


if __name__ == "__main__":
    _reference_outputs(sys.argv[1])
