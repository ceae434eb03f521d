"""The data-parallel train step on a mesh, on the CPU: gloo ranks of
``test_torch_mesh_ranks._spawn`` (spawned, a ``file://`` rendezvous,
one intra-op thread a rank; no rank imports ``jax`` or ``repro``) and,
marked ``cuda``, two ranks on one card.

``make_train_step(mesh=)`` and ``init_train_state(mesh=)`` on the
``(data=2)`` and ``(pod=2, data=2)`` meshes, with ``fsdp`` on and off,
AdamW, and Adafactor without ``fsdp``, at one and two microbatches, on
a float32 smoke model and a global batch whose rows hold unequal shares
of masked (``-1``) labels, so that the loss's global denominator
matters.  The reference's meshed step is red on this tree (ROADMAP.md,
queue 3), so each case is held to the reference's unsharded functions
composed (``_microbatched_grads`` on the whole batch, then its update)
and to the port's one-process step:

* the loss within 1e-6 (relative), ``ce``, ``moe_aux``, ``grad_norm`` at
  the same tolerance, and the same bits on every rank;
* the step's gradients, gathered whole, within 1e-5 of each leaf's
  largest magnitude;
* the new parameters, gathered whole, against the update of the step's
  own gathered gradients on the step-0 parameters: the port's
  one-process ``adamw_update_`` / ``adafactor_update_`` within 1e-6 of
  each leaf's largest update plus one ulp of the value, the reference's
  update at ``test_torch_train.py``'s update tolerance (1e-5, plus one
  ulp): Adam's first step divides each gradient by its own magnitude, so
  the step is held to its own gradients, as ``test_torch_train.py``
  holds the one-process step;
* every replicated leaf of the parameters and the optimizer state the
  same bits on every rank; with ``fsdp`` each rank holds DTensor shards
  with ``param_shardings``' placements, about ``1/n`` of the bytes.

One case is an MoE smoke model whose token groups fall whole within a
rank's rows; a group that would span ranks raises.  The counterparts of
the reference's red ``test_framework.py::test_loss_decreases`` and
``test_microbatch_equivalence`` run on the one-rank ``(1, 1)`` smoke mesh
in the test process and on ``(data=2)``.  The 16 ``shard`` call sites
record the reference's (axes, shape) pairs on one forward a family.
"""
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import RunConfig, smoke_config
from repro_torch.launch import sharding as tsh
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.optim import adafactor as tada
from repro_torch.optim import adamw as tadam
from repro_torch.optim.tree import leaves, local, sharded, tree_map
from test_torch_mesh_ranks import _mesh, _spawn

MESHES = {"data2": ((2, 1), ("data", "model")),
          "pod2_data2": ((2, 2, 1), ("pod", "data", "model"))}
#: (optimizer, fsdp, microbatches) of each mesh's cases
CASES = [(o, f, mb) for o, f in (("adamw", False), ("adamw", True),
                                 ("adafactor", False)) for mb in (1, 2)]
ARCH = "deepseek_7b"
SEED = 43
BATCH = (8, 16)
#: the MoE case: 8 × 1,024 tokens make two groups of 4,096, one a rank
MOE_ARCH, MOE_BATCH = "granite_moe_1b_a400m", (8, 1024)
TOL_LOSS, TOL_GRADS, TOL_UPDATE = 1e-6, 1e-5, 1e-6
#: the port's AdamW and Adafactor against the reference's on the same
#: gradients (``make_card_reference.TOL["update"]``: summation order, and
#: XLA's cos/pow/rsqrt one ulp from libm's)
TOL_REF_UPDATE = 1e-5
#: the reference's test_framework.py settings
LOOP_SHAPE = SimpleNamespace(global_batch=4, seq_len=32)


def _opt(optimizer: str):
    if optimizer == "adamw":
        return tadam.AdamWConfig(lr=1e-2, warmup_steps=1)
    return tada.AdafactorConfig(lr=1e-2, warmup_steps=1)


def _cfg(arch: str = ARCH):
    return replace(smoke_config(arch), dtype="float32")


def _run(optimizer: str, fsdp: bool, mb: int) -> RunConfig:
    return RunConfig(optimizer=optimizer, fsdp=fsdp, microbatches=mb,
                     remat="none")


def _batch(cfg, shape: tuple, seed: int) -> dict:
    """A seeded global batch: int32 tokens, and int32 labels of which row
    ``r`` masks a share falling from 0.8 to 0 (so each rank's rows hold a
    different count of labels)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    share = np.linspace(0.8, 0.0, shape[0])[:, None]
    labels[rng.random(shape) < share] = -1
    return {"tokens": tokens, "labels": labels}


def _torch_batch(b: dict, device: str = "cpu") -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _gen(device: str = "cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(SEED)


def _nbytes(tree) -> tuple[int, int]:
    """(local, whole) bytes of a tree's tensors."""
    loc = sum(local(t).numel() * t.element_size() for _, t in leaves(tree))
    return loc, sum(t.numel() * t.element_size() for _, t in leaves(tree))


# ------------------------------------------------------------ the ranks

def _mesh_step(mesh, device, cfg, run, opt, batch) -> dict:
    """One step of ``make_train_step(mesh=)`` from ``init_train_state(
    mesh=)``: the metrics, the step's reduced gradients and new parameters
    gathered whole, the replicated leaves' local bits, the bytes."""
    group = dist.group.WORLD
    params, state = ttrain.init_train_state(cfg, run, _gen(device), opt,
                                            mesh=mesh, device=device)
    specs = tmodel.model_specs(cfg)
    rules = tsh.rules_for(mesh, run)
    psh = tsh.param_shardings(specs, mesh, rules)
    osh = dict(leaves(tsh.opt_shardings(opt, specs, psh, mesh, rules)))
    for path, p in leaves(params):
        assert p.placements == dict(leaves(psh))[path], path
    for path, t in leaves(state):
        if path != ("step",):
            assert t.placements == osh[path], path
    assert state["step"].device.type == "cpu"
    moments = {k: v for k, v in state.items() if k != "step"}
    nbytes = {"params": _nbytes(params), "moments": _nbytes(moments)}
    n_sharded = sum(sharded(p) for _, p in leaves(params))
    step, _ = ttrain.make_train_step(cfg, run, opt, mesh=mesh)
    seen = {}
    reduce = ttrain._reduce_grads

    def recorded(*a, **kw):
        g = reduce(*a, **kw)
        seen["grads"] = ttrain._gather_params(g, group)
        return g
    ttrain._reduce_grads = recorded
    try:
        out = step(params, state, batch)
    finally:
        ttrain._reduce_grads = reduce
    assert out[0] is params and out[1] is state and int(state["step"]) == 1
    replicated = {("params",) + path: local(t).clone()
                  for path, t in leaves(params) if not sharded(t)}
    replicated.update({("opt",) + path: local(t).clone()
                       for path, t in leaves(moments) if not sharded(t)})
    return {"metrics": {k: v.item() for k, v in out[2].items()},
            "grads": seen["grads"],
            "new": ttrain._gather_params(params, group),
            "replicated": replicated, "bytes": nbytes,
            "sharded_leaves": n_sharded}


def _restored_placements(mesh, device, ckpt: str) -> bool:
    """``init_train_state(mesh=)``'s parameters have the placements and
    local values of the elastic restore of the same whole values."""
    from repro_torch.checkpoint import CheckpointManager

    cfg, run = _cfg(), _run("adamw", True, 1)
    params, _ = ttrain.init_train_state(cfg, run, _gen(device),
                                        _opt("adamw"), mesh=mesh,
                                        device=device)
    psh = tsh.param_shardings(tmodel.model_specs(cfg), mesh,
                              tsh.rules_for(mesh, run))
    got, _, _ = CheckpointManager(ckpt, device=device).restore(
        0, mesh=mesh, shardings=psh)
    g_of = dict(leaves(got))
    return all(g_of[path].placements == p.placements
               and torch.equal(g_of[path].to_local(), p.to_local())
               for path, p in leaves(params))


def _loop_losses(mesh, device, steps: int, mb: int = 1) -> tuple:
    """The reference's ``test_framework.py`` loop on ``mesh``: its smoke
    model (bf16), ``lm_batches`` seed 0, AdamW(lr=1e-3), ``mb``
    microbatches; ``(the losses of steps steps, the first parameter leaf
    after them, whole, in float32)``."""
    from repro_torch.data import lm_batches

    cfg = smoke_config(ARCH)
    run = RunConfig(microbatches=mb)
    opt = tadam.AdamWConfig(lr=1e-3)
    params, state = ttrain.init_train_state(
        cfg, run, _gen(device), opt, mesh=mesh, device=device)
    step, _ = ttrain.make_train_step(cfg, run, opt, mesh=mesh)
    data = lm_batches(cfg, LOOP_SHAPE, seed=0, device=device)
    losses = []
    for _ in range(steps):
        params, state, m = step(params, state, next(data))
        losses.append(m["loss"].item())
    first = next(iter(leaves(params)))[1]
    return losses, ttrain._gather_params({"a": first}, dist.group.WORLD)[
        "a"].float()


def _dp_rank(rank, n, device, mesh_name, ckpt):
    shape, names = MESHES[mesh_name]
    mesh = _mesh(device, shape, names)
    out = {"cases": {}}
    for optimizer, fsdp, mb in CASES:
        cfg = _cfg()
        out["cases"][optimizer, fsdp, mb] = _mesh_step(
            mesh, device, cfg, _run(optimizer, fsdp, mb), _opt(optimizer),
            _torch_batch(_batch(cfg, BATCH, SEED + 1), device))
    if mesh_name != "data2":
        return out
    cfg = _cfg(MOE_ARCH)
    out["moe"] = _mesh_step(mesh, device, cfg, _run("adamw", True, 1),
                            _opt("adamw"), _torch_batch(
                                _batch(cfg, MOE_BATCH, SEED + 2), device))
    step, _ = ttrain.make_train_step(cfg, _run("adamw", False, 1),
                                     _opt("adamw"), mesh=mesh)
    params, state = ttrain.init_train_state(
        cfg, _run("adamw", False, 1), _gen(device), _opt("adamw"),
        mesh=mesh, device=device)
    try:
        step(params, state, _torch_batch(_batch(cfg, BATCH, SEED), device))
        out["moe_spanning"] = None
    except ValueError as e:
        out["moe_spanning"] = str(e)
    out["restore"] = _restored_placements(mesh, device, ckpt)
    out["loss_decreases"] = _loop_losses(mesh, device, 20)[0]
    out["microbatches"] = [_loop_losses(mesh, device, 1, mb)
                           for mb in (1, 2)]
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(mesh_name)``: every rank's results on that mesh, from one
    spawn a mesh."""
    results = {}

    def get(mesh_name: str) -> list:
        if mesh_name not in results:
            from repro_torch.checkpoint import CheckpointManager

            tmp = tmp_path_factory.mktemp(mesh_name)
            cfg, run = _cfg(), _run("adamw", True, 1)
            opt = _opt("adamw")
            params, state = ttrain.init_train_state(cfg, run, _gen(), opt,
                                                    device="cpu")
            ckpt = str(tmp / "ckpt")
            CheckpointManager(ckpt, device="cpu").save(0, params, state,
                                                       blocking=True)
            n = int(np.prod(MESHES[mesh_name][0]))
            results[mesh_name] = _spawn(_dp_rank, n, tmp, mesh_name, ckpt)
        return results[mesh_name]
    return get


# ------------------------------------------------------------ the oracles

def _np(t) -> np.ndarray:
    return np.asarray(local(t).detach().float().cpu().numpy(), np.float32)


def _flat_np(tree) -> dict:
    return {"/".join(path): _np(t) for path, t in leaves(tree)}


def _rel(want, got) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-30))


def _update_err(want: dict, got: dict, old: dict) -> float:
    """The worst leaf's largest difference beyond one ulp of the value,
    over the leaf's largest update (``test_torch_train.py``'s rule)."""
    def one(k):
        w, g, o = (np.asarray(t[k], np.float32) for t in (want, got, old))
        beyond = np.abs(np.float64(g) - w) - np.spacing(np.abs(w))
        return float(max(beyond.max(), 0) / max(np.abs(np.float64(w) - o)
                                                .max(), 1e-30))
    return max(one(k) for k in want)


def _reference(arch: str, run: RunConfig, opt, params: dict, batch: dict,
               grads: dict):
    """The reference's ``_microbatched_grads`` on the whole batch, and its
    update of the step's own ``grads`` on ``params``: ``(loss, metrics,
    grads, new params)``, float32 numpy."""
    import jax.numpy as jnp

    from repro.configs import RunConfig as RRun
    from repro.configs import smoke_config as r_smoke
    from repro.launch.train import _microbatched_grads
    from repro.optim import adafactor as rada
    from repro.optim import adamw as radam

    def as_r(tree):
        return {k: as_r(v) if isinstance(v, dict) else jnp.asarray(_np(v))
                for k, v in tree.items()}
    rp = as_r(params)
    loss, metrics, rgrads = _microbatched_grads(
        rp, {k: jnp.asarray(v) for k, v in batch.items()},
        replace(r_smoke(arch), dtype="float32"),
        RRun(optimizer=run.optimizer, microbatches=run.microbatches,
             remat="none"))
    mod = radam if run.optimizer == "adamw" else rada
    ropt = (radam.AdamWConfig if run.optimizer == "adamw"
            else rada.AdafactorConfig)(lr=opt.lr,
                                       warmup_steps=opt.warmup_steps)
    init, update = ((mod.adamw_init, mod.adamw_update) if mod is radam
                    else (mod.adafactor_init, mod.adafactor_update))
    new, _, _ = update(rp, as_r(grads), init(rp, ropt), ropt)
    flat = lambda t: {k: np.asarray(v, np.float32)
                      for k, v in _flat(t).items()}
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            flat(rgrads), flat(new))


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _check_step(outs: list, arch: str, run: RunConfig, opt, batch: dict,
                device: str = "cpu", reference: bool = True) -> dict:
    """Every rank's step (``_mesh_step``) against the others, against the
    port's one-process step and, with ``reference``, the reference's
    composition; returns the worst errors read."""
    cfg = _cfg(arch)
    r0 = outs[0]
    for o in outs[1:]:
        assert o["metrics"] == r0["metrics"]
        assert o["replicated"].keys() == r0["replicated"].keys()
        for path, t in r0["replicated"].items():
            assert torch.equal(o["replicated"][path], t), path
        for key in ("grads", "new"):
            for path, t in leaves(r0[key]):
                assert torch.equal(dict(leaves(o[key]))[path], t), path
    old, state = ttrain.init_train_state(cfg, run, _gen(device), opt,
                                         device=device)
    old_np = _flat_np(old)
    grads, new = _flat_np(r0["grads"]), _flat_np(r0["new"])
    m = r0["metrics"]
    tb = _torch_batch(batch, device)

    # the port's one-process step on the same state and batch
    p1 = tree_map(torch.clone, old)
    loss1, metrics1, g1 = ttrain._microbatched_grads(p1, tb, cfg, run)
    _, _, m1 = ttrain.make_train_step(cfg, run, opt)[0](p1, state, tb)
    err = {"loss": abs(m["loss"] - loss1.item()) / abs(loss1.item()),
           "grad_norm": abs(m["grad_norm"] - m1["grad_norm"].item())
           / m1["grad_norm"].item(),
           "grads": max(_rel(g, grads[k]) for k, g in _flat_np(g1).items())}
    for k in ("ce", "moe_aux"):
        err[k] = abs(m[k] - metrics1[k].item()) / max(
            abs(metrics1[k].item()), 1e-30)
    assert m["lr"] == m1["lr"].item()

    # the update of the step's own gathered gradients
    want = tree_map(torch.clone, old)
    _, init, _ = ttrain.make_optimizer(run, opt)
    ttrain._UPDATE_[type(opt)](want, r0["grads"], init(want, opt), opt)
    err["update"] = _update_err(_flat_np(want), new, old_np)
    if reference:
        loss, metrics, rgrads, rnew = _reference(arch, run, opt, old, batch,
                                                 r0["grads"])
        err["ref_loss"] = abs(m["loss"] - loss) / abs(loss)
        err["ref_ce"] = abs(m["ce"] - metrics["ce"]) / abs(metrics["ce"])
        err["ref_grads"] = max(_rel(rgrads[k], g) for k, g in grads.items())
        err["ref_update"] = _update_err(rnew, new, old_np)
    print(f"{arch} {run}: errors {err}")
    for k, v in err.items():
        tol = {"grads": TOL_GRADS, "ref_grads": TOL_GRADS,
               "update": TOL_UPDATE, "ref_update": TOL_REF_UPDATE}.get(
                   k, TOL_LOSS)
        assert v <= tol, (k, v, tol)
    return err


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("optimizer, fsdp, mb", CASES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mesh_step_matches_reference_and_one_process(ranks, mesh_name,
                                                     optimizer, fsdp, mb):
    """One step on the mesh against the reference's composition and the
    port's one-process step (the module docstring's tolerances); the
    replicated leaves the same bits on every rank; with ``fsdp`` each
    rank holds its share of the parameter and moment bytes."""
    outs = [o["cases"][optimizer, fsdp, mb] for o in ranks(mesh_name)]
    _check_step(outs, ARCH, _run(optimizer, fsdp, mb), _opt(optimizer),
                _batch(_cfg(), BATCH, SEED + 1))
    n = len(outs)
    for o in outs:
        (lp, fp), (lm, fm) = o["bytes"]["params"], o["bytes"]["moments"]
        print(f"{mesh_name} fsdp={fsdp} {optimizer}: parameters {lp} of "
              f"{fp} B, moments {lm} of {fm} B on a rank")
        if fsdp:
            assert o["sharded_leaves"] > 0
            assert fp / n <= lp < 1.05 * fp / n and lm * fp == lp * fm
        else:
            assert o["sharded_leaves"] == 0 and (lp, lm) == (fp, fm)


def test_moe_groups_within_ranks(ranks):
    """An MoE smoke model (fsdp, AdamW) whose 8,192-token batch makes two
    token groups of 4,096, one a rank: its loss, ``moe_aux`` and gradients
    are the reference's and the one-process step's; a batch whose one
    group would span the two ranks raises on both."""
    out = ranks("data2")
    err = _check_step([o["moe"] for o in out], MOE_ARCH,
                      _run("adamw", True, 1), _opt("adamw"),
                      _batch(_cfg(MOE_ARCH), MOE_BATCH, SEED + 2))
    assert out[0]["moe"]["metrics"]["moe_aux"] > 0, err
    for o in out:
        assert "spans ranks" in o["moe_spanning"], o["moe_spanning"]


def test_moe_apply_global_groups():
    """``moe_apply(global_tokens=)``: the groups of a global batch of that
    many tokens; the whole batch's own count changes nothing, two halves'
    ``aux`` add up to the whole's, and a group wider than a half raises."""
    from repro_torch.models import moe as tmoe

    cfg = _cfg(MOE_ARCH)
    lp = {k: v[0] for k, v in ttrain.init_train_state(
        cfg, RunConfig(), _gen(), device="cpu")[0]["layers"]["mlp"].items()}
    x = torch.randn((4, 32, cfg.d_model), generator=_gen())
    out, aux = tmoe.moe_apply(lp, x, cfg, group_size=32)
    same, aux_same = tmoe.moe_apply(lp, x, cfg, group_size=32,
                                    global_tokens=128)
    assert torch.equal(out, same) and torch.equal(aux, aux_same)
    halves = [tmoe.moe_apply(lp, h, cfg, group_size=32, global_tokens=128)
              for h in x.split(2)]
    assert torch.equal(torch.cat([h[0] for h in halves]), out)
    assert abs((halves[0][1] + halves[1][1]).item() - aux.item()) <= (
        TOL_LOSS * aux.item())
    with pytest.raises(ValueError, match="spans ranks"):
        tmoe.moe_apply(lp, x[:2], cfg, global_tokens=128)


def test_mesh_step_raises_where_unsupported():
    """A model axis wider than 1 (ROADMAP item 2.6b-4), Adafactor with
    fsdp (2.6b-5) and unknown axes raise before any collective."""
    from repro_torch.launch.mesh import AbstractMesh

    cfg = _cfg()
    for mesh in (AbstractMesh((2, 2), ("data", "model")),
                 AbstractMesh((1, 2, 2), ("pod", "data", "model"))):
        with pytest.raises(ValueError, match="2.6b-4"):
            ttrain.make_train_step(cfg, _run("adamw", True, 1),
                                   _opt("adamw"), mesh=mesh)
    with pytest.raises(ValueError, match="2.6b-5"):
        ttrain.make_train_step(cfg, _run("adafactor", True, 1),
                               _opt("adafactor"),
                               mesh=AbstractMesh((2, 1), ("data", "model")))
    with pytest.raises(ValueError, match="mesh"):
        ttrain.make_train_step(cfg, _run("adamw", False, 1), _opt("adamw"),
                               mesh=AbstractMesh((2,), ("data",)))


def test_init_train_state_places_as_the_restore(ranks):
    """``init_train_state(mesh=)``'s parameters are the elastic restore's
    DTensors of the same whole values: the same placements and local
    values on every rank."""
    assert all(o["restore"] for o in ranks("data2"))


@pytest.fixture
def smoke_mesh():
    """The one-rank ``(1, 1)`` smoke mesh of the test process."""
    from repro_torch.launch.mesh import make_smoke_mesh

    assert not dist.is_initialized()
    try:
        yield make_smoke_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("where", ["smoke", "data2"])
def test_loss_decreases_on_mesh(request, ranks, where):
    """The reference's ``test_loss_decreases`` on the port's mesh step:
    20 steps of its loop lower the loss."""
    losses = (_loop_losses(request.getfixturevalue("smoke_mesh"), "cpu",
                           20)[0]
              if where == "smoke" else ranks("data2")[0]["loss_decreases"])
    assert len(losses) == 20 and losses[-1] < losses[0], losses


@pytest.mark.parametrize("where", ["smoke", "data2"])
def test_microbatch_equivalence_on_mesh(request, ranks, where):
    """The reference's ``test_microbatch_equivalence`` on the port's mesh
    step: one and two microbatches give nearly the same loss and first
    leaf (its tolerances)."""
    if where == "smoke":
        mesh = request.getfixturevalue("smoke_mesh")
        outs = [_loop_losses(mesh, "cpu", 1, mb) for mb in (1, 2)]
    else:
        outs = ranks("data2")[0]["microbatches"]
    (l1, p1), (l2, p2) = outs
    np.testing.assert_allclose(l1[0], l2[0], rtol=1e-3)
    np.testing.assert_allclose(p1.numpy(), p2.numpy(), rtol=2e-2, atol=2e-4)


SHARD_ARCHS = ["deepseek_7b", "granite_moe_1b_a400m", "rwkv6_7b",
               "zamba2_2_7b", "musicgen_medium"]


class _Recorder:
    """``shard`` replaced in a package's model modules, recording each
    call's (logical axes, activation shape)."""

    def __init__(self, package: str):
        import importlib

        self.mods = [importlib.import_module(f"{package}.models.{m}")
                     for m in ("model", "attention", "moe", "rwkv", "ssm")]
        self.seen = set()

    def __enter__(self):
        self.orig = [m.shard for m in self.mods]

        def shard(x, *axes):
            self.seen.add((axes, tuple(x.shape)))
            return x
        for m in self.mods:
            m.shard = shard
        return self.seen

    def __exit__(self, *exc):
        for m, fn in zip(self.mods, self.orig):
            m.shard = fn


@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_shard_call_sites_match_reference(arch):
    """One train-mode forward a family records the same set of (logical
    axes, activation shape) pairs at the port's ``shard`` calls as at the
    reference's (a set: the reference's scan traces a layer once)."""
    import jax

    from repro.configs import smoke_config as r_smoke
    from repro.models import layers as rlayers
    from repro.models import model as rmodel

    cfg, rcfg = smoke_config(arch), r_smoke(arch)
    B, S = 2, 16
    rng = np.random.default_rng(SEED)
    if cfg.input_mode == "tokens":
        x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        kw, rkw = {"tokens": torch.from_numpy(x).long()}, {"tokens": x}
    else:
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        kw, rkw = {"embeds": torch.from_numpy(x)}, {"embeds": x}
    with _Recorder("repro") as want:
        rmodel.forward(rlayers.init_from_specs(rmodel.model_specs(rcfg),
                                               jax.random.PRNGKey(0)),
                       rcfg, mode="train", **rkw)
    with _Recorder("repro_torch") as got:
        params = ttrain.init_train_state(cfg, RunConfig(), _gen(),
                                         device="cpu")[0]
        tmodel.forward(params, cfg, mode="train", **kw)
    assert want and got == want


@pytest.mark.cuda
def test_mesh_step_on_card(tmp_path):
    """Two gloo ranks on ``cuda:0`` (``data=2``, fsdp, AdamW, two
    microbatches): the same bits on both ranks, and the one-process step
    on the card at the CPU cases' tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = _spawn(_card_rank, 2, tmp_path, device="cuda")
    _check_step(out, ARCH, _run("adamw", True, 2), _opt("adamw"),
                _batch(_cfg(), BATCH, SEED + 1), device="cuda",
                reference=False)


def _card_rank(rank, n, device):
    mesh = _mesh(device, (n, 1), ("data", "model"))
    return _mesh_step(mesh, device, _cfg(), _run("adamw", True, 2),
                      _opt("adamw"),
                      _torch_batch(_batch(_cfg(), BATCH, SEED + 1), device))
