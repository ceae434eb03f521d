"""Expert parallelism in the plain train step, on the CPU: gloo ranks of
``test_torch_mesh_ranks._spawn`` (spawned, a ``file://`` rendezvous, one
intra-op thread a rank; no rank imports ``jax`` or ``repro``).

``make_train_step(mesh=)`` and ``init_train_state(mesh=)`` run the MoE
family with a ``model`` axis of 2, on ``(data=1, model=2)`` (two ranks)
and ``(data=2, model=2)`` (four ranks), one spawn a mesh shape shared by
every case: the experts split over ``model``, the attention's heads as
for the dense families.  The configurations are float32 smoke models
with AdamW, fsdp on and off, each with 8 experts, top-2: granite-moe;
qwen3-moe with one kv head (its GQA at smoke width: 4 query heads a kv
head, so ``wk``/``wv`` are split inside a head and their gradients are
partial on each ``model`` rank); and a granite variant with an odd
vocabulary of 509, which the axis does not divide, so ``embed`` and
``lm_head`` stay whole on every ``model`` rank.  The four-rank spawn
also runs the odd-vocabulary case on ``(pod=1, data=2, model=2)`` with
``remat="layer"``; the two-rank spawn also runs granite-moe with 3 query
heads and one kv head, whose attention the axis splits inside a head
(ROADMAP item 2.6b-4b-3a).  The global batch of 8 × 1,024 gives each
batch rank whole token groups of 4,096.  The reference's meshed step is
red on this tree (ROADMAP.md, queue 3), so each step is held, from the
init, to the port's one-process step and to the reference's unsharded
``_microbatched_grads`` composed with its ``adamw_update``
(``test_torch_tensor_parallel.py``'s bars):

* the loss, ``ce``, ``moe_aux`` and ``grad_norm`` within 1e-6
  (relative), and the same bits on every rank;
* the step's gradients, gathered whole over every mesh axis, within 1e-5
  of each leaf's largest magnitude;
* the new parameters and moments, gathered whole, against the port's
  one-process ``adamw_update_`` of the step's own gradients within 1e-6
  of each leaf's largest update beyond one ulp, and against the
  reference's ``adamw_update`` within 1e-5;
* each leaf placed by ``param_shardings`` (moments by ``opt_shardings``),
  and a rank's local parameter bytes exactly what those placements give
  it;
* every rank's top-k expert picks (read by wrapping ``moe._route``) the
  same bits as the other ``model`` rank's of its row and as the
  one-process step's picks of the same tokens.

Beside the steps: ``moe_apply`` alone under ``model_parallel`` against
one process, on a loss that weights the load-balancing ``aux`` so that
summing its gradient over ``model`` would fail; the whole-vocabulary
lookup and cross-entropy inside a ``model`` group; the placements of
``init_train_state(mesh=)`` against the elastic restore's; and the
``ValueError`` of an expert count the axis does not divide (ROADMAP item
2.6b-4b-3b), raised before any collective.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import RunConfig, smoke_config
from repro_torch.launch import sharding as tsh
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import model_parallel
from repro_torch.optim import adamw as tadam
from repro_torch.optim.tree import leaves, local, sharded, tree_map
from test_torch_data_parallel import (_flat, _flat_np, _moments, _rel,
                                      _update_err)
from test_torch_mesh_ranks import _mesh, _spawn
from test_torch_tensor_parallel import (_as_r, _full, _local_bytes,
                                        _same_on_ranks)

MESHES = {"model2": ((1, 2), ("data", "model")),
          "data2_model2": ((2, 2), ("data", "model"))}
POD_MESH = ((1, 2, 2), ("pod", "data", "model"))
GRANITE, QWEN3 = "granite_moe_1b_a400m", "qwen3_moe_30b_a3b"
ODD = "granite_odd"
#: granite with 3 query heads and one kv head: on model=2 its wq, bq and
#: wo split inside a head, wk and wv inside the kv head
GRANITE_H3 = "granite_h3"
ODD_VOCAB = 509
NAMES = [GRANITE, QWEN3, ODD]
#: (name, fsdp) of each mesh's cases
CASES = [(a, f) for a in NAMES for f in (False, True)]
#: model2's alone
H3_CASE = (GRANITE_H3, True)
#: (name, fsdp, remat) of the (pod=1, data=2, model=2) case
POD_CASE = (ODD, True, "layer")
SEED = 53
BATCH = (8, 1024)
TOL_LOSS, TOL_GRADS, TOL_UPDATE, TOL_REF_UPDATE = 1e-6, 1e-5, 1e-6, 1e-5
#: moe_apply alone against one process (float32 sums in another order)
TOL_MOE = 1e-6
#: the load-balancing loss's weight in moe_apply's check
AUX_W = 100.0


def _cfg(name: str):
    arch = GRANITE if name in (ODD, GRANITE_H3) else name
    cfg = replace(smoke_config(arch), dtype="float32")
    if name == QWEN3:
        return replace(cfg, n_kv_heads=1)
    if name == GRANITE_H3:
        return replace(cfg, n_heads=3, n_kv_heads=1)
    return replace(cfg, vocab_size=ODD_VOCAB) if name == ODD else cfg


def _run(fsdp: bool, remat: str = "none") -> RunConfig:
    return RunConfig(fsdp=fsdp, remat=remat)


def _opt():
    return tadam.AdamWConfig(lr=1e-2, warmup_steps=1)


def _gen() -> torch.Generator:
    return torch.Generator().manual_seed(SEED)


def _batch(cfg) -> dict:
    """A seeded global batch, numpy: int32 tokens, and int32 labels of
    which row ``r`` masks a share falling from 0.8 to 0."""
    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(0, cfg.vocab_size, BATCH).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, BATCH).astype(np.int32)
    share = np.linspace(0.8, 0.0, BATCH[0])[:, None]
    labels[rng.random(BATCH) < share] = -1
    return {"tokens": tokens, "labels": labels}


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


class _Picks:
    """While active, every ``moe._route`` call's top-k expert indices, in
    call order (a layer's groups in token order, layer by layer)."""

    def __enter__(self):
        self.orig, self.seen = tmoe._route, []

        def route(probs, k):
            vals, idx = self.orig(probs, k)
            self.seen.append(idx.clone())
            return vals, idx
        tmoe._route = route
        return self

    def __exit__(self, *exc):
        tmoe._route = self.orig


# ------------------------------------------------------------ the ranks

def _ep_step(mesh, name: str, fsdp: bool, remat: str = "none") -> dict:
    """One step of ``make_train_step(mesh=)`` from ``init_train_state(
    mesh=)``: the metrics, the reduced gradients, new parameters and
    moments gathered whole, the local bits of leaves whole on every rank,
    the routing's top-k picks, the bytes, and whether every leaf has its
    rules' placements."""
    cfg, run, opt = _cfg(name), _run(fsdp, remat), _opt()
    params, state = ttrain.init_train_state(cfg, run, _gen(), opt,
                                            mesh=mesh, device="cpu")
    specs = tmodel.model_specs(cfg)
    rules = tsh.rules_for(mesh, run)
    psh = dict(leaves(tsh.param_shardings(specs, mesh, rules)))
    osh = dict(leaves(tsh.opt_shardings(opt, specs, tsh.param_shardings(
        specs, mesh, rules), mesh, rules)))
    placed = (all(p.placements == psh[path] for path, p in leaves(params))
              and all(t.placements == osh[path]
                      for path, t in leaves(_moments(state))))
    loc = sum(local(p).numel() * p.element_size() for _, p in leaves(params))
    full = sum(p.numel() * p.element_size() for _, p in leaves(params))
    want_loc = _local_bytes(params, psh, mesh)
    step, _ = ttrain.make_train_step(cfg, run, opt, mesh=mesh)
    seen, reduce = {}, ttrain._reduce_grads

    def recorded(*a, **kw):
        g = reduce(*a, **kw)
        seen["grads"] = tree_map(lambda t: _full(t, mesh), g)
        return g
    ttrain._reduce_grads = recorded
    try:
        with _Picks() as picks:
            out = step(params, state, _torch_batch(_batch(cfg)))
    finally:
        ttrain._reduce_grads = reduce
    assert out[0] is params and out[1] is state
    return {"metrics": {k: v.item() for k, v in out[2].items()},
            "grads": seen["grads"],
            "new": tree_map(lambda t: _full(t, mesh), params),
            "moments": tree_map(lambda t: _full(t, mesh), _moments(state)),
            "replicated": {path: local(t).clone() for path, t in leaves(
                {"p": params, "o": _moments(state)}) if not sharded(t)},
            "picks": picks.seen, "placed": placed,
            "bytes": (loc, want_loc, full)}


def _moe_layer(cfg) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """One MoE layer's whole parameters (a router scaled up, so that the
    routing is far from uniform and some experts drop tokens at
    capacity), an input of one 1,024-token group, and the output's
    weights of the check's loss."""
    gen = torch.Generator().manual_seed(SEED + 5)
    specs = tmoe.moe_specs(cfg)
    p = {k: torch.randn(s.shape, generator=gen) / np.sqrt(s.shape[-2])
         if len(s.shape) > 1 else 1 + 0.1 * torch.randn(s.shape,
                                                         generator=gen)
         for k, s in specs.items()}
    p["router"] = 4 * p["router"]
    x = torch.randn((2, 512, cfg.d_model), generator=gen)
    w = torch.randn((2, 512, cfg.d_model), generator=gen)
    return p, x, w


def _moe_grads(p: dict, x: torch.Tensor, w: torch.Tensor, cfg,
               aux_w: float = AUX_W):
    """``moe_apply``'s out and aux, and the gradients of ``Σ out · w +
    aux_w · aux`` in the input and every leaf."""
    xs = {k: v.clone().requires_grad_() for k, v in p.items()}
    xi = x.clone().requires_grad_()
    out, aux = tmoe.moe_apply(xs, xi, cfg)
    ((out * w).sum() + aux_w * aux).backward()
    return out.detach(), aux.detach(), {"x": xi.grad,
                                        **{k: v.grad for k, v in xs.items()}}


def _moe_check(mesh) -> dict:
    """``moe_apply`` under ``model_parallel`` on this rank's block of
    experts against the one-process layer on the whole leaves: the
    output, ``aux`` and the gradients (errors of the largest magnitude);
    whether the ``aux`` term's own router gradient is large enough that
    counting it twice would fail :data:`TOL_MOE`; the ``ValueError`` of
    the whole expert leaves on a model axis of 2."""
    cfg = _cfg(GRANITE)
    p, x, w = _moe_layer(cfg)
    out1, aux1, g1 = _moe_grads(p, x, w, cfg)
    _, _, g_aux = _moe_grads(p, x, torch.zeros_like(w), cfg)
    r, n = mesh.get_local_rank("model"), mesh.shape[-1]
    e_l = cfg.n_experts // n
    mine = {k: (v[r * e_l:(r + 1) * e_l] if k.startswith("w_") else v)
            for k, v in p.items()}
    with model_parallel(mesh.get_group("model")):
        out, aux, g = _moe_grads(mine, x, w, cfg)
        try:
            tmoe.moe_apply(p, x, cfg)
            raised = ""
        except ValueError as e:
            raised = str(e)
    want = {k: (v[r * e_l:(r + 1) * e_l] if k.startswith("w_") else v)
            for k, v in g1.items()}
    twice = g1["router"] + g_aux["router"]
    return {"out_rel": _rel(out1.numpy(), out.numpy()),
            "aux": aux, "aux_equal": torch.equal(aux, aux1),
            "grads_rel": {k: _rel(want[k].numpy(), g[k].numpy())
                          for k in want},
            "twice_rel": _rel(g1["router"].numpy(), twice.numpy()),
            "out": out, "raised": raised}


def _whole_vocab_check(mesh) -> dict:
    """Inside a ``model`` group, a vocabulary the axis does not divide:
    ``model._lookup`` of a whole table and ``train._token_ce`` of whole
    logits (negative labels indexing from the end) against the same
    functions outside the group, values and gradients bit for bit."""
    gen = torch.Generator().manual_seed(SEED + 3)
    V = ODD_VOCAB
    tokens = torch.randint(0, V, (4, 32), generator=gen)
    table = torch.randn((V, 64), generator=gen)
    wl = torch.randn((4, 32, 64), generator=gen)
    logits = 4 * torch.randn((4, 32, V), generator=gen)
    labels = torch.randint(-3, V, (4, 32), generator=gen)
    mask = (labels >= 0).float()
    got = []
    for group in (None, mesh.get_group("model")):
        t = table.clone().requires_grad_()
        lg = logits.clone().requires_grad_()
        with model_parallel(group):
            emb = tmodel._lookup(t, tokens, V)
            ce = ttrain._token_ce(lg, labels, V)
            split = (tmodel.vocab_split(V, V), tmodel.vocab_split(V // 2, V))
        ((emb * wl).sum() + (ce * mask).sum()).backward()
        got.append((emb.detach(), ce.detach(), t.grad, lg.grad, split))
    return {"equal": all(torch.equal(a, b)
                         for a, b in zip(got[0][:4], got[1][:4])),
            "split": got[1][4], "n_negative": int((labels < 0).sum())}


def _restored_placements(mesh, ckpt: str) -> bool:
    """``init_train_state(mesh=)``'s parameters are the elastic restore's
    DTensors of the same whole values: the odd-vocabulary MoE with fsdp
    (experts over ``model``, ``embed`` over ``data``, the vocabulary
    whole on ``model``)."""
    from repro_torch.checkpoint import CheckpointManager

    cfg, run = _cfg(ODD), _run(True)
    params, _ = ttrain.init_train_state(cfg, run, _gen(), _opt(), mesh=mesh,
                                        device="cpu")
    psh = tsh.param_shardings(tmodel.model_specs(cfg), mesh,
                              tsh.rules_for(mesh, run))
    got, _, _ = CheckpointManager(ckpt, device="cpu").restore(
        0, mesh=mesh, shardings=psh)
    g_of = dict(leaves(got))
    return all(g_of[path].placements == p.placements
               and torch.equal(g_of[path].to_local(), p.to_local())
               for path, p in leaves(params))


def _ep_rank(rank, n, device, mesh_name, ckpt):
    shape, names = MESHES[mesh_name]
    mesh = _mesh(device, shape, names)
    cases = CASES + ([H3_CASE] if mesh_name == "model2" else [])
    out = {"cases": {case: _ep_step(mesh, *case) for case in cases},
           "moe": _moe_check(mesh), "vocab": _whole_vocab_check(mesh),
           "restore": _restored_placements(mesh, ckpt),
           "coordinate": mesh.get_coordinate()}
    if mesh_name == "data2_model2":
        out["pod"] = _ep_step(_mesh(device, *POD_MESH), *POD_CASE)
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
            params, state = ttrain.init_train_state(
                _cfg(ODD), _run(True), _gen(), _opt(), device="cpu")
            ckpt = str(tmp / "ckpt")
            CheckpointManager(ckpt, device="cpu").save(0, params, state,
                                                       blocking=True)
            n = int(np.prod(MESHES[mesh_name][0]))
            results[mesh_name] = _spawn(_ep_rank, n, tmp, mesh_name, ckpt)
        return results[mesh_name]
    return get


# ------------------------------------------------------------ the oracles

_ONE: dict = {}
_REF_GRADS: dict = {}


def _one_process(name: str) -> dict:
    """The port's one-process step from the init (once a name: fsdp and
    remat do not change it): its loss, metrics and gradients, and the
    routing's picks."""
    if name not in _ONE:
        cfg, run, opt = _cfg(name), _run(False), _opt()
        params, state = ttrain.init_train_state(cfg, run, _gen(), opt,
                                                device="cpu")
        tb = _torch_batch(_batch(cfg))
        with _Picks() as picks:
            loss, metrics, g = ttrain._microbatched_grads(params, tb, cfg,
                                                          run)
        _, _, m = ttrain.make_train_step(cfg, run, opt)[0](params, state, tb)
        _ONE[name] = {"loss": loss.item(),
                      "metrics": {k: v.item() for k, v in metrics.items()},
                      "grad_norm": m["grad_norm"].item(), "lr": m["lr"].item(),
                      "grads": _flat_np(g), "picks": picks.seen}
    return _ONE[name]


def _ref_cfg(name: str):
    from repro.configs import smoke_config as r_smoke

    arch = GRANITE if name in (ODD, GRANITE_H3) else name
    cfg = replace(r_smoke(arch), dtype="float32")
    if name == QWEN3:
        return replace(cfg, n_kv_heads=1)
    if name == GRANITE_H3:
        return replace(cfg, n_heads=3, n_kv_heads=1)
    return replace(cfg, vocab_size=ODD_VOCAB) if name == ODD else cfg


def _reference(name: str, params: dict, grads: dict):
    """The reference's ``_microbatched_grads`` on the whole batch (once a
    name) and its ``adamw_update`` of the step's own ``grads`` from its
    init: ``(loss, ce, moe_aux, grads, new params, new moments)``,
    float32 numpy."""
    import jax.numpy as jnp

    from repro.configs import RunConfig as RRun
    from repro.launch.train import _microbatched_grads
    from repro.optim import adamw as radam

    rp = _as_r(params)
    if name not in _REF_GRADS:
        loss, metrics, rgrads = _microbatched_grads(
            rp, {k: jnp.asarray(v) for k, v in _batch(_cfg(name)).items()},
            _ref_cfg(name), RRun(remat="none"))
        _REF_GRADS[name] = (float(loss), float(metrics["ce"]),
                            float(metrics["moe_aux"]), {
            k: np.asarray(v, np.float32) for k, v in _flat(rgrads).items()})
    ropt = radam.AdamWConfig(lr=_opt().lr, warmup_steps=_opt().warmup_steps)
    new, new_state, _ = radam.adamw_update(rp, _as_r(grads),
                                           radam.adamw_init(rp, ropt), ropt)
    flat = lambda t: {k: np.asarray(v, np.float32)
                      for k, v in _flat(t).items()}
    return _REF_GRADS[name] + (flat(new), flat(_moments(new_state)))


def _check_step(outs: list, name: str, fsdp: bool,
                remat: str = "none") -> dict:
    """Every rank's step against the others, the port's one-process step
    and the reference's composition, from the init.  Returns the worst
    errors read."""
    cfg, run, opt = _cfg(name), _run(fsdp, remat), _opt()
    _same_on_ranks(outs)
    r0, one = outs[0], _one_process(name)
    old, state = ttrain.init_train_state(cfg, run, _gen(), opt,
                                         device="cpu")
    old_np, old_m = _flat_np(old), _flat_np(_moments(state))
    grads, new = _flat_np(r0["grads"]), _flat_np(r0["new"])
    new_m, m = _flat_np(r0["moments"]), r0["metrics"]
    rel = lambda a, b: abs(a - b) / abs(b)
    err = {"loss": rel(m["loss"], one["loss"]),
           "ce": rel(m["ce"], one["metrics"]["ce"]),
           "moe_aux": rel(m["moe_aux"], one["metrics"]["moe_aux"]),
           "grad_norm": rel(m["grad_norm"], one["grad_norm"]),
           "grads": max(_rel(g, grads[k]) for k, g in one["grads"].items())}
    assert m["lr"] == one["lr"] and m["moe_aux"] > 0

    want = tree_map(torch.clone, old)
    want_s = tree_map(torch.clone, state)
    tadam.adamw_update_(want, r0["grads"], want_s, opt)
    err["update"] = max(_update_err(_flat_np(want), new, old_np),
                        _update_err(_flat_np(_moments(want_s)), new_m, old_m))
    loss, ce, aux, rgrads, rnew, rnew_m = _reference(name, old, r0["grads"])
    err["ref_loss"] = rel(m["loss"], loss)
    err["ref_ce"] = rel(m["ce"], ce)
    err["ref_moe_aux"] = rel(m["moe_aux"], aux)
    err["ref_grads"] = max(_rel(rgrads[k], g) for k, g in grads.items())
    err["ref_update"] = max(_update_err(rnew, new, old_np),
                            _update_err(rnew_m, new_m, old_m))
    print(f"{name} fsdp={fsdp} remat={remat} on {len(outs)} ranks: "
          f"errors {err}")
    for k, v in err.items():
        tol = {"grads": TOL_GRADS, "ref_grads": TOL_GRADS,
               "update": TOL_UPDATE, "ref_update": TOL_REF_UPDATE}.get(
                   k, TOL_LOSS)
        assert v <= tol, (k, v, tol)
    return err


def _check_bytes(outs: list, name: str) -> None:
    """Each leaf placed by the rules, and a rank's local parameter bytes
    exactly what they give it; an odd vocabulary keeps ``embed`` and
    ``lm_head`` whole on ``model``."""
    for o in outs:
        loc, want, full = o["bytes"]
        assert o["placed"] and loc == want, (loc, want)
    print(f"{name}: local over full parameter bytes {loc / full:.4f}")


def _check_picks(outs: list, coords: list, name: str) -> None:
    """The ``model`` ranks of a row route every token alike, bit for bit,
    and as the one-process step routes the same tokens: a batch rank at
    ``data`` coordinate ``d`` of ``D`` holds the one-process groups
    ``[d·G/D, (d+1)·G/D)`` of each layer."""
    one = _one_process(name)["picks"]
    n_data = 1 + max(c[-2] for c in coords)
    per_layer = len(one) // _cfg(name).n_layers
    for o, c in zip(outs, coords):
        d = c[-2]
        want = [one[layer * per_layer + d * per_layer // n_data + j]
                for layer in range(_cfg(name).n_layers)
                for j in range(per_layer // n_data)]
        got = o["picks"]
        assert len(got) == len(want), (len(got), len(want))
        flips = sum(int((a != b).any(-1).sum()) for a, b in zip(got, want))
        assert flips == 0, f"{flips} tokens routed unlike one process"
    for o, c in zip(outs, coords):
        for p, q in zip(outs, coords):
            if c[-2] == q[-2]:
                assert all(torch.equal(a, b)
                           for a, b in zip(o["picks"], p["picks"]))


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("name, fsdp", CASES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_ep_step_matches_one_process_and_reference(ranks, mesh_name, name,
                                                   fsdp):
    """One AdamW step of an MoE with its experts split over a ``model``
    axis of 2, against the port's one-process step and the reference's
    composition (the module docstring's bars); the same bits on every
    rank; each leaf placed by the rules, and each rank the bytes they
    give it."""
    outs = [o["cases"][name, fsdp] for o in ranks(mesh_name)]
    _check_step(outs, name, fsdp)
    _check_bytes(outs, name)


def test_ep_step_with_query_heads_the_axis_does_not_divide(ranks):
    """granite-moe with 3 query heads and one kv head on ``(data=1,
    model=2)``: its experts split over ``model`` as before, its attention
    heads ``[0, 1)`` and ``[1, 3)`` cut from ``wq``/``bq``/``wo`` gathered
    whole, ``wk``/``wv`` gathered inside their one head; held as the
    divisible cases."""
    outs = [o["cases"][H3_CASE] for o in ranks("model2")]
    _check_step(outs, *H3_CASE)
    _check_bytes(outs, H3_CASE[0])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_model_ranks_route_alike(ranks, mesh_name, name):
    """The two ``model`` ranks of a row pick the same top-k experts for
    every token, bit for bit, and the same as the one-process step picks
    for those tokens (fsdp on: its gathered leaves are the init's)."""
    rs = ranks(mesh_name)
    _check_picks([o["cases"][name, True] for o in rs],
                 [o["coordinate"] for o in rs], name)


def test_ep_step_on_pod_data_model_mesh(ranks):
    """The four ranks as ``(pod=1, data=2, model=2)`` with remat a layer
    (the recomputation re-enters the ``model`` group): the odd
    vocabulary's step is held as on ``(data=2, model=2)``."""
    outs = [o["pod"] for o in ranks("data2_model2")]
    _check_step(outs, *POD_CASE)
    _check_bytes(outs, POD_CASE[0])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_moe_apply_expert_parallel_matches_one_process(ranks, mesh_name):
    """``moe_apply`` on a rank's block of experts under ``model_parallel``
    equals the one-process layer (``TOL_MOE``): the output, summed over
    ``model``; ``aux``, the same bits; the gradients of the input, the
    norm gain, the router and the rank's expert leaves.  The loss weights
    ``aux`` so that its router gradient summed over the two ranks would
    miss the bar many times over; the whole expert leaves on a model axis
    of 2 raise naming 2.6b-4b-3."""
    outs = [o["moe"] for o in ranks(mesh_name)]
    for o in outs:
        print(f"moe_apply on {mesh_name}: out {o['out_rel']:.3g}, grads "
              f"{o['grads_rel']}, aux counted twice {o['twice_rel']:.3g}")
        assert o["out_rel"] <= TOL_MOE and o["aux_equal"], o["out_rel"]
        assert max(o["grads_rel"].values()) <= TOL_MOE, o["grads_rel"]
        assert o["twice_rel"] > 100 * TOL_MOE, o["twice_rel"]
        assert "2.6b-4b-3" in o["raised"], o["raised"]
        assert torch.equal(o["aux"], outs[0]["aux"])
        assert torch.equal(o["out"], outs[0]["out"])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_whole_vocabulary_inside_a_model_group(ranks, mesh_name):
    """A vocabulary the ``model`` axis does not divide is whole: inside
    the group the lookup and the cross-entropy (negative labels indexing
    from the end) are the one-process functions, values and gradients bit
    for bit, and ``vocab_split`` tells a whole leaf from a slice."""
    for o in ranks(mesh_name):
        v = o["vocab"]
        assert v["equal"] and v["n_negative"] > 0, v
        assert v["split"] == (False, True), v["split"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_init_train_state_places_as_the_restore(ranks, mesh_name):
    """``init_train_state(mesh=)``'s parameters of the odd-vocabulary MoE
    with fsdp are the elastic restore's DTensors of the same whole
    values."""
    assert all(o["restore"] for o in ranks(mesh_name))


@pytest.mark.parametrize("shape, names", [MESHES["model2"],
                                          MESHES["data2_model2"], POD_MESH])
def test_undivided_experts_raise_before_any_collective(shape, names):
    """On a ``model`` axis of 2 (an ``AbstractMesh``: no process group, so
    any collective would fail otherwise) an expert count the axis does not
    divide, or fewer query heads than the axis (a rank would hold none),
    raise naming 2.6b-4b-3b; the MoE configurations it runs pass the
    check, 3 query heads included."""
    from repro_torch.launch.mesh import AbstractMesh

    mesh = AbstractMesh(shape, names)
    run = _run(True)
    for cfg in (replace(_cfg(GRANITE), n_experts=3),
                replace(_cfg(QWEN3), n_experts=5),
                replace(_cfg(ODD), n_heads=1, n_kv_heads=1)):
        with pytest.raises(ValueError, match="2.6b-4b-3b"):
            ttrain.make_train_step(cfg, run, _opt(), mesh=mesh)
    for name in NAMES + [GRANITE_H3]:
        ttrain._check_model_axis(_cfg(name), run, _opt(), mesh)
