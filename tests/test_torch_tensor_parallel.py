"""Tensor parallelism in the plain train step, on the CPU: gloo ranks of
``test_torch_mesh_ranks._spawn`` (spawned, a ``file://`` rendezvous, one
intra-op thread a rank; no rank imports ``jax`` or ``repro``).

``make_train_step(mesh=)`` and ``init_train_state(mesh=)`` with a
``model`` axis of 2, on ``(data=1, model=2)`` (two ranks) and ``(data=2,
model=2)`` (four ranks), one spawn a mesh shape shared by every case:
the dense attention and MLP families (deepseek-7b: SwiGLU, token input;
musicgen-medium: GELU, embedding input; starcoder2-3b: GQA, qkv biases)
as float32 smoke models with AdamW, fsdp on and off, one and two
microbatches, on a global batch whose rows hold unequal shares of masked
(``-1``) labels.  An MQA variant of starcoder2-3b (one kv head) has
``wk``/``wv`` split inside its one head on ``model=2``: each rank
gathers them whole for its query heads, so a missing sum of their
partial gradients, or a norm gain's gradient summed twice, shows in its
gradients.  The two-rank spawn also runs query heads that the axis does
not divide (ROADMAP item 2.6b-4b-3a): deepseek-7b and the MQA
starcoder2-3b with 3 query heads, ``wq``/``bq``/``wo`` split inside the
second head, each rank's heads (1 and 2) cut from the leaves gathered
whole.  The four-rank spawn also runs one case on ``(pod=1, data=2,
model=2)``.  A third spawn of three ranks on ``(data=1, model=3)`` runs
deepseek-7b, whose 4 query heads, ffn of 256 and vocabulary of 512 the
axis does not divide: the rules leave ``wq``–``wo`` and the MLP whole on
``model``, each rank takes its balanced range (1, 1 and 2 heads; 85, 85
and 86 ffn columns) from them, and the mesh step sums their partial
gradients over ``model``.  The reference's meshed step is red on this
tree (ROADMAP.md, queue 3), so each step is held, from the init, to the
port's one-process step and to the reference's unsharded
``_microbatched_grads`` composed with its ``adamw_update``
(``test_torch_data_parallel.py``'s bars):

* the loss, ``ce`` and ``grad_norm`` within 1e-6 (relative), and the same
  bits on every rank;
* the step's gradients, gathered whole over every mesh axis, within 1e-5
  of each leaf's largest magnitude;
* the new parameters and moments, gathered whole, against the port's
  one-process ``adamw_update_`` of the step's own gradients within 1e-6
  of each leaf's largest update beyond one ulp, and against the
  reference's ``adamw_update`` within 1e-5;
* each leaf placed by ``param_shardings`` (moments by ``opt_shardings``),
  as the elastic restore places it; a rank's local parameter bytes about
  ``1 / (model · data)`` of the whole with fsdp, ``1 / model`` without.

Beside the steps: the vocab-split embedding lookup bit for bit with one
process, forward and gradient; the vocab-parallel cross-entropy and its
gradient against ``torch.logsumexp`` with negative labels;
``global_norm(group=)`` on leaves split over each axis and both; a leaf
whole on ``model`` whose gradient is partial there, summed over ``model``
by ``_reduce_grads`` (on ``model=3`` a whole ``wq`` and ``w_up``);
``_partial_over_model`` on the smoke and production configurations;
:func:`~repro_torch.models.layers.unit_range`'s ranges; and the
``ValueError``s of what a ``model`` axis does not run yet (ROADMAP items
2.6b-4b-3b to 4b-5, 4c and 4d), raised before any collective.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import RunConfig, smoke_config
from repro_torch.launch import sharding as tsh
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.layers import ParamSpec, model_parallel
from repro_torch.optim import adamw as tadam
from repro_torch.optim.tree import leaves, local, sharded, tree_map
from test_torch_data_parallel import (_flat, _flat_np, _moments, _np, _rel,
                                      _update_err)
from test_torch_mesh_ranks import _mesh, _spawn

MESHES = {"model2": ((1, 2), ("data", "model")),
          "data2_model2": ((2, 2), ("data", "model"))}
POD_MESH = ((1, 2, 2), ("pod", "data", "model"))
#: a model axis that divides neither smoke deepseek-7b's 4 heads nor its
#: ffn of 256 nor its vocabulary of 512: all whole on model
MODEL3 = ((1, 3), ("data", "model"))
ARCHS = ["deepseek_7b", "musicgen_medium", "starcoder2_3b"]
#: starcoder2-3b with one kv head: on model=2, wk/wv split inside it
MQA = "starcoder2_3b_mqa"
#: 3 query heads on model=2: wq, bq and wo split inside the second head
H3, MQA_H3 = "deepseek_7b_h3", "starcoder2_3b_mqa_h3"
#: name: (arch, the smoke config's fields replaced)
VARIANTS = {MQA: ("starcoder2_3b", {"n_kv_heads": 1}),
            H3: ("deepseek_7b", {"n_heads": 3, "n_kv_heads": 3}),
            MQA_H3: ("starcoder2_3b", {"n_heads": 3, "n_kv_heads": 1})}
#: (arch, fsdp, microbatches) of each mesh's cases
CASES = [(a, f, mb) for a in ARCHS for f in (False, True) for mb in (1, 2)]
MQA_CASES = [(MQA, f, 2) for f in (False, True)]
#: model2's alone
UNEVEN_CASES = [(a, f, 1) for a in (H3, MQA_H3) for f in (False, True)]
#: model3's
MODEL3_CASES = [("deepseek_7b", False, 1), ("deepseek_7b", True, 2)]
POD_CASE = ("deepseek_7b", True, 2)
SEED = 47
BATCH = (8, 16)
TOL_LOSS, TOL_GRADS, TOL_UPDATE, TOL_REF_UPDATE = 1e-6, 1e-5, 1e-6, 1e-5
#: the cross-entropy and the norm on hand-built inputs (float32 sums in
#: another order)
TOL_CE, TOL_NORM = 1e-6, 1e-6


def _cfg(name: str):
    arch, fields = VARIANTS.get(name, (name, {}))
    return replace(smoke_config(arch), dtype="float32", **fields)


def _run(fsdp: bool, mb: int) -> RunConfig:
    return RunConfig(fsdp=fsdp, microbatches=mb, remat="none")


def _opt():
    return tadam.AdamWConfig(lr=1e-2, warmup_steps=1)


def _gen() -> torch.Generator:
    return torch.Generator().manual_seed(SEED)


def _batch(cfg) -> dict:
    """A seeded global batch, numpy: int32 labels of which row ``r`` masks
    a share falling from 0.8 to 0, and int32 tokens or float32 frontend
    embeddings."""
    rng = np.random.default_rng(SEED + 1)
    labels = rng.integers(0, cfg.vocab_size, BATCH).astype(np.int32)
    share = np.linspace(0.8, 0.0, BATCH[0])[:, None]
    labels[rng.random(BATCH) < share] = -1
    out = {"labels": labels}
    if cfg.input_mode == "tokens":
        out["tokens"] = rng.integers(0, cfg.vocab_size, BATCH).astype(
            np.int32)
    else:
        out["embeds"] = rng.standard_normal(
            BATCH + (cfg.d_model,)).astype(np.float32)
    return out


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ------------------------------------------------------------ the ranks

def _full(t, mesh) -> torch.Tensor:
    """A copy of leaf ``t`` whole: its local tensor all-gathered over each
    mesh axis it is split on, the minor axis first."""
    from torch.distributed.tensor import DTensor, Shard

    x = local(t).detach().clone()
    if not isinstance(t, DTensor):
        return x
    for i in reversed(range(mesh.ndim)):
        q = t.placements[i]
        if not isinstance(q, Shard) or mesh.shape[i] == 1:
            continue
        g = mesh.get_group(mesh.mesh_dim_names[i])
        y = x.movedim(q.dim, 0).contiguous()
        out = y.new_empty((mesh.shape[i] * y.shape[0],) + tuple(y.shape[1:]))
        dist.all_gather_into_tensor(out, y, group=g)
        x = out.movedim(0, q.dim).contiguous()
    return x


def _local_bytes(params, psh: dict, mesh) -> int:
    """The local parameter bytes ``psh``'s placements give a rank: each
    leaf's bytes over the sizes of the mesh dims it is split on."""
    from torch.distributed.tensor import Shard

    total = 0
    for path, p in leaves(params):
        n = p.numel() * p.element_size()
        for q, size in zip(psh[path], mesh.shape):
            if isinstance(q, Shard):
                n //= size
        total += n
    return total


def _tp_step(mesh, name: str, fsdp: bool, mb: int) -> dict:
    """One step of ``make_train_step(mesh=)`` from ``init_train_state(
    mesh=)``: the metrics, the reduced gradients, new parameters and
    moments gathered whole, the local bits of leaves whole on every rank,
    the bytes, and whether every leaf has its rules' placements."""
    cfg, run, opt = _cfg(name), _run(fsdp, mb), _opt()
    params, state = ttrain.init_train_state(cfg, run, _gen(), opt,
                                            mesh=mesh, device="cpu")
    specs = tmodel.model_specs(cfg)
    psh = tsh.param_shardings(specs, mesh, tsh.rules_for(mesh, run))
    osh = dict(leaves(tsh.opt_shardings(opt, specs, psh,
                                        mesh, tsh.rules_for(mesh, run))))
    placed = (all(p.placements == dict(leaves(psh))[path]
                  for path, p in leaves(params))
              and all(t.placements == osh[path]
                      for path, t in leaves(_moments(state))))
    loc = sum(local(p).numel() * p.element_size() for _, p in leaves(params))
    full = sum(p.numel() * p.element_size() for _, p in leaves(params))
    want_loc = _local_bytes(params, dict(leaves(psh)), mesh)
    step, _ = ttrain.make_train_step(cfg, run, opt, mesh=mesh)
    seen, reduce = {}, ttrain._reduce_grads

    def recorded(*a, **kw):
        g = reduce(*a, **kw)
        seen["grads"] = tree_map(lambda t: _full(t, mesh), g)
        return g
    ttrain._reduce_grads = recorded
    try:
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
            "placed": placed, "bytes": (loc, full),
            "placed_bytes": want_loc}


def _model_slice(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's ``model`` slice of a whole tensor along ``dim``."""
    n = mesh.shape[mesh.mesh_dim_names.index("model")]
    return t.chunk(n, dim)[mesh.get_local_rank("model")]


def _lookup_check(mesh) -> dict:
    """The vocab-split lookup (``model._lookup`` under ``model_parallel``)
    against ``table[tokens]``: forward and the table slice's gradient, bit
    for bit, in float32 and bf16."""
    gen = torch.Generator().manual_seed(SEED + 2)
    tokens = torch.randint(0, 512, (4, 64), generator=gen)
    w = torch.randn((4, 64, 128), generator=gen)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        table = torch.randn((512, 128), generator=gen).to(dt)
        whole = table.clone().requires_grad_()
        want = whole[tokens]
        (want.float() * w).sum().backward()
        mine = _model_slice(table, mesh, 0).clone().requires_grad_()
        with model_parallel(mesh.get_group("model")):
            got = tmodel._lookup(mine, tokens, 512)
        (got.float() * w).sum().backward()
        out[str(dt)] = [torch.equal(got, want.detach()),
                        torch.equal(mine.grad,
                                    _model_slice(whole.grad, mesh, 0))]
    return out


def _ce_check(mesh) -> dict:
    """``train._token_ce`` on this rank's vocabulary slice of seeded
    logits, under ``model_parallel``, against the one-process
    ``logsumexp − gold``: values, and the slice's gradient of the masked
    sum, with labels that include negatives (they index from the end)."""
    gen = torch.Generator().manual_seed(SEED + 3)
    V = 512
    logits = 4 * torch.randn((4, 32, V), generator=gen)
    labels = torch.randint(-3, V, (4, 32), generator=gen)
    mask = (labels >= 0).float()
    whole = logits.clone().requires_grad_()
    idx = torch.where(labels < 0, labels + V, labels)
    want = (torch.logsumexp(whole, -1)
            - torch.gather(whole, -1, idx[..., None])[..., 0])
    (want * mask).sum().backward()
    mine = _model_slice(logits, mesh, -1).clone().requires_grad_()
    with model_parallel(mesh.get_group("model")):
        got = ttrain._token_ce(mine, labels, V)
    (got * mask).sum().backward()
    g_want = _model_slice(whole.grad, mesh, -1)
    return {"values": got.detach().clone(),
            "n_negative": int((labels < 0).sum()),
            "value_rel": _rel(want.detach().numpy(), got.detach().numpy()),
            "grad_rel": _rel(g_want.numpy(), mine.grad.numpy())}


#: hand-built leaves for the norm and the partial reduction: logical axes
#: and whole shape; ``k`` has a kv dim the model axis does not divide
HAND = {"both": (("vocab", "embed"), (8, 6)),
        "embed": (("embed", None), (6, 5)),
        "model": ((None, "mlp"), (3, 4)),
        "ln": ((None,), (6,)),
        "k": (("embed", "kv_heads"), (6, 3))}
#: model=3's: smoke deepseek-7b's query heads and ffn, and a vocabulary,
#: none of which the axis divides
HAND3 = {"wq": (("embed", "heads"), (6, 128)),
         "w_up": (("embed", "mlp"), (6, 256)),
         "ln": ((None,), (6,)),
         "vocab": (("vocab", "embed"), (512, 6))}


def _hand_specs(hand: dict) -> dict:
    return {k: ParamSpec(shape, axes, "float32")
            for k, (axes, shape) in hand.items()}


def _hand_check(mesh, hand: dict = HAND, same=("ln",)) -> dict:
    """``global_norm(group=)`` of hand-built leaves placed by fsdp's
    rules (split over the batch axes, over ``model``, over both, or
    whole), and ``_reduce_grads`` of rank-dependent gradients: ``k``'s
    (``HAND3``: ``wq``'s and ``w_up``'s) (whole on ``model``, consumed on
    its split: partial) summed over every rank; those of ``same`` (whole,
    the same on the ``model`` ranks) over the batch ranks alone."""
    specs = _hand_specs(hand)
    run = RunConfig(fsdp=True)
    rules = tsh.rules_for(mesh, run)
    psh = tsh.param_shardings(specs, mesh, rules)
    coord = mesh.get_coordinate()
    gen = torch.Generator().manual_seed(SEED + 4)
    whole = {k: torch.randn(s.shape, generator=gen) for k, s in specs.items()}
    norm = tadam.global_norm(ttrain._placed(
        {k: v.clone() for k, v in whole.items()}, psh, mesh, coord),
        group=dist.group.WORLD)
    params = ttrain._placed({k: v.clone() for k, v in whole.items()}, psh,
                            mesh, coord)
    group, model = ttrain._mesh_groups(mesh)
    axes = ttrain._batch_axes(mesh)
    # each rank's gradients, whole over the batch axes: ln's the same on
    # the model ranks of a batch coordinate
    shapes = {k: v.shape for k, v in ttrain._gather_params(
        params, group, axes).items()}
    batch_rank = mesh.get_local_rank("data")
    mine = {k: torch.randn(shapes[k], generator=torch.Generator().manual_seed(
        100 * (1 + batch_rank) + (0 if k in same else dist.get_rank())))
        for k in specs}
    partial = ttrain._partial_over_model(specs, psh, mesh)
    red = ttrain._reduce_grads({k: v.clone() for k, v in mine.items()},
                               params, group, 1, axes, model, partial)
    return {"whole": whole, "norm": norm, "partial": sorted(partial),
            "grads_in": mine, "reduced": {k: _full(v, mesh)
                                          for k, v in red.items()},
            "placements": {k: str(v) for k, v in psh.items()}}


def _restored_placements(mesh, ckpt: str) -> bool:
    """``init_train_state(mesh=)``'s parameters are the elastic restore's
    DTensors of the same whole values, fsdp on the two-axis mesh."""
    from repro_torch.checkpoint import CheckpointManager

    cfg, run = _cfg(ARCHS[0]), _run(True, 1)
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


def _remat_check(mesh) -> bool:
    """With ``remat="layer"``, a backward run outside the forward's
    ``model_parallel`` block (as autograd runs it on the card, on its own
    device thread) gives the bits of one run inside it: the layers'
    recomputation re-enters the forward's ``model`` group."""
    from repro_torch.optim.tree import unflatten

    cfg, run = _cfg(ARCHS[0]), RunConfig(remat="layer")
    params, _ = ttrain.init_train_state(cfg, run, _gen(), _opt(), mesh=mesh,
                                        device="cpu")
    group, model = ttrain._mesh_groups(mesh)
    pairs = leaves(ttrain._gather_params(params, group,
                                         ttrain._batch_axes(mesh)))
    b = ttrain._local_batch(_torch_batch(_batch(cfg)), cfg, mesh,
                            tsh.rules_for(mesh, run))
    out = []
    for inside in (True, False):
        xs = [p.detach().requires_grad_() for _, p in pairs]
        with model_parallel(model):
            loss, _ = ttrain.loss_fn(unflatten(
                (path, x) for (path, _), x in zip(pairs, xs)), b, cfg, run)
            if inside:
                out.append(torch.autograd.grad(loss, xs))
        if not inside:
            out.append(torch.autograd.grad(loss, xs))
    return all(torch.equal(a, c) for a, c in zip(*out))


def _model3_rank(device) -> dict:
    """``(data=1, model=3)``: the steps of ``MODEL3_CASES`` and the
    whole-on-``model`` reduction of ``HAND3``."""
    mesh = _mesh(device, *MODEL3)
    return {"cases": {case: _tp_step(mesh, *case) for case in MODEL3_CASES},
            "hand": _hand_check(mesh, HAND3, same=("ln", "vocab")),
            "coordinate": mesh.get_coordinate()}


def _tp_rank(rank, n, device, mesh_name, ckpt):
    if mesh_name == "model3":
        return _model3_rank(device)
    shape, names = MESHES[mesh_name]
    mesh = _mesh(device, shape, names)
    cases = CASES + MQA_CASES + (UNEVEN_CASES if mesh_name == "model2"
                                 else [])
    out = {"cases": {case: _tp_step(mesh, *case) for case in cases},
           "lookup": _lookup_check(mesh), "ce": _ce_check(mesh),
           "hand": _hand_check(mesh),
           "restore": _restored_placements(mesh, ckpt),
           "remat": _remat_check(mesh),
           "coordinate": mesh.get_coordinate()}
    if mesh_name == "data2_model2":
        pod = _mesh(device, *POD_MESH)
        out["pod"] = _tp_step(pod, *POD_CASE)
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
                _cfg(ARCHS[0]), _run(True, 1), _gen(), _opt(), device="cpu")
            ckpt = str(tmp / "ckpt")
            CheckpointManager(ckpt, device="cpu").save(0, params, state,
                                                       blocking=True)
            shape = MODEL3[0] if mesh_name == "model3" else MESHES[
                mesh_name][0]
            results[mesh_name] = _spawn(_tp_rank, int(np.prod(shape)), tmp,
                                        mesh_name, ckpt)
        return results[mesh_name]
    return get


# ------------------------------------------------------------ the oracles

_REF_GRADS: dict = {}


def _ref_cfg(name: str):
    from repro.configs import smoke_config as r_smoke

    arch, fields = VARIANTS.get(name, (name, {}))
    return replace(r_smoke(arch), dtype="float32", **fields)


def _as_r(tree):
    import jax.numpy as jnp

    return {k: _as_r(v) if isinstance(v, dict) else jnp.asarray(_np(v))
            for k, v in tree.items()}


def _reference(name: str, mb: int, params: dict, grads: dict):
    """The reference's ``_microbatched_grads`` on the whole batch (once
    an arch and microbatch count: every case starts from the same init),
    and its ``adamw_update`` of the step's own ``grads`` from its init:
    ``(loss, ce, grads, new params, new moments)``, float32 numpy."""
    import jax.numpy as jnp

    from repro.configs import RunConfig as RRun
    from repro.launch.train import _microbatched_grads
    from repro.optim import adamw as radam

    rp = _as_r(params)
    if (name, mb) not in _REF_GRADS:
        loss, metrics, rgrads = _microbatched_grads(
            rp, {k: jnp.asarray(v) for k, v in _batch(_cfg(name)).items()},
            _ref_cfg(name), RRun(microbatches=mb, remat="none"))
        _REF_GRADS[name, mb] = (float(loss), float(metrics["ce"]), {
            k: np.asarray(v, np.float32) for k, v in _flat(rgrads).items()})
    ropt = radam.AdamWConfig(lr=_opt().lr, warmup_steps=_opt().warmup_steps)
    new, new_state, _ = radam.adamw_update(rp, _as_r(grads),
                                           radam.adamw_init(rp, ropt), ropt)
    flat = lambda t: {k: np.asarray(v, np.float32)
                      for k, v in _flat(t).items()}
    return _REF_GRADS[name, mb] + (flat(new), flat(_moments(new_state)))


def _same_on_ranks(recs: list) -> None:
    r0 = recs[0]
    for o in recs[1:]:
        assert o["metrics"] == r0["metrics"]
        assert o["replicated"].keys() == r0["replicated"].keys()
        for path, t in r0["replicated"].items():
            assert torch.equal(o["replicated"][path], t), path
        for key in ("grads", "new", "moments"):
            for path, t in leaves(r0[key]):
                assert torch.equal(dict(leaves(o[key]))[path], t), path


def _check_step(outs: list, name: str, fsdp: bool, mb: int) -> dict:
    """Every rank's step against the others, the port's one-process step
    and the reference's composition, from the init; the placements and
    bytes.  Returns the worst errors read."""
    cfg, run, opt = _cfg(name), _run(fsdp, mb), _opt()
    _same_on_ranks(outs)
    r0 = outs[0]
    old, state = ttrain.init_train_state(cfg, run, _gen(), opt,
                                         device="cpu")
    old_np, old_m = _flat_np(old), _flat_np(_moments(state))
    grads, new = _flat_np(r0["grads"]), _flat_np(r0["new"])
    new_m, m = _flat_np(r0["moments"]), r0["metrics"]
    tb = _torch_batch(_batch(cfg))

    p1, s1 = tree_map(torch.clone, old), tree_map(torch.clone, state)
    loss1, metrics1, g1 = ttrain._microbatched_grads(p1, tb, cfg, run)
    _, _, m1 = ttrain.make_train_step(cfg, run, opt)[0](p1, s1, tb)
    err = {"loss": abs(m["loss"] - loss1.item()) / abs(loss1.item()),
           "ce": abs(m["ce"] - metrics1["ce"].item())
           / abs(metrics1["ce"].item()),
           "grad_norm": abs(m["grad_norm"] - m1["grad_norm"].item())
           / m1["grad_norm"].item(),
           "grads": max(_rel(g, grads[k]) for k, g in _flat_np(g1).items())}
    assert m["lr"] == m1["lr"].item() and m["moe_aux"] == 0

    want = tree_map(torch.clone, old)
    want_s = tree_map(torch.clone, state)
    tadam.adamw_update_(want, r0["grads"], want_s, opt)
    err["update"] = max(_update_err(_flat_np(want), new, old_np),
                        _update_err(_flat_np(_moments(want_s)), new_m, old_m))
    loss, ce, rgrads, rnew, rnew_m = _reference(name, mb, old, r0["grads"])
    err["ref_loss"] = abs(m["loss"] - loss) / abs(loss)
    err["ref_ce"] = abs(m["ce"] - ce) / abs(ce)
    err["ref_grads"] = max(_rel(rgrads[k], g) for k, g in grads.items())
    err["ref_update"] = max(_update_err(rnew, new, old_np),
                            _update_err(rnew_m, new_m, old_m))
    print(f"{name} fsdp={fsdp} mb={mb} on {len(outs)} ranks: errors {err}")
    for k, v in err.items():
        tol = {"grads": TOL_GRADS, "ref_grads": TOL_GRADS,
               "update": TOL_UPDATE, "ref_update": TOL_REF_UPDATE}.get(
                   k, TOL_LOSS)
        assert v <= tol, (k, v, tol)
    return err


def _check_bytes(outs: list, fsdp: bool, n_model: int, n_batch: int):
    """A rank's local parameter bytes about ``1 / (model · batch)`` of the
    whole with fsdp, ``1 / model`` without (norm gains stay whole)."""
    share = 1 / (n_model * (n_batch if fsdp else 1))
    for o in outs:
        loc, full = o["bytes"]
        assert o["placed"]
        assert share * full <= loc < 1.05 * share * full, (loc, full, share)


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("name, fsdp, mb", CASES + MQA_CASES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_tp_step_matches_one_process_and_reference(ranks, mesh_name, name,
                                                   fsdp, mb):
    """One AdamW step with a ``model`` axis of 2 against the port's
    one-process step and the reference's composition (the module
    docstring's bars); the same bits on every rank; each leaf placed by
    the rules, and each rank its share of the bytes.  The MQA cases hold
    ``wk``/``wv`` gathered inside a head and their summed gradients."""
    outs = [o["cases"][name, fsdp, mb] for o in ranks(mesh_name)]
    _check_step(outs, name, fsdp, mb)
    shape = MESHES[mesh_name][0]
    _check_bytes(outs, fsdp, shape[1], shape[0])


def test_tp_step_on_pod_data_model_mesh(ranks):
    """The four ranks as ``(pod=1, data=2, model=2)``: fsdp splits
    ``embed`` over ``pod`` × ``data``, and the step is held as on
    ``(data=2, model=2)``."""
    outs = [o["pod"] for o in ranks("data2_model2")]
    _check_step(outs, *POD_CASE)
    _check_bytes(outs, POD_CASE[1], 2, 2)


@pytest.mark.parametrize("name, fsdp, mb", UNEVEN_CASES)
def test_tp_step_splits_inside_a_query_head(ranks, name, fsdp, mb):
    """3 query heads on ``(data=1, model=2)``: the ranks take heads
    ``[0, 1)`` and ``[1, 3)``, ``wq``/``bq``/``wo`` (split inside the
    second head) gathered whole and cut, ``wk``/``wv`` gathered inside
    their heads (3, or one MQA head); held as the divisible cases."""
    outs = [o["cases"][name, fsdp, mb] for o in ranks("model2")]
    _check_step(outs, name, fsdp, mb)
    _check_bytes(outs, fsdp, 2, 1)


@pytest.mark.parametrize("name, fsdp, mb", MODEL3_CASES)
def test_tp_step_with_heads_and_ffn_whole_on_model(ranks, name, fsdp, mb):
    """``(data=1, model=3)``: deepseek-7b's 4 query heads, ffn of 256 and
    vocabulary of 512 whole on every ``model`` rank (the rules' fallback);
    each rank computes 1, 1 or 2 heads and 85, 85 or 86 ffn columns cut
    from them, and their partial gradients are summed over ``model``.
    Held as the divisible cases; each rank's local bytes are what the
    placements give it."""
    outs = [o["cases"][name, fsdp, mb] for o in ranks("model3")]
    _check_step(outs, name, fsdp, mb)
    for o in outs:
        loc, full = o["bytes"]
        assert o["placed"] and loc == o["placed_bytes"], (loc, full)
    print(f"model3: local over full parameter bytes {loc / full:.4f}")


def test_reduce_grads_sums_whole_heads_and_ffn_over_model3(ranks):
    """On ``(data=1, model=3)`` a ``wq`` and a ``w_up`` whole on ``model``
    (their widths 128 and 256) are partial there: ``_reduce_grads`` sums
    their gradients over every rank; a norm gain's and a whole
    vocabulary's, the same on the ``model`` ranks, are not summed over
    ``model``; ``global_norm`` counts each whole leaf once."""
    outs = [o["hand"] for o in ranks("model3")]
    want_norm = tadam.global_norm(outs[0]["whole"]).item()
    for o in outs:
        assert o["partial"] == [("w_up",), ("wq",)], o["partial"]
        assert abs(o["norm"].item() - want_norm) <= TOL_NORM * want_norm
    for k in HAND3:
        picked = outs if k in ("wq", "w_up") else outs[:1]
        want = sum(np.float64(o["grads_in"][k].numpy()) for o in picked)
        for o in outs:
            got = o["reduced"][k].numpy()
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), k


def _whole_paths(blocks: dict) -> set:
    return {(*pre, blk, k) for pre, blk_keys in blocks.items()
            for blk, ks in blk_keys.items() for k in ks}


_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("w_up", "w_gate", "w_down")


@pytest.mark.parametrize("arch, smoke, shape, want", [
    ("deepseek_7b", True, (1, 3),
     _whole_paths({("layers",): {"attn": _ATTN, "mlp": _MLP}})),
    ("starcoder2_3b", True, (1, 3),
     _whole_paths({("layers",): {"attn": _ATTN + ("bq", "bk", "bv"),
                                 "mlp": ("w_up", "w_down")}})),
    ("granite_moe_1b_a400m", True, (1, 3),
     _whole_paths({("layers",): {"attn": _ATTN}})),
    ("zamba2_2_7b", True, (1, 3),
     _whole_paths({(): {"shared_attn": _ATTN, "shared_mlp": _MLP}})),
    ("rwkv6_7b", True, (1, 2), set()),
    ("deepseek_7b", True, (1, 2), set()),
    ("starcoder2_3b", False, (16, 16), set()),
    ("qwen1_5_32b", False, (16, 16), set()),
    ("musicgen_medium", False, (2, 16, 16), set())])
def test_partial_over_model_marks_leaves_whole_on_model(arch, smoke, shape,
                                                        want):
    """``_partial_over_model`` marks exactly the attention's and the dense
    MLP's ``heads``/``kv_heads``/``mlp`` leaves whole on ``model``: none
    on a divisible axis or on the production meshes (where starcoder2-3b,
    qwen1.5-32b and musicgen-medium split ``wq`` inside a head), never an
    expert, RWKV6, Mamba2, vocabulary or norm leaf."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import AbstractMesh

    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    mesh = AbstractMesh(shape, names)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    specs = tmodel.model_specs(cfg)
    psh = tsh.param_shardings(specs, mesh, tsh.rules_for(mesh, RunConfig(
        fsdp=True)))
    assert set(ttrain._partial_over_model(specs, psh, mesh)) == want


def test_unit_range_tiles_units_and_keeps_even_slices(monkeypatch):
    """``unit_range`` outside a ``model`` group is ``[0, u)``; inside one
    of ``n`` ranks the ranges tile ``[0, u)`` in rank order, each of
    ``⌊u/n⌋`` or ``⌈u/n⌉`` units, and equal the even slice
    ``[r·u/n, (r+1)·u/n)`` wherever ``n`` divides ``u``."""
    assert tlayers.unit_range(24) == (0, 24)
    for n in range(2, 17):
        for u in range(n, 70):
            got = []
            for r in range(n):
                monkeypatch.setattr(tlayers, "model_rank", lambda r=r: (r, n))
                got.append(tlayers.unit_range(u))
            assert got[0][0] == 0 and got[-1][1] == u
            assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
            assert {hi - lo for lo, hi in got} <= {u // n, -(-u // n)}
            if u % n == 0:
                assert got == [(r * u // n, (r + 1) * u // n)
                               for r in range(n)]
    monkeypatch.undo()
    assert tlayers.unit_range(24) == (0, 24)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_vocab_split_lookup_is_exact(ranks, mesh_name):
    """The vocab-split embedding lookup (rows outside the rank's slice
    read as zeros, summed over ``model``) equals ``table[tokens]`` bit for
    bit, and so does each slice's gradient, in float32 and bf16."""
    for o in ranks(mesh_name):
        assert all(all(v) for v in o["lookup"].values()), o["lookup"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_vocab_parallel_cross_entropy(ranks, mesh_name):
    """The vocab-parallel cross-entropy on a rank's slice equals
    ``logsumexp − gold`` over the whole vocabulary, negative labels
    indexing from the end, and its gradient the slice of the whole
    gradient (``TOL_CE``); the values the same bits on every rank."""
    outs = [o["ce"] for o in ranks(mesh_name)]
    for o in outs:
        assert o["n_negative"] > 0
        assert o["value_rel"] <= TOL_CE and o["grad_rel"] <= TOL_CE, o
        assert torch.equal(o["values"], outs[0]["values"])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_global_norm_counts_each_piece_once(ranks, mesh_name):
    """``global_norm(group=)`` of leaves split over the batch axes, over
    ``model``, over both, or whole: the one-process norm of the whole
    leaves (``TOL_NORM``), the same bits on every rank."""
    outs = [o["hand"] for o in ranks(mesh_name)]
    want = tadam.global_norm(outs[0]["whole"]).item()
    print(f"hand-built placements: {outs[0]['placements']}")
    for o in outs:
        assert abs(o["norm"].item() - want) <= TOL_NORM * want
        assert torch.equal(o["norm"], outs[0]["norm"])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_reduce_grads_sums_partial_leaves_over_model(ranks, mesh_name):
    """A leaf whole on ``model`` and consumed on its split (a ``kv_heads``
    dim the axis does not divide) has partial gradients there:
    ``_reduce_grads`` sums them over every rank; a norm gain's gradient,
    already whole on the ``model`` ranks, is summed over the batch ranks
    alone."""
    outs = [o["hand"] for o in ranks(mesh_name)]
    coords = [o["coordinate"] for o in ranks(mesh_name)]
    for o in outs:
        assert o["partial"] == [("k",)], o["partial"]
    for k in ("k", "ln"):
        if k == "ln":
            # one rank a batch coordinate: its model ranks hold the same
            picked = {c[0]: o for c, o in zip(coords, outs)}.values()
        else:
            picked = outs
        want = sum(np.float64(o["grads_in"][k].numpy()) for o in picked)
        for o in outs:
            got = o["reduced"][k].numpy()
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), k


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_remat_recomputes_within_the_model_group(ranks, mesh_name):
    """``remat="layer"``: the gradients of a backward run outside the
    forward's ``model_parallel`` block (on the card autograd recomputes
    on its device thread) are the bits of one run inside it."""
    assert all(o["remat"] for o in ranks(mesh_name))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_init_train_state_places_as_the_restore(ranks, mesh_name):
    """``init_train_state(mesh=)``'s parameters on the two-axis mesh (fsdp:
    ``embed`` over ``data``, heads, ffn and vocabulary over ``model``) are
    the elastic restore's DTensors of the same whole values."""
    assert all(o["restore"] for o in ranks(mesh_name))


def test_unsupported_model_axis_raises_before_any_collective(tmp_path,
                                                             monkeypatch):
    """On a ``model`` axis of 2 (an ``AbstractMesh``: no process group,
    so any collective would fail otherwise) an MoE whose experts the axis
    does not divide, RWKV6 with 3 heads, the hybrid with 3 Mamba2 heads
    and an axis wider than the query heads (one head) raise naming
    2.6b-4b-3b, ``seq_shard`` 2.6b-4b-4 and Adafactor 2.6b-4b-5; the
    compressed step and its state 2.6b-4d; ``train_loop`` 2.6b-4c before
    any checkpoint is read or any state is made."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.optim.adafactor import AdafactorConfig

    for shape, names in (MESHES["model2"], MESHES["data2_model2"], POD_MESH):
        mesh = AbstractMesh(shape, names)
        dense, run = _cfg("deepseek_7b"), _run(False, 1)
        for cfg, r, opt, item in (
                (replace(_cfg("granite_moe_1b_a400m"), n_experts=3), run,
                 _opt(), "3b"),
                (replace(_cfg("rwkv6_7b"), d_model=96), run, _opt(), "3b"),
                (replace(_cfg("zamba2_2_7b"), d_model=96, ssm_head=64), run,
                 _opt(), "3b"),
                (dense, replace(run, seq_shard=True), _opt(), "4"),
                (dense, replace(run, optimizer="adafactor"),
                 AdafactorConfig(), "5"),
                (replace(dense, n_heads=1, n_kv_heads=1), run, _opt(),
                 "3b")):
            with pytest.raises(ValueError, match="2.6b-4b") as err:
                ttrain.make_train_step(cfg, r, opt, mesh=mesh)
            assert f"ROADMAP item 2.6b-4b-{item}" in str(err.value), err
        with pytest.raises(ValueError, match="2.6b-4d"):
            ttrain.make_train_step_compressed(dense, run, opt_cfg=_opt(),
                                              mesh=mesh)
        with pytest.raises(ValueError, match="2.6b-4d"):
            ttrain.init_replica_state(dense, run, None, _gen(), _opt(),
                                      mesh=mesh, device="cpu")

        def never(*a, **kw):
            raise AssertionError("read or initialized before the mesh check")
        monkeypatch.setattr(CheckpointManager, "restore_latest", never)
        monkeypatch.setattr(ttrain, "init_train_state", never)
        with pytest.raises(ValueError, match="2.6b-4c"):
            ttrain.train_loop(dense, run, iter(()), steps=1,
                              checkpoint_dir=str(tmp_path), mesh=mesh,
                              device="cpu")
        monkeypatch.undo()
