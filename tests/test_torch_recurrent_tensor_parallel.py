"""Tensor parallelism of the RWKV6 and Mamba2-hybrid families in the plain
train step, on the CPU: gloo ranks of ``test_torch_mesh_ranks._spawn``
(spawned, a ``file://`` rendezvous, one intra-op thread a rank; no rank
imports ``jax`` or ``repro``).

``make_train_step(mesh=)`` and ``init_train_state(mesh=)`` run smoke
rwkv6-7b (4 heads of 32, ffn 256) and smoke zamba2-2.7b cut to two
groups (8 Mamba2 heads of 32 a layer, two layers a group, and the shared
attention and MLP applied once a group, so that their gradients add over
the groups) in float32 with AdamW, on ``(data=1, model=2)`` (two ranks)
and ``(data=2, model=2)`` (four ranks), one spawn a mesh shape shared by
every case: fsdp off with ``remat="none"``, and fsdp on with
``remat="layer"`` (the hybrid checkpoints each group and each Mamba2
layer in it, and the recomputation runs every ``model`` collective
again).  The four-rank spawn also runs the hybrid with fsdp and remat on
``(pod=1, data=2, model=2)``; the two-rank spawn also runs the two-group
hybrid with 3 shared-attention heads (``zamba2_2_7b@2h3``), which the
axis splits inside a head (ROADMAP item 2.6b-4b-3a) while it divides the
Mamba2 widths (8 heads, ``w_in`` 552, ``conv_w`` 288).  The global batch
is 4 × 272 tokens: several 32-token RWKV chunks and two 256-token Mamba2
chunks, both padded.  The leaves that the reference initialises to zeros
or ones and the recurrences read (``mu_*``, ``w0``, ``u_bonus``,
``a_log``, ``dt_bias``, ``d_skip``, ``gn``, ``out_ln``) are redrawn from
a seed (:func:`_perturb`), alike in every rank's slices, the one-process
step and the reference: at ``mu = 0`` the token shift would not reach
step 1's gradients.

The reference's meshed step is red on this tree (ROADMAP.md, queue 3),
so each step is held, from the init, to the port's one-process step and
to the reference's unsharded ``_microbatched_grads`` composed with its
``adamw_update`` (``test_torch_expert_parallel.py``'s bars):

* the loss, ``ce`` and ``grad_norm`` within 1e-6 (relative) of the
  one-process step's, and the same bits on every rank;
* the step's gradients, gathered whole over every mesh axis, within 1e-5
  of each leaf's largest magnitude or within twice the leaf's float32
  floor, whichever is larger: the largest change that a two-ulp nudge of
  every parameter makes to the one-process step's gradient
  (:func:`_one_process`'s ``floor``).  The floor decides for Mamba2's
  ``a_log`` and ``dt_bias`` (1–5e-5 at 272 tokens; their gradients sum
  the chunked SSD's reverse cumulative sums of log-decay gradients, whose
  terms cancel to near zero) and for a few leaves whose floor is 5e-6 to
  1e-5;
* the new parameters and moments, gathered whole, against the port's
  one-process ``adamw_update_`` of the step's own gradients within 1e-6
  of each leaf's largest update beyond one ulp;
* against the reference at the depth and tolerances of
  ``test_torch_train.py`` (``make_card_reference.tol``): rwkv6-7b whole
  and zamba2-2.7b cut to one group (``zamba2_2_7b@1``, a case of its own:
  the smoke hybrid amplifies a rounding difference about twofold a
  group), the loss 1e-6, the gradients 5e-5 (rwkv6) and 1e-5, the update
  1e-5;
* each leaf placed by ``param_shardings`` (moments by ``opt_shardings``),
  and a rank's local parameter bytes exactly what those placements give
  it.

The reference's CPU backend flushes subnormal floats to zero, and
PyTorch's CPU keeps them.  The chunked WKV6 multiplies a decay as small
as ``exp(-80)`` by one as large as ``exp(80)``, so at 272 tokens the
subnormal terms move rwkv6's decay-path gradients by up to 1e-2
(ROADMAP.md, queue 3).  The cases of :data:`CASES` therefore run, in the
ranks and in the one-process step, with ``torch.set_flush_denormal(
True)`` on one intra-op thread (the setting is a thread's), the
reference's float mode; the ``(pod=1, data=2, model=2)`` case runs in
PyTorch's own mode and is held to the one-process step in that mode.

Beside the steps: :func:`~repro_torch.models.layers.split_rmsnorm` on
two ranks against ``rmsnorm`` in one process; ``rwkv6_apply`` and
``mamba2_apply`` alone under ``model_parallel`` against one process,
every leaf's gradient held (a whole leaf whose gradient were summed over
``model``, or a split one left partial, would miss the bar many times
over); ``forward``'s prefill raising inside a ``model`` group; the
placements of ``init_train_state(mesh=)`` against the elastic
restore's, ``w_in`` and ``conv_w`` included; and the ``ValueError`` of a
head count the axis does not divide (ROADMAP item 2.6b-4b-3b), raised
before any collective.
"""
import importlib.util
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import RunConfig, smoke_config
from repro_torch.launch import sharding as tsh
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import model_parallel, rmsnorm, split_rmsnorm
from repro_torch.optim import adamw as tadam
from repro_torch.optim.tree import leaves, local, sharded, tree_map
from test_torch_data_parallel import (_flat, _flat_np, _moments, _rel,
                                      _update_err)
from test_torch_mesh_ranks import _mesh, _spawn
from test_torch_tensor_parallel import (_as_r, _full, _local_bytes,
                                        _same_on_ranks)

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "make_card_reference",
    os.path.join(HERE, "card_reference", "make_card_reference.py"))
fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture)

MESHES = {"model2": ((1, 2), ("data", "model")),
          "data2_model2": ((2, 2), ("data", "model"))}
POD_MESH = ((1, 2, 2), ("pod", "data", "model"))
#: ``arch@g``: the hybrid cut to its first g groups; ``arch@ghk``: with k
#: shared-attention heads (k kv heads)
RWKV, ZAMBA, ZAMBA1 = "rwkv6_7b", "zamba2_2_7b@2", "zamba2_2_7b@1"
ZAMBA_H3 = "zamba2_2_7b@2h3"
#: (name, fsdp, remat) of each mesh's cases
CASES = [(RWKV, False, "none"), (RWKV, True, "layer"),
         (ZAMBA, False, "none"), (ZAMBA, True, "layer"),
         (ZAMBA1, False, "none")]
#: model2's alone
H3_CASE = (ZAMBA_H3, True, "layer")
#: the (pod=1, data=2, model=2) case
POD_CASE = (ZAMBA, True, "layer")
#: the names held to the reference (at test_torch_train.py's depth)
REF_NAMES = (RWKV, ZAMBA1)
SEED = 59
BATCH = (4, 272)
TOL_LOSS, TOL_GRADS, TOL_UPDATE, TOL_REF_UPDATE = 1e-6, 1e-5, 1e-6, 1e-5
#: a block's output or the split norm alone against one process (float32
#: sums in another order); a block's gradients are held at TOL_GRADS
TOL_BLOCK = 1e-6
#: the gradient bar's multiple of the one-process step's float32 floor
FLOOR_X = 2.0


def _arch(name: str) -> str:
    return name.partition("@")[0]


def _cut(cfg, name: str):
    groups, _, heads = name.partition("@")[2].partition("h")
    if groups:
        cfg = replace(cfg, n_layers=int(groups) * cfg.shared_attn_every)
    if heads:
        cfg = replace(cfg, n_heads=int(heads), n_kv_heads=int(heads))
    return cfg


def _cfg(name: str):
    return _cut(replace(smoke_config(_arch(name)), dtype="float32"), name)


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


def _redraw(name: str, shape: tuple, rng) -> np.ndarray | None:
    """A seeded value for a leaf the recurrences read that the init
    leaves at zeros or ones (``make_card_reference.recurrence_leaf``, and
    the norms over the heads, ``gn`` and ``out_ln``, at 1 + N(0, 0.2²));
    ``None`` for any other leaf."""
    if name in ("gn", "out_ln"):
        return (1 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    return fixture.recurrence_leaf(name, shape, rng)


def _perturb(params: dict, mesh=None) -> dict:
    """Redraw, in place, the layer leaves :func:`_redraw` names, from
    ``default_rng(SEED + 2)`` in sorted name order; on ``mesh`` each rank
    writes its slice of the same whole values.  Returns ``params``."""
    rng = np.random.default_rng(SEED + 2)
    layers = params["layers"]
    for name in sorted(layers):
        leaf = layers[name]
        a = _redraw(name, tuple(leaf.shape), rng)
        if a is None:
            continue
        whole = torch.from_numpy(a)
        if mesh is not None:
            whole = tsh.local_slice(whole, mesh, leaf.placements,
                                    mesh.get_coordinate())
        local(leaf).copy_(whole)
    return params


class _FloatMode:
    """While active, subnormal floats flushed to zero (``ftz``, the
    reference's CPU mode) or kept (PyTorch's), on one intra-op thread."""

    def __init__(self, ftz: bool):
        self.ftz = ftz

    def __enter__(self):
        self.threads = torch.get_num_threads()
        torch.set_num_threads(1)
        torch.set_flush_denormal(self.ftz)
        return self

    def __exit__(self, *exc):
        torch.set_flush_denormal(False)
        torch.set_num_threads(self.threads)


def _init(cfg, run, opt, mesh=None):
    params, state = ttrain.init_train_state(cfg, run, _gen(), opt, mesh=mesh,
                                            device="cpu")
    return _perturb(params, mesh), state


# ------------------------------------------------------------ the ranks

def _tp_step(mesh, name: str, fsdp: bool, remat: str) -> dict:
    """One step of ``make_train_step(mesh=)`` from ``init_train_state(
    mesh=)`` (its recurrence leaves redrawn): the metrics, the reduced
    gradients, new parameters and moments gathered whole, the local bits
    of leaves whole on every rank, the bytes, and whether every leaf has
    its rules' placements."""
    cfg, run, opt = _cfg(name), _run(fsdp, remat), _opt()
    params, state = _init(cfg, run, opt, mesh)
    specs = tmodel.model_specs(cfg)
    rules = tsh.rules_for(mesh, run)
    psh_tree = tsh.param_shardings(specs, mesh, rules)
    psh = dict(leaves(psh_tree))
    osh = dict(leaves(tsh.opt_shardings(opt, specs, psh_tree, mesh, rules)))
    placed = (all(p.placements == psh[path] for path, p in leaves(params))
              and all(t.placements == osh[path]
                      for path, t in leaves(_moments(state))))
    loc = sum(local(p).numel() * p.element_size() for _, p in leaves(params))
    full = sum(p.numel() * p.element_size() for _, p in leaves(params))
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
            "placed": placed,
            "bytes": (loc, _local_bytes(params, psh, mesh), full)}


def _rank_slice(t: torch.Tensor, axes: tuple, rank: int, n: int):
    """``t``'s slice that ``model`` rank ``rank`` of ``n`` holds: a
    contiguous ``n``-th of each dim on a ``heads`` or ``mlp`` axis."""
    for dim, ax in enumerate(axes):
        if ax in ("heads", "mlp"):
            w = t.shape[dim] // n
            t = t.narrow(dim, rank * w, w)
    return t


def _block_grads(apply, p: dict, x: torch.Tensor, w: torch.Tensor, cfg):
    """A block's output and the gradients of ``Σ out · w`` in its input
    and every leaf."""
    xs = {k: v.clone().requires_grad_() for k, v in p.items()}
    xi = x.clone().requires_grad_()
    out, _ = apply(xs, xi, cfg, mode="train")
    (out * w).sum().backward()
    return out.detach(), {"x": xi.grad, **{k: v.grad for k, v in xs.items()}}


def _block_check(mesh, name: str) -> dict:
    """``rwkv6_apply`` (``name`` RWKV) or ``mamba2_apply`` (the hybrid's)
    on this rank's slices under ``model_parallel`` against the
    one-process block on the whole leaves (seeded, the recurrence leaves
    redrawn): the output and every gradient's error of its largest
    magnitude, and each whole leaf's error were its gradient summed over
    ``model``."""
    cfg = _cfg(name)
    specs = (trwkv.rwkv6_specs(cfg) if cfg.family == "ssm"
             else tssm.mamba2_specs(cfg))
    apply = trwkv.rwkv6_apply if cfg.family == "ssm" else tssm.mamba2_apply
    rng = np.random.default_rng(SEED + 5)
    p = {}
    for k in sorted(specs):
        s = specs[k]
        a = _redraw(k, s.shape, rng)
        if a is None:
            fan_in = s.shape[0] if len(s.shape) > 1 else 1
            a = (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
            if s.init == "ones":
                a = 1 + 0.2 * a
        p[k] = torch.from_numpy(a)
    x = torch.from_numpy(rng.standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    out1, g1 = _block_grads(apply, p, x, w, cfg)
    r, n = mesh.get_local_rank("model"), mesh.shape[-1]
    mine = {k: _rank_slice(v, specs[k].axes, r, n) for k, v in p.items()}
    with model_parallel(mesh.get_group("model")):
        out, g = _block_grads(apply, mine, x, w, cfg)
    want = {k: (v if k == "x" else _rank_slice(v, specs[k].axes, r, n))
            for k, v in g1.items()}
    whole = [k for k in specs if not any(a in ("heads", "mlp")
                                         for a in specs[k].axes)]
    return {"out_rel": _rel(out1.numpy(), out.numpy()),
            "grads_rel": {k: _rel(want[k].numpy(), g[k].numpy())
                          for k in want},
            "twice_rel": {k: _rel(g1[k].numpy(), 2 * g1[k].numpy())
                          for k in whole},
            "whole": whole, "out": out}


def _norm_check(mesh) -> dict:
    """``split_rmsnorm`` on this rank's slice of a 96-wide vector (and of
    its gain) against ``rmsnorm`` in one process: the output, the input
    and gain gradients (errors of the largest magnitude); outside a
    ``model`` group it is ``rmsnorm`` bit for bit."""
    gen = torch.Generator().manual_seed(SEED + 3)
    W = 96
    x = torch.randn((3, 17, W), generator=gen)
    gamma = 1 + 0.2 * torch.randn((W,), generator=gen)
    wl = torch.randn((3, 17, W), generator=gen)
    r, n = mesh.get_local_rank("model"), mesh.shape[-1]
    cut = lambda t: t.narrow(-1, r * W // n, W // n)

    def run(fn, xs, gs, ws):
        xs, gs = xs.clone().requires_grad_(), gs.clone().requires_grad_()
        out = fn(xs, gs)
        (out * ws).sum().backward()
        return out.detach(), xs.grad, gs.grad
    one = run(lambda a, b: rmsnorm(a, b, 1e-5), x, gamma, wl)
    with model_parallel(mesh.get_group("model")):
        got = run(lambda a, b: split_rmsnorm(a, b, W, 1e-5), cut(x),
                  cut(gamma), cut(wl))
    outside = run(lambda a, b: split_rmsnorm(a, b, W, 1e-5), x, gamma, wl)
    return {"rel": [_rel(cut(a).numpy(), b.numpy())
                    for a, b in zip(one, got)],
            "outside_equal": all(torch.equal(a, b)
                                 for a, b in zip(one, outside))}


def _serve_raises(mesh) -> dict:
    """``forward``'s prefill of each family inside a ``model`` group
    raises (its serve-time state is built at the whole width)."""
    out = {}
    for name in (RWKV, ZAMBA):
        cfg = _cfg(name)
        params, _ = ttrain.init_train_state(cfg, _run(False), _gen(), _opt(),
                                            device="cpu")
        with model_parallel(mesh.get_group("model")):
            try:
                tmodel.forward(params, cfg, tokens=torch.zeros(
                    (1, 4), dtype=torch.int64), mode="prefill")
                out[name] = ""
            except ValueError as e:
                out[name] = str(e)
    return out


def _restored_placements(mesh, ckpt: str) -> bool:
    """``init_train_state(mesh=)``'s parameters are the elastic restore's
    DTensors of the same whole values: the two-group hybrid with fsdp
    (``w_in`` and ``conv_w`` in contiguous column blocks over ``model``,
    ``embed`` over ``data``)."""
    from repro_torch.checkpoint import CheckpointManager

    cfg, run = _cfg(ZAMBA), _run(True)
    params, _ = ttrain.init_train_state(cfg, run, _gen(), _opt(), mesh=mesh,
                                        device="cpu")
    psh = tsh.param_shardings(tmodel.model_specs(cfg), mesh,
                              tsh.rules_for(mesh, run))
    got, _, _ = CheckpointManager(ckpt, device="cpu").restore(
        0, mesh=mesh, shardings=psh)
    g_of = dict(leaves(got))
    fused = [g_of[("layers", k)].placements for k in ("w_in", "conv_w")]
    return (all(any(q.is_shard() for q in pl) for pl in fused)
            and all(g_of[path].placements == p.placements
                    and torch.equal(g_of[path].to_local(), p.to_local())
                    for path, p in leaves(params)))


def _rec_rank(rank, n, device, mesh_name, ckpt):
    shape, names = MESHES[mesh_name]
    mesh = _mesh(device, shape, names)
    cases = CASES + ([H3_CASE] if mesh_name == "model2" else [])
    with _FloatMode(ftz=True):
        out = {"cases": {case: _tp_step(mesh, *case) for case in cases}}
    out.update({"blocks": {name: _block_check(mesh, name)
                           for name in (RWKV, ZAMBA)},
                "norm": _norm_check(mesh), "serve": _serve_raises(mesh),
                "restore": _restored_placements(mesh, ckpt)})
    if mesh_name == "data2_model2":
        out["pod"] = _tp_step(_mesh(device, *POD_MESH), *POD_CASE)
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
                _cfg(ZAMBA), _run(True), _gen(), _opt(), device="cpu")
            ckpt = str(tmp / "ckpt")
            CheckpointManager(ckpt, device="cpu").save(0, params, state,
                                                       blocking=True)
            n = int(np.prod(MESHES[mesh_name][0]))
            results[mesh_name] = _spawn(_rec_rank, n, tmp, mesh_name, ckpt)
        return results[mesh_name]
    return get


# ------------------------------------------------------------ the oracles

_ONE: dict = {}
_REF_GRADS: dict = {}


def _one_process(name: str, ftz: bool) -> dict:
    """The port's one-process step from the init in :class:`_FloatMode`
    ``ftz`` (once a name and mode: fsdp and remat do not change it): its
    loss, metrics and gradients, and each leaf's float32 ``floor``: the
    largest relative change of its gradient when every parameter is
    nudged by two ulps of random sign (two seeds)."""
    if (name, ftz) not in _ONE:
        cfg, run, opt = _cfg(name), _run(False), _opt()
        params, state = _init(cfg, run, opt)
        tb = _torch_batch(_batch(cfg))
        with _FloatMode(ftz):
            loss, metrics, g = ttrain._microbatched_grads(params, tb, cfg,
                                                          run)
            g = _flat_np(g)
            floor = dict.fromkeys(g, 0.0)
            for seed in (1, 2):
                gen = torch.Generator().manual_seed(SEED + 10 + seed)
                nudged = tree_map(lambda t: t * (1 + 2.0 ** -23 * torch.sign(
                    torch.randn(t.shape, generator=gen))), params)
                g2 = _flat_np(ttrain._microbatched_grads(nudged, tb, cfg,
                                                         run)[2])
                for k, v in g.items():
                    floor[k] = max(floor[k], _rel(v, g2[k]))
            # the step writes the new parameters into ``params``: last
            _, _, m = ttrain.make_train_step(cfg, run, opt)[0](params, state,
                                                               tb)
        _ONE[name, ftz] = {"loss": loss.item(),
                      "metrics": {k: v.item() for k, v in metrics.items()},
                      "grad_norm": m["grad_norm"].item(), "lr": m["lr"].item(),
                      "grads": g, "floor": floor}
    return _ONE[name, ftz]


def _bar(tol: float, floor: float) -> float:
    """A leaf's gradient bar: ``tol`` or ``FLOOR_X`` times its float32
    floor, whichever is larger."""
    return max(tol, FLOOR_X * floor)


def _grads_excess(want: dict, got: dict, floor: dict) -> float:
    """The worst leaf's gradient error over its bar (:func:`_bar` of
    ``TOL_GRADS``)."""
    return max(_rel(w, got[k]) / _bar(TOL_GRADS, floor[k])
               for k, w in want.items())


def _reference(name: str, params: dict, grads: dict):
    """The reference's ``_microbatched_grads`` on the whole batch (once a
    name) and its ``adamw_update`` of the step's own ``grads`` from its
    init: ``(loss, ce, grads, new params, new moments)``, float32 numpy."""
    import jax.numpy as jnp

    from repro.configs import RunConfig as RRun
    from repro.configs import smoke_config as r_smoke
    from repro.launch.train import _microbatched_grads
    from repro.optim import adamw as radam

    rp = _as_r(params)
    if name not in _REF_GRADS:
        rcfg = _cut(replace(r_smoke(_arch(name)), dtype="float32"), name)
        loss, metrics, rgrads = _microbatched_grads(
            rp, {k: jnp.asarray(v) for k, v in _batch(_cfg(name)).items()},
            rcfg, RRun(remat="none"))
        _REF_GRADS[name] = (float(loss), float(metrics["ce"]), {
            k: np.asarray(v, np.float32) for k, v in _flat(rgrads).items()})
    ropt = radam.AdamWConfig(lr=_opt().lr, warmup_steps=_opt().warmup_steps)
    new, new_state, _ = radam.adamw_update(rp, _as_r(grads),
                                           radam.adamw_init(rp, ropt), ropt)
    flat = lambda t: {k: np.asarray(v, np.float32)
                      for k, v in _flat(t).items()}
    return _REF_GRADS[name] + (flat(new), flat(_moments(new_state)))


def _check_step(outs: list, name: str, fsdp: bool, remat: str,
                ftz: bool = True) -> dict:
    """Every rank's step against the others, the port's one-process step
    in the same float mode and, with ``ftz`` for :data:`REF_NAMES`, the
    reference's composition, from the init.  Returns the errors read."""
    cfg, run, opt = _cfg(name), _run(fsdp, remat), _opt()
    _same_on_ranks(outs)
    r0, one = outs[0], _one_process(name, ftz)
    old, state = _init(cfg, run, opt)
    old_np, old_m = _flat_np(old), _flat_np(_moments(state))
    grads, new = _flat_np(r0["grads"]), _flat_np(r0["new"])
    new_m, m = _flat_np(r0["moments"]), r0["metrics"]
    rel = lambda a, b: abs(a - b) / abs(b)
    assert grads.keys() == one["grads"].keys()
    err = {"loss": rel(m["loss"], one["loss"]),
           "ce": rel(m["ce"], one["metrics"]["ce"]),
           "grad_norm": rel(m["grad_norm"], one["grad_norm"]),
           "grads": _grads_excess(one["grads"], grads, one["floor"])}
    assert m["lr"] == one["lr"] and m["moe_aux"] == 0

    want = tree_map(torch.clone, old)
    want_s = tree_map(torch.clone, state)
    tadam.adamw_update_(want, r0["grads"], want_s, opt)
    err["update"] = max(_update_err(_flat_np(want), new, old_np),
                        _update_err(_flat_np(_moments(want_s)), new_m, old_m))
    # the gradients' errors are read over their bars (_grads_excess)
    tols = {"grads": 1.0, "update": TOL_UPDATE}
    if ftz and name in REF_NAMES:
        loss, ce, rgrads, rnew, rnew_m = _reference(name, old, r0["grads"])
        err["ref_loss"] = rel(m["loss"], loss)
        err["ref_ce"] = rel(m["ce"], ce)
        # the reference's gradient tolerance, or the float32 floor
        err["ref_grads"] = max(
            _rel(rgrads[k], g) / _bar(fixture.tol("grads", "float32",
                                                  _arch(name)),
                                      one["floor"][k])
            for k, g in grads.items())
        err["ref_update"] = max(_update_err(rnew, new, old_np),
                                _update_err(rnew_m, new_m, old_m))
        tols.update(ref_grads=1.0, ref_update=TOL_REF_UPDATE)
    floored = {k: f for k, f in one["floor"].items()
               if FLOOR_X * f > TOL_GRADS}
    worst = max((_rel(g, grads[k]), k) for k, g in one["grads"].items())
    print(f"{name} fsdp={fsdp} remat={remat} on {len(outs)} ranks: "
          f"errors {err} (gradients over their bars; the worst leaf's "
          f"own error {worst}); leaves held at twice their float32 floor "
          f"{floored}")
    for k, v in err.items():
        tol = tols.get(k, TOL_LOSS)
        assert v <= tol, (k, v, tol)
    return err


def _check_bytes(outs: list, name: str) -> None:
    """Each leaf placed by the rules, and a rank's local parameter bytes
    exactly what they give it."""
    for o in outs:
        loc, want, full = o["bytes"]
        assert o["placed"] and loc == want, (loc, want)
    print(f"{name}: local over full parameter bytes {loc / full:.4f}")


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("name, fsdp, remat", CASES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_recurrent_tp_step_matches_one_process_and_reference(
        ranks, mesh_name, name, fsdp, remat):
    """One AdamW step of RWKV6 or the Mamba2 hybrid with their heads split
    over a ``model`` axis of 2, against the port's one-process step and
    the reference's composition (the module docstring's bars); the same
    bits on every rank; each leaf placed by the rules, and each rank the
    bytes they give it."""
    outs = [o["cases"][name, fsdp, remat] for o in ranks(mesh_name)]
    _check_step(outs, name, fsdp, remat)
    _check_bytes(outs, name)


def test_hybrid_shared_heads_the_axis_does_not_divide(ranks):
    """The two-group hybrid with 3 shared-attention heads on ``(data=1,
    model=2)``, fsdp and remat: the Mamba2 heads split as before, the
    shared attention's heads ``[0, 1)`` and ``[1, 3)`` cut from its
    leaves gathered whole; held to the one-process step as the other
    two-group cases."""
    outs = [o["cases"][H3_CASE] for o in ranks("model2")]
    _check_step(outs, *H3_CASE)
    _check_bytes(outs, H3_CASE[0])


def test_recurrent_tp_step_on_pod_data_model_mesh(ranks):
    """The four ranks as ``(pod=1, data=2, model=2)`` with fsdp and remat
    (the recomputation re-enters the ``model`` group), subnormals kept:
    the two-group hybrid's step is held to the one-process step as on
    ``(data=2, model=2)``."""
    outs = [o["pod"] for o in ranks("data2_model2")]
    _check_step(outs, *POD_CASE, ftz=False)
    _check_bytes(outs, POD_CASE[0])


@pytest.mark.parametrize("name", [RWKV, ZAMBA])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_recurrent_block_under_model_parallel_matches_one_process(
        ranks, mesh_name, name):
    """``rwkv6_apply`` / ``mamba2_apply`` on a rank's slices under
    ``model_parallel`` equal the one-process block: the output within
    ``TOL_BLOCK``, whole on every rank and the same bits on each; within
    ``TOL_GRADS``, the input's gradient and every leaf's, whole ones (``mu_*``, ``wA``, ``cr``,
    ``ln``…) and split ones alike, where a whole leaf's gradient summed
    over ``model`` would miss the bar many times over."""
    outs = [o["blocks"][name] for o in ranks(mesh_name)]
    for o in outs:
        print(f"{name} block on {mesh_name}: out {o['out_rel']:.3g}, "
              f"grads {o['grads_rel']}")
        assert o["out_rel"] <= TOL_BLOCK, o["out_rel"]
        assert max(o["grads_rel"].values()) <= TOL_GRADS, o["grads_rel"]
        assert o["whole"] and min(o["twice_rel"].values()) > 100 * TOL_GRADS
        assert torch.equal(o["out"], outs[0]["out"])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_split_rmsnorm_matches_rmsnorm(ranks, mesh_name):
    """The norm over heads split across two ranks equals ``rmsnorm`` of
    the whole vector: the output, the input's gradient and the gain's
    (counted once), within ``TOL_BLOCK``; outside a ``model`` group it is
    ``rmsnorm`` bit for bit."""
    for o in ranks(mesh_name):
        v = o["norm"]
        print(f"split_rmsnorm on {mesh_name}: output, input and gain "
              f"gradients {v['rel']}")
        assert max(v["rel"]) <= TOL_BLOCK and v["outside_equal"], v


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_recurrent_serving_raises_inside_a_model_group(ranks, mesh_name):
    """``forward``'s prefill of RWKV6 and of the hybrid inside a ``model``
    group raises: their serve-time states are built at the whole
    width."""
    for o in ranks(mesh_name):
        assert all("whole width" in e for e in o["serve"].values()), o[
            "serve"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_init_train_state_places_as_the_restore(ranks, mesh_name):
    """``init_train_state(mesh=)``'s parameters of the two-group hybrid
    with fsdp are the elastic restore's DTensors of the same whole values,
    ``w_in`` and ``conv_w`` split over ``model``."""
    assert all(o["restore"] for o in ranks(mesh_name))


@pytest.mark.parametrize("shape, names", [MESHES["model2"],
                                          MESHES["data2_model2"], POD_MESH])
def test_undivided_heads_raise_before_any_collective(shape, names):
    """On a ``model`` axis of 2 (an ``AbstractMesh``: no process group, so
    any collective would fail otherwise) RWKV6 with 3 heads and the hybrid
    with 3 Mamba2 heads raise naming 2.6b-4b-3b; the smoke configurations
    pass the check, 3 shared-attention heads included."""
    from repro_torch.launch.mesh import AbstractMesh

    mesh = AbstractMesh(shape, names)
    run = _run(True)
    for cfg in (replace(_cfg(RWKV), d_model=96),
                replace(_cfg(ZAMBA), d_model=96, ssm_head=64)):
        with pytest.raises(ValueError, match="2.6b-4b-3b"):
            ttrain.make_train_step(cfg, run, _opt(), mesh=mesh)
    for name in (RWKV, ZAMBA, ZAMBA1, ZAMBA_H3):
        ttrain._check_model_axis(_cfg(name), run, _opt(), mesh)
