"""The int8-compressed train step with a ``data`` axis wider than 1, on
the CPU: gloo ranks of ``test_torch_mesh_ranks._spawn`` (spawned, a
``file://`` rendezvous, a 60 s group timeout and a 180 s join timeout,
one intra-op thread a rank; no rank imports ``jax`` or ``repro``) and,
marked ``cuda``, four ranks on one card.

``make_train_step_compressed(mesh=)`` and ``init_replica_state(mesh=)``
on ``(pod=2, data=2, model=1)``: each rank holds its pod's replica,
takes its rows of the global batch, the pod's two data ranks sum their
float32 gradients, and the int8 codes cross between the ranks at one
data coordinate, one a pod.  Two steps under AdamW on the bf16
deepseek smoke and under Adafactor on the float32 musicgen smoke, from
the numpy-seeded parameters (``make_card_reference.model_tree``) carried
into the port by ``convert.params_from_reference``.  The int8 codes turn
a float32 rounding difference into a whole quantization step, so two
runs part from their first step: each step is held from the ranks' own
state before it.

* the two data ranks of a pod: the same bits in everything (the
  exchange's inputs and outputs, metrics, parameters, optimizer state,
  error feedback); the four replicas and their optimizer states the same
  bits;
* each pod's exchange input (its data-reduced gradient plus its
  residual) against the one-process ``make_train_step_compressed(
  n_pods=2)`` from the same state on the same batch, and against the
  reference's ``jax.value_and_grad(loss_fn)`` on the pod's rows (run in
  a child process, this file as a script, with
  ``--xla_allow_excess_precision=false``) plus the residual: within
  ``make_card_reference.tol("grads", dtype)`` of each leaf's largest
  magnitude (1e-5 in float32; 2.5e-2 in bf16, where the pod's gradient
  is the float32 sum of two bf16 partials rounded once, the one-process
  gradient one bf16 backward);
* the exchange's outputs (the mean and each pod's new residual) equal
  the reference's eager ``_quant_leaf`` / ``_dequant_leaf`` composition
  of the two pods' recorded inputs, bit for bit;
* the loss, ``ce`` and ``moe_aux`` within 1e-6 (relative) of the
  one-process step's, ``grad_norm`` (the exchanged mean's) within 1e-6
  in float32 and 1e-4 in bf16, and the same bits on every rank; each
  rank's new parameters the one-process update of its own mean (within
  1e-6 of each leaf's largest update plus one ulp in float32; bf16
  equal or one bf16 step apart in at most 1 % of a leaf's values);
* kernels 7 and 8 called once a leaf a step on each rank.

Unequal shares of masked labels in the two rows of each rank show that
the loss divides by the pod's count of labels: the rank's count or the
world's would miss the one-process loss by more than 1e-3.  On
``(pod=1, data=2)`` and ``(data=2, model=1)`` (two ranks) no kernel
runs, and the step is the one-process ``n_pods=1`` step.  A granite-MoE
smoke routes in the pod's token groups (``moe_aux`` against one
process), and a batch whose group would span data ranks raises, as
does a batch that the four ranks do not divide.
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
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.optim import adafactor as tada
from repro_torch.optim import adamw as tadam
from repro_torch.optim.tree import leaves
from test_torch_mesh_ranks import STEP_CASES, _CountQdq, _mesh, _spawn

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "make_card_reference",
    os.path.join(HERE, "card_reference", "make_card_reference.py"))
fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture)

POD_DATA = ((2, 2, 1), ("pod", "data", "model"))
PODS, DATA = 2, 2
#: the meshes of one pod, two ranks each
ONE_POD = {"pod1_data2": ((1, 2, 1), ("pod", "data", "model")),
           "data2": ((2, 1), ("data", "model"))}
SEED = 53
STEPS = 2
BATCH = (8, 16)
#: the one-pod, unequal-label and indivisible cases
PLAIN_ARCH = "deepseek_7b"
INDIVISIBLE = (6, 16)
#: 16 × 1,024 tokens: a pod's 8,192 make two groups of 4,096, one a
#: data rank; at 8 × 1,024 a pod's one group would span its two ranks
MOE_ARCH, MOE_BATCH, MOE_SPANNING = "granite_moe_1b_a400m", (16, 1024), \
    (8, 1024)
TOL_METRICS, TOL_UPDATE = 1e-6, 1e-6
#: ``grad_norm``, the norm of the exchanged mean: in bf16 the gradients
#: are held at the bf16 gradient tolerance, their norm at the bf16 loss
#: tolerance (``make_card_reference.TOL``; 3.3e-6 read)
TOL_NORM = {"float32": TOL_METRICS, "bfloat16": fixture.tol("loss",
                                                            "bfloat16")}
#: the unequal-label case: how far the rank's or the world's label count
#: must put the loss from the pod's
WRONG_COUNT_MIN = 1e-3


def _cfg(arch: str, dtype: str):
    return replace(smoke_config(arch), dtype=dtype)


def _setup(optimizer: str):
    arch, dtype = STEP_CASES[optimizer]
    opt = (tadam.AdamWConfig(lr=1e-2, warmup_steps=1)
           if optimizer == "adamw"
           else tada.AdafactorConfig(lr=1e-2, warmup_steps=1))
    return (_cfg(arch, dtype), RunConfig(optimizer=optimizer, remat="none"),
            opt)


def _plain_setup(arch: str = PLAIN_ARCH):
    return (_cfg(arch, "float32"), RunConfig(remat="none"),
            tadam.AdamWConfig(lr=1e-2, warmup_steps=1))


def _batch(cfg, shape: tuple, seed: int, unequal: bool = False) -> dict:
    """``make_card_reference.train_batch``; with ``unequal``, row ``r``
    masks a share of its labels falling from 0.8 to 0 (so each rank's
    rows hold a different count of labels)."""
    b = fixture.train_batch(cfg, shape, seed)
    if unequal:
        rng = np.random.default_rng(seed + 1)
        share = np.linspace(0.8, 0.0, shape[0])[:, None]
        b["labels"][rng.random(shape) < share] = -1
    return b


def _torch_batch(b: dict, device: str = "cpu") -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _params(cfg, device: str) -> dict:
    return params_from_reference(
        fixture.model_tree(tmodel.model_specs(cfg), cfg, SEED), cfg,
        device=device)


def _gen(device: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(SEED)


def _host(tree) -> dict:
    """``{"a/b": host copy}`` of a tree's leaves."""
    return {"/".join(path): t.detach().cpu().clone()
            for path, t in leaves(tree)}


class _Exchange:
    """While active, host copies of the trees that ``launch.train``'s
    step gives ``compress_pod_reduce``, before (``g``, ``e``) and after
    (``mean``, ``new_e``), the replica axis kept."""

    def __enter__(self):
        self.orig, self.seen = ttrain.compress_pod_reduce, {}

        def recording(grads, ef, **kw):
            self.seen.update(g=_host(grads), e=_host(ef))
            out = self.orig(grads, ef, **kw)
            self.seen.update(mean=_host(grads), new_e=_host(ef))
            return out
        ttrain.compress_pod_reduce = recording
        return self.seen

    def __exit__(self, *exc):
        ttrain.compress_pod_reduce = self.orig


class _Partials:
    """While active, each ``value_and_grad`` call's ``ce``, the label
    count it divides by, and its batch's own count."""

    def __enter__(self):
        self.orig, self.seen = ttrain.value_and_grad, []

        def recording(params, batch, cfg, run, **kw):
            out = self.orig(params, batch, cfg, run, **kw)
            self.seen.append({"ce": float(out[1]["ce"]),
                              "label_count": int(kw["label_count"]),
                              "local": int((batch["labels"] >= 0).sum())})
            return out
        ttrain.value_and_grad = recording
        return self.seen

    def __exit__(self, *exc):
        ttrain.value_and_grad = self.orig


# ------------------------------------------------------------ the ranks

def _steps(mesh, device: str, cfg, run, opt, batches: list) -> dict:
    """``init_replica_state(mesh=)`` with the numpy-seeded parameters
    copied in, then a step on each of ``batches``: each step's state
    before it, what the exchange saw, the kernel calls and the metrics;
    the state after the last step."""
    p, o, e = ttrain.init_replica_state(cfg, run, None, _gen(device), opt,
                                        mesh=mesh, device=device)
    out = {"init": {"params": _host(p), "ef": _host(e)}, "steps": []}
    seeded = dict(leaves(_params(cfg, device)))
    for path, leaf in leaves(p):
        leaf[0].copy_(seeded[path])
    step, _ = ttrain.make_train_step_compressed(cfg, run, opt_cfg=opt,
                                                mesh=mesh)
    for b in batches:
        rec = {"pre": {"params": _host(p), "opt": _host(o), "ef": _host(e)}}
        with _Exchange() as seen, _CountQdq(device) as calls:
            m = step(p, o, e, _torch_batch(b, device))[3]
        rec.update(seen, calls=dict(calls),
                   metrics={k: v.detach().cpu().clone() for k, v in m.items()})
        out["steps"].append(rec)
    out["post"] = {"params": _host(p), "opt": _host(o), "ef": _host(e)}
    return out


def _raises(mesh, device: str, cfg, batch: dict) -> str | None:
    """The ``ValueError`` that a step on ``batch`` raises, if any."""
    run = RunConfig(remat="none")
    p, o, e = ttrain.init_replica_state(cfg, run, None, _gen(device),
                                        mesh=mesh, device=device)
    step, _ = ttrain.make_train_step_compressed(cfg, run, mesh=mesh)
    try:
        step(p, o, e, _torch_batch(batch, device))
    except ValueError as err:
        return str(err)
    return None


def _pod_data_rank(rank, n, device):
    mesh = _mesh(device, *POD_DATA)
    out = {"coord": mesh.get_coordinate()}
    for optimizer in STEP_CASES:
        cfg, run, opt = _setup(optimizer)
        out[optimizer] = _steps(mesh, device, cfg, run, opt, [
            _batch(cfg, BATCH, SEED + 1 + i) for i in range(STEPS)])
    if device != "cpu":
        return out
    cfg, run, opt = _plain_setup()
    with _Partials() as partials:
        out["unequal"] = _steps(mesh, device, cfg, run, opt, [
            _batch(cfg, BATCH, SEED + 3, unequal=True)])
    out["unequal"]["partials"] = partials
    cfg, run, opt = _plain_setup(MOE_ARCH)
    out["moe"] = _steps(mesh, device, cfg, run, opt,
                        [_batch(cfg, MOE_BATCH, SEED + 4)])
    out["moe_spanning"] = _raises(mesh, device, cfg,
                                  _batch(cfg, MOE_SPANNING, SEED + 4))
    cfg = _plain_setup()[0]
    out["indivisible"] = _raises(mesh, device, cfg,
                                 _batch(cfg, INDIVISIBLE, SEED + 5))
    return out


def _one_pod_rank(rank, n, device):
    cfg, run, opt = _plain_setup()
    return {name: _steps(_mesh(device, shape, names), device, cfg, run, opt,
                         [_batch(cfg, BATCH, SEED + 6, unequal=True)])
            for name, (shape, names) in ONE_POD.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(which)``: every rank's results, ``"pod_data"`` (four ranks)
    or ``"one_pod"`` (two), from one spawn each."""
    results = {}

    def get(which: str) -> list:
        if which not in results:
            fn, n = {"pod_data": (_pod_data_rank, PODS * DATA),
                     "one_pod": (_one_pod_rank, 2)}[which]
            results[which] = _spawn(fn, n, tmp_path_factory.mktemp(which))
        return results[which]
    return get


# ------------------------------------------------------------ the oracles

def _stack(recs: list, key: str, part: str, device: str) -> dict:
    """A one-process ``(len(recs), …)`` tree on ``device`` of each
    record's ``rec[key][part]`` (a leading axis of 1 each)."""
    first = recs[0][key][part]
    return fixture.nested({k: torch.cat([r[key][part][k] for r in recs])
                           .to(device) for k in first})


def _one_process(cfg, run, opt, recs: list, batch: dict,
                 device: str = "cpu") -> dict:
    """The one-process step on ``device`` with ``len(recs)`` replicas from
    the state each of ``recs`` (one step's record a pod) held before it:
    its metrics, its gradients and each replica's exchange input ``g +
    e`` (float32; host copies, flat)."""
    n = len(recs)
    p_r, o_r, e_r = (_stack(recs, "pre", part, device)
                     for part in ("params", "opt", "ef"))
    o_r["step"] = o_r["step"].cpu()          # the step counter's home
    step, _ = ttrain.make_train_step_compressed(cfg, run, n, opt)
    with _Exchange() as seen:
        m = step(p_r, o_r, e_r, _torch_batch(batch, device))[3]
    return {"metrics": m, "g": seen["g"],
            "x": [{k: seen["g"][k][r].float() + seen["e"][k][r]
                   for k in seen["g"]} for r in range(n)]}


def _x(rec: dict) -> dict:
    """A rank's exchange input: its data-reduced gradient plus its
    residual, float32."""
    return {k: g[0].float() + rec["e"][k][0] for k, g in rec["g"].items()}


def _rel(want, got) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-30))


def _metric_err(want: dict, got: dict) -> float:
    """The largest relative error of the loss, ``ce`` and ``moe_aux``."""
    return max(abs(float(got[k]) - float(want[k]))
               / max(abs(float(want[k])), 1e-30)
               for k in ("loss", "ce", "moe_aux"))


def _check_update(cfg, opt, pre: dict, mean: dict, post: dict,
                  device: str = "cpu") -> None:
    """``post`` against the one-process update on ``device`` of ``mean``
    on ``pre`` (the module docstring's rule)."""
    on = lambda flat: fixture.nested(
        {k: v[0].to(device if k != "step" else "cpu", copy=True)
         for k, v in flat.items()})
    want = on(pre["params"])
    ttrain._UPDATE_[type(opt)](want, on(mean), on(pre["opt"]), opt)
    for path, w in _host(want).items():
        g, o = post["params"][path][0], pre["params"][path][0]
        if cfg.dtype == "bfloat16":
            w, g = w.float().numpy(), g.float().numpy()
            diff = np.abs(g - w)
            assert (diff <= np.spacing(np.abs(w)) * 2 ** 16).all(), path
            assert (diff > 0).mean() <= 0.01, path
        else:
            w, g, o = (t.double().numpy() for t in (w, g, o))
            limit = TOL_UPDATE * np.abs(w - o).max() + np.spacing(
                np.abs(w).astype(np.float32))
            assert (np.abs(g - w) <= limit).all(), path


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _check_pod_data(outs: list, cfg, run, opt, batches: list,
                    device: str = "cpu", tol_metrics: float = TOL_METRICS
                    ) -> float:
    """Every step of a ``(pod=2, data=2)`` case (``_steps`` on each rank)
    against the ranks' partners and the one-process step on ``device``;
    returns the worst exchange-input error read."""
    n_leaves = len(outs[0]["init"]["params"])
    tol = fixture.tol("grads", cfg.dtype)
    worst = 0.0
    for i, b in enumerate(batches):
        recs = [o["steps"][i] for o in outs]
        for r, rec in enumerate(recs):
            assert rec["calls"] == {"group_quant": n_leaves,
                                    "group_dequant": n_leaves}, (i, r)
            for key in ("g", "e", "mean", "new_e"):
                assert _same(rec[key], recs[r - r % DATA][key]), (i, r, key)
            assert _same(rec["metrics"], recs[0]["metrics"]), (i, r)
            assert _same(rec["mean"], recs[0]["mean"]), (i, r)
            for part in ("params", "opt"):
                assert _same(rec["pre"][part], recs[0]["pre"][part]), (i, r)
            _check_update(cfg, opt, rec["pre"], rec["mean"],
                          outs[r]["steps"][i + 1]["pre"]
                          if i + 1 < len(batches) else outs[r]["post"],
                          device)
        pods = [recs[p * DATA] for p in range(PODS)]
        one = _one_process(cfg, run, opt, pods, b, device)
        err = _metric_err(one["metrics"], recs[0]["metrics"])
        assert err <= tol_metrics, (i, err)
        err = _rel(float(one["metrics"]["grad_norm"]),
                   float(recs[0]["metrics"]["grad_norm"]))
        assert err <= TOL_NORM[cfg.dtype], (i, err)
        assert float(recs[0]["metrics"]["lr"]) == float(one["metrics"]["lr"])
        for p in range(PODS):
            mine = _x(pods[p])
            for k, want in one["x"][p].items():
                e = _rel(want.numpy(), mine[k].numpy())
                worst = max(worst, e)
                assert e <= tol, (i, p, k, e, tol)
    for r, o in enumerate(outs):
        for part in ("params", "opt"):
            assert _same(o["post"][part], outs[0]["post"][part]), (r, part)
        assert _same(o["post"]["ef"], outs[r - r % DATA]["post"]["ef"]), r
    assert any(float(v.abs().max()) > 0
               for v in outs[0]["post"]["ef"].values())
    return worst


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("optimizer", list(STEP_CASES))
def test_pod_data_step_matches_one_process(ranks, optimizer):
    """Two steps on ``(pod=2, data=2)``: the partners and replicas the
    same bits, the exchange inputs and metrics the one-process step's
    from the same state, the update of each rank's own mean, kernels 7
    and 8 once a leaf a step (the module docstring's tolerances)."""
    outs = [o[optimizer] for o in ranks("pod_data")]
    cfg, run, opt = _setup(optimizer)
    batches = [_batch(cfg, BATCH, SEED + 1 + i) for i in range(STEPS)]
    worst = _check_pod_data(outs, cfg, run, opt, batches)
    print(f"{optimizer} {cfg.name} {cfg.dtype}: exchange inputs {worst} "
          f"from one process")
    losses = [float(o["steps"][i]["metrics"]["loss"]) for o in outs[:1]
              for i in range(STEPS)]
    assert np.isfinite(losses).all() and losses[1] != losses[0]


def _reference_grads(src: str, dst: str) -> None:
    """The reference's ``jax.value_and_grad(loss_fn)`` on each pod's rows
    at each step's parameters of ``src``: losses and float32 gradients
    saved to ``dst``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import RunConfig as RRun
    from repro.configs import smoke_config as r_smoke
    from repro.launch.train import loss_fn
    from repro.models import model as rmodel

    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    with np.load(src) as z:
        data = {k: z[k] for k in z.files}
    out = {}
    for optimizer, (arch, dtype) in STEP_CASES.items():
        cfg = replace(r_smoke(arch), dtype=dtype)
        specs = rmodel.model_specs(cfg)
        run = RRun(optimizer=optimizer, remat="none")
        vg = jax.jit(jax.value_and_grad(
            lambda p, b, cfg=cfg, run=run: loss_fn(p, b, cfg, run),
            has_aux=True))
        for i in range(STEPS):
            tag = f"{optimizer}/step{i}"
            pre = f"{tag}/params/"
            params = fixture._as_reference(fixture.nested(
                {k[len(pre):]: v for k, v in data.items()
                 if k.startswith(pre)}), specs)
            batch = _batch(cfg, BATCH, SEED + 1 + i)
            rows = BATCH[0] // PODS
            for p in range(PODS):
                (loss, _), grads = vg(params, {
                    k: jnp.asarray(v[p * rows:(p + 1) * rows])
                    for k, v in batch.items()})
                out[f"{tag}/pod{p}/loss"] = f32(loss)
                out.update({f"{tag}/pod{p}/grads/{k}": f32(v)
                            for k, v in fixture.flat(grads).items()})
    np.savez(dst, **out)


def _run_reference(tmp, outs_by_case: dict) -> dict:
    src, dst = str(tmp / "params.npz"), str(tmp / "grads.npz")
    np.savez(src, **{f"{opt}/step{i}/params/{k}": v[0].float().numpy()
                     for opt, outs in outs_by_case.items()
                     for i in range(STEPS)
                     for k, v in outs[0]["steps"][i]["pre"]["params"].items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(os.path.join(HERE, "..", "src")), HERE]
        + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), src,
                           dst], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(dst) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def reference(ranks, tmp_path_factory):
    outs = ranks("pod_data")
    return _run_reference(tmp_path_factory.mktemp("reference"),
                          {opt: [o[opt] for o in outs] for opt in STEP_CASES})


@pytest.mark.parametrize("optimizer", list(STEP_CASES))
def test_pod_data_step_matches_reference(ranks, reference, optimizer):
    """Each pod's exchange input, at each step, against the reference's
    gradient of the pod's rows at the step's parameters plus the pod's
    residual; the exchange's mean and residuals against the reference's
    eager composition of the two pods' inputs, bit for bit."""
    import jax.numpy as jnp

    outs = [o[optimizer] for o in ranks("pod_data")]
    cfg = _setup(optimizer)[0]
    tol = fixture.tol("grads", cfg.dtype)
    worst = 0.0
    for i in range(STEPS):
        pods = [outs[p * DATA]["steps"][i] for p in range(PODS)]
        xs = [_x(rec) for rec in pods]
        for p, rec in enumerate(pods):
            for k, x in xs[p].items():
                want = (reference[f"{optimizer}/step{i}/pod{p}/grads/{k}"]
                        + rec["e"][k][0].numpy())
                e = _rel(want, x.numpy())
                worst = max(worst, e)
                assert e <= tol, (i, p, k, e, tol)
        zeros = {k: jnp.zeros(x.shape, jnp.float32) for k, x in xs[0].items()}
        mean, new_e = fixture.reference_exchange(
            [{k: jnp.asarray(x.numpy()) for k, x in xs[p].items()}
             for p in range(PODS)], [zeros] * PODS)
        for p, rec in enumerate(pods):
            for k, m in rec["mean"].items():
                want = np.array(mean[k].astype(jnp.float32))
                assert torch.equal(m[0], torch.from_numpy(want).to(m.dtype)), \
                    (i, k)
                np.testing.assert_array_equal(rec["new_e"][k][0].numpy(),
                                              np.asarray(new_e[p][k]))
    print(f"{optimizer} {cfg.name} {cfg.dtype}: exchange inputs {worst} "
          f"from the reference")


def test_loss_divides_by_the_pods_label_count(ranks):
    """Rows with unequal shares of masked labels: the ranks of a pod
    count different labels; the step's metrics are the one-process
    step's, and a loss over the rank's own count or the world's would
    miss them by more than ``WRONG_COUNT_MIN``."""
    outs = [o["unequal"] for o in ranks("pod_data")]
    cfg, run, opt = _plain_setup()
    batch = _batch(cfg, BATCH, SEED + 3, unequal=True)
    _check_pod_data(outs, cfg, run, opt, [batch])
    parts = [o["partials"][0] for o in outs]
    world = sum(q["local"] for q in parts)
    pods = [parts[p * DATA:(p + 1) * DATA] for p in range(PODS)]
    for pod in pods:
        assert pod[0]["local"] != pod[1]["local"], pod
        assert all(q["label_count"] == sum(x["local"] for x in pod)
                   for q in pod), pod
    # each rank's masked sum, and the pods' mean ce under each count
    sums = [[q["ce"] * q["label_count"] for q in pod] for pod in pods]
    want = float(outs[0]["steps"][0]["metrics"]["ce"])
    mean = lambda f: sum(f(pod, s) for pod, s in zip(pods, sums)) / PODS
    pod_count = mean(lambda pod, s: sum(s) / pod[0]["label_count"])
    local = mean(lambda pod, s: sum(x / q["local"] for x, q in zip(s, pod)))
    world_count = mean(lambda pod, s: sum(s) / world)
    assert abs(pod_count - want) <= TOL_METRICS * abs(want)
    for wrong in (local, world_count):
        assert abs(wrong - want) > WRONG_COUNT_MIN * abs(want), (wrong, want)


@pytest.mark.parametrize("mesh_name", list(ONE_POD))
def test_one_pod_meshes_match_one_process(ranks, mesh_name):
    """One pod of two data ranks: no kernel-7 or kernel-8 call; the two
    ranks the same bits; the data-reduced gradient and the metrics the
    one-process ``n_pods=1`` step's, the new parameters the update of
    the reduced gradient."""
    outs = [o[mesh_name] for o in ranks("one_pod")]
    cfg, run, opt = _plain_setup()
    batch = _batch(cfg, BATCH, SEED + 6, unequal=True)
    recs = [o["steps"][0] for o in outs]
    assert all(r["calls"] == {"group_quant": 0, "group_dequant": 0}
               for r in recs)
    for key in ("g", "mean", "metrics"):
        assert _same(recs[0][key], recs[1][key]), key
    for part in ("params", "opt", "ef"):
        assert _same(outs[0]["post"][part], outs[1]["post"][part]), part
    assert _same(recs[0]["g"], recs[0]["mean"])
    assert all(float(v.abs().max()) == 0
               for v in outs[0]["post"]["ef"].values())
    one = _one_process(cfg, run, opt, recs[:1], batch)
    assert _metric_err(one["metrics"], recs[0]["metrics"]) <= TOL_METRICS
    assert _rel(float(one["metrics"]["grad_norm"]), float(
        recs[0]["metrics"]["grad_norm"])) <= TOL_METRICS
    for k, want in one["g"].items():
        e = _rel(want[0].numpy(), recs[0]["g"][k][0].numpy())
        assert e <= fixture.tol("grads", "float32"), (k, e)
    _check_update(cfg, opt, recs[0]["pre"], recs[0]["mean"],
                  outs[0]["post"])


def test_moe_groups_sized_by_the_pod(ranks):
    """A granite-MoE smoke on ``(pod=2, data=2)``: a pod's 8,192 tokens
    make two groups of 4,096, one a data rank; ``moe_aux`` and the
    exchange inputs are the one-process step's; a batch whose one group
    a pod would span its data ranks raises on every rank."""
    outs = ranks("pod_data")
    cfg, run, opt = _plain_setup(MOE_ARCH)
    _check_pod_data([o["moe"] for o in outs], cfg, run, opt,
                    [_batch(cfg, MOE_BATCH, SEED + 4)])
    assert float(outs[0]["moe"]["steps"][0]["metrics"]["moe_aux"]) > 0
    for o in outs:
        assert "spans ranks" in (o["moe_spanning"] or ""), o["moe_spanning"]


def test_indivisible_batch_raises(ranks):
    """A batch of 6 rows does not split over 2 pods of 2 data ranks: the
    step raises ``ValueError`` on every rank, before any collective."""
    for o in ranks("pod_data"):
        assert "does not split" in (o["indivisible"] or ""), o["indivisible"]


def test_init_replica_state_on_the_data_axis(ranks):
    """``init_replica_state(mesh=)`` on ``(pod=2, data=2)``: one replica a
    rank (a leading axis of 1), the same values on every rank from its
    equally seeded generator, zero error feedback; each rank at its
    ``(pod, data)`` coordinate in rank order."""
    outs = ranks("pod_data")
    assert [list(o["coord"]) for o in outs] == [[p, d, 0] for p in range(PODS)
                                          for d in range(DATA)]
    for optimizer in STEP_CASES:
        inits = [o[optimizer]["init"] for o in outs]
        for init in inits:
            assert all(v.shape[0] == 1 for v in init["params"].values())
            assert _same(init["params"], inits[0]["params"])
            assert all(float(v.abs().max()) == 0
                       for v in init["ef"].values())


def test_compressed_step_builds_on_data_axes():
    """The step and the state build on ``(pod=2, data=2)``, ``(pod=1,
    data=2)`` and ``(data=2, model=1)``; ``fsdp``, a ``model`` axis wider
    than 1 (ROADMAP item 2.6b-4), other axes and an ``n_pods`` that the
    mesh contradicts raise."""
    from repro_torch.launch.mesh import AbstractMesh

    cfg, run, opt = _plain_setup()
    for shape, names in [POD_DATA, *ONE_POD.values()]:
        mesh = AbstractMesh(shape, names)
        step, _ = ttrain.make_train_step_compressed(cfg, run, opt_cfg=opt,
                                                    mesh=mesh)
        assert callable(step)
        p, _, e = ttrain.init_replica_state(cfg, run, None, _gen("cpu"),
                                            opt, mesh=mesh, device="cpu")
        assert all(v.shape[0] == 1 for tree in (p, e)
                   for _, v in leaves(tree))
    with pytest.raises(ValueError, match="fsdp"):
        ttrain.make_train_step_compressed(
            cfg, replace(run, fsdp=True), opt_cfg=opt,
            mesh=AbstractMesh(*POD_DATA))
    for shape, names in (((2, 2, 2), ("pod", "data", "model")),
                         ((2, 2), ("data", "model"))):
        mesh = AbstractMesh(shape, names)
        with pytest.raises(ValueError, match="2.6b-4"):
            ttrain.make_train_step_compressed(cfg, run, opt_cfg=opt,
                                              mesh=mesh)
        with pytest.raises(ValueError, match="2.6b-4"):
            ttrain.init_replica_state(cfg, run, None, _gen("cpu"), opt,
                                      mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        ttrain.make_train_step_compressed(
            cfg, run, opt_cfg=opt, mesh=AbstractMesh((2, 2), ("pod", "data")))
    with pytest.raises(ValueError, match="pods"):
        ttrain.make_train_step_compressed(cfg, run, 1, opt,
                                          mesh=AbstractMesh(*POD_DATA))


# ------------------------------------------------------------ the card

@pytest.mark.cuda
def test_pod_data_step_on_card(tmp_path):
    """Four gloo ranks on ``cuda:0`` as ``(pod=2, data=2)``: both step
    cases held as on the CPU against the one-process step and update on
    the card from the ranks' recorded state (the partners and replicas
    the same bits, the exchange inputs), the metrics at the shared loss
    tolerance (``make_card_reference.tol("loss", dtype)``: cuBLAS rounds
    a bf16 product of two rows and of four apart), and the wrappers' own
    launch counts one a leaf a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import build

    build.build_all()          # the ranks load the built kernels only
    outs = _spawn(_pod_data_rank, PODS * DATA, tmp_path, device="cuda")
    for optimizer in STEP_CASES:
        cfg, run, opt = _setup(optimizer)
        _check_pod_data([o[optimizer] for o in outs], cfg, run, opt,
                        [_batch(cfg, BATCH, SEED + 1 + i)
                         for i in range(STEPS)], device="cuda",
                        tol_metrics=fixture.tol("loss", cfg.dtype))


if __name__ == "__main__":
    _reference_grads(sys.argv[1], sys.argv[2])
