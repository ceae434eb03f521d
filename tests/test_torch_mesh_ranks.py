"""The mesh across real ranks: gloo processes on the CPU (``device="cpu"``)
and, marked ``cuda``, two ranks on one card.

Each case spawns its ranks (``torch.multiprocessing``, spawn) that meet
at a ``file://`` rendezvous under ``tmp_path``, with a 60 s process-group
timeout and a join timeout of their own; a rank that raises fails the
case with its traceback.  Every rank runs at one intra-op thread and
computes the one-process oracle itself, at that thread count, so the
two forms run the same reductions; it holds its own replica or shard
against the oracle bit for bit.  No rank imports ``jax`` or ``repro``
(each checks before it reports).

* the int8 gradient exchange at 2, 3 and 4 ranks, float32 and bf16
  gradients: ``compress_pod_reduce(mesh=)`` against the one-process
  ``compress_pod_reduce(n_pods=)`` (which ``test_torch_train.py`` holds
  to the reference's eager exchange), the mean and every residual;
  kernels 7 and 8 once a leaf on each rank;
* ``make_train_step_compressed(mesh=)`` for 2 steps, AdamW and
  Adafactor, at 2 and 4 ranks, against the one-process step on the same
  global batches: parameters, optimizer state, error feedback, metrics;
* the elastic restore onto ``(data=2)`` and ``(data=2, model=2)`` with
  ``fsdp=True``, of a checkpoint the reference's ``CheckpointManager``
  wrote (in the test process, with JAX) and of one the port's
  one-process ``train_loop`` wrote: each rank's shard is its slice of the
  single-process restore, ``full_tensor()`` gives the whole back, the
  optimizer state stays whole; on the 2 × 2 mesh ``shard`` redistributes
  an activation DTensor to its rules' placements.
"""
import datetime
import os
import signal
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import RunConfig, smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import sharding as tsh
from repro_torch.launch import train as ttrain
from repro_torch.optim import adafactor as tada
from repro_torch.optim import adamw as tadam
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim.tree import leaves

PG_TIMEOUT = datetime.timedelta(seconds=60)
JOIN_S = 180
BATCH = (4, 16)
STEP_CASES = {
    # optimizer: (smoke arch, dtype)
    "adamw": ("deepseek_7b", "bfloat16"),
    "adafactor": ("musicgen_medium", "float32"),
}


# ------------------------------------------------------------ the spawning

def _entry(rank, fn, n, tmp, device, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, "rdzv"),
        rank=rank, world_size=n, timeout=PG_TIMEOUT)
    try:
        out = fn(rank, n, device, *args)
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
        if bad:
            raise AssertionError(f"rank {rank} imported {sorted(bad)[:5]}")
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(fn, n: int, tmp_path, *args, device: str = "cpu") -> list:
    """``fn(rank, n, device, *args)`` on ``n`` gloo ranks; each rank's
    return value, in rank order."""
    ctx = mp.start_processes(_entry, args=(fn, n, str(tmp_path), device,
                                           args),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                pytest.fail(f"{n} ranks did not end within {JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(n)]


def _mesh(device: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device, shape, mesh_dim_names=names)


class _CountQdq:
    """Calls of kernels 7 and 8 (their wrappers) while active; on the
    card, the wrappers' own launch counts must agree."""

    def __init__(self, device: str):
        self.device, self.calls = device, {"group_quant": 0,
                                           "group_dequant": 0}

    def __enter__(self):
        self.orig = {k: getattr(ops, k) for k in self.calls}
        for k, fn in self.orig.items():
            def counted(*a, _k=k, _fn=fn, **kw):
                self.calls[_k] += 1
                return _fn(*a, **kw)
            setattr(ops, k, counted)
        ops.reset_launches()
        return self.calls

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(ops, k, fn)
        if exc[0] is None and self.device == "cuda":
            torch.cuda.synchronize()
            got = {k: ops.launches[k] for k in self.calls}
            assert got == self.calls, (got, self.calls)


# ------------------------------------------------------------ the exchange

def _exchange_inputs(n: int, seed: int, dtype, device: str):
    """Seeded ``(n, …)`` gradients (N(0, 1) · 1e-2, in ``dtype``) and
    float32 residuals (N(0, 1) · 1e-4): leaves off a multiple of 256
    values, a multiple, a single value, and one with all-zero groups."""
    rng = np.random.default_rng(seed)
    shapes = {"odd": (7, 37), "whole": (4, 128), "one": (1,),
              "zeros": (3, 300), "wide": (33, 250)}
    g, e = {}, {}
    for k, shape in shapes.items():
        a = (1e-2 * rng.standard_normal((n,) + shape)).astype(np.float32)
        if k == "zeros":
            a[:] = 0
            a[:, 1, 7] = -2.5
        g[k] = torch.from_numpy(a).to(device, dtype)
        e[k] = torch.from_numpy((1e-4 * rng.standard_normal((n,) + shape))
                                .astype(np.float32)).to(device)
        if k == "zeros":
            e[k].zero_()
    return g, e


def _exchange_rank(rank, n, device, seed):
    mesh = _mesh(device, (n, 1, 1), ("pod", "data", "model"))
    counts = {}
    for dtype in (torch.float32, torch.bfloat16):
        g, e = _exchange_inputs(n, seed, dtype, device)
        one_g = {k: v.clone() for k, v in g.items()}
        one_e = {k: v.clone() for k, v in e.items()}
        tgc.compress_pod_reduce(one_g, one_e, n_pods=n)
        mine_g = {k: v[rank:rank + 1].clone() for k, v in g.items()}
        mine_e = {k: v[rank:rank + 1].clone() for k, v in e.items()}
        with _CountQdq(device) as calls:
            out_g, out_e = tgc.compress_pod_reduce(mine_g, mine_e, mesh=mesh)
        assert out_g is mine_g and out_e is mine_e
        assert calls == {"group_quant": len(g), "group_dequant": len(g)}
        for k in g:
            assert mine_g[k].dtype == dtype and mine_g[k].shape[0] == 1
            assert torch.equal(mine_g[k][0], one_g[k][rank]), (dtype, k)
            assert torch.equal(mine_e[k][0], one_e[k][rank]), (dtype, k)
        assert any(float(v.abs().max()) > 0 for v in mine_e.values())
        counts[str(dtype)] = dict(calls)
    return counts


@pytest.mark.parametrize("n", [2, 3, 4])
def test_exchange_across_ranks_equals_one_process(tmp_path, n):
    """At 2, 3 and 4 ranks (3: where float32(1/3) is not exact), float32
    and bf16 gradients: every rank's mean and residual equal the
    one-process exchange's for its replica, bit for bit, with one launch
    of kernel 7 and one of kernel 8 a leaf."""
    out = _spawn(_exchange_rank, n, tmp_path, 40 + n)
    assert len(out) == n and all(o == out[0] for o in out)


def test_exchange_checks_the_mesh():
    """``compress_pod_reduce`` needs ``n_pods`` or a mesh, and a mesh
    that agrees with ``n_pods``; one pod leaves the trees as they are."""
    from repro_torch.launch.mesh import AbstractMesh

    g, e = _exchange_inputs(1, 3, torch.float32, "cpu")
    with pytest.raises(TypeError):
        tgc.compress_pod_reduce(g, e)
    with pytest.raises(ValueError):
        tgc.compress_pod_reduce(g, e, n_pods=2, mesh=AbstractMesh(
            (4, 1), ("pod", "data")))
    before = {k: v.clone() for k, v in g.items()}
    tgc.compress_pod_reduce(g, e, mesh=AbstractMesh((1, 2), ("data",
                                                            "model")))
    assert all(torch.equal(g[k], before[k]) for k in g)


# ------------------------------------------------------------ the step

def _step_setup(optimizer: str):
    arch, dtype = STEP_CASES[optimizer]
    from dataclasses import replace

    cfg = replace(smoke_config(arch), dtype=dtype)
    run = RunConfig(optimizer=optimizer, remat="none")
    opt = (tadam.AdamWConfig(lr=1e-2, warmup_steps=1)
           if optimizer == "adamw"
           else tada.AdafactorConfig(lr=1e-2, warmup_steps=1))
    return cfg, run, opt


def _global_batch(cfg, seed: int, device: str) -> dict:
    """A seeded global batch of ``BATCH``: int32 ``tokens`` or float32
    ``embeds``, and int32 labels whose last position is -1."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_mode == "tokens":
        out["tokens"] = rng.integers(0, cfg.vocab_size, BATCH).astype(
            np.int32)
    else:
        out["embeds"] = (rng.standard_normal(BATCH + (cfg.d_model,))
                         .astype(np.float32) * np.float32(0.02))
    labels = rng.integers(0, cfg.vocab_size, BATCH).astype(np.int32)
    labels[:, -1] = -1
    out["labels"] = labels
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def _step_rank(rank, n, device, optimizer):
    cfg, run, opt = _step_setup(optimizer)
    mesh = _mesh(device, (n, 1, 1), ("pod", "data", "model"))
    gen = lambda: torch.Generator(device=device).manual_seed(7)
    p1, o1, e1 = ttrain.init_replica_state(cfg, run, n, gen(), opt,
                                           device=device)
    step1, _ = ttrain.make_train_step_compressed(cfg, run, n, opt)
    p, o, e = ttrain.init_replica_state(cfg, run, None, gen(), opt,
                                        mesh=mesh, device=device)
    step, _ = ttrain.make_train_step_compressed(cfg, run, opt_cfg=opt,
                                                mesh=mesh)
    n_leaves = len(leaves(p))
    history = []
    for i in range(2):
        batch = _global_batch(cfg, 60 + i, device)
        m1 = step1(p1, o1, e1, batch)[3]
        with _CountQdq(device) as calls:
            m = step(p, o, e, batch)[3]
        assert calls == {"group_quant": n_leaves, "group_dequant": n_leaves}
        assert m.keys() == m1.keys()
        for k in m1:
            assert torch.equal(m[k], m1[k]), (i, k, m[k], m1[k])
        history.append({k: float(v) for k, v in m.items()})
    for name, mine, one in (("params", p, p1), ("opt", o, o1),
                            ("ef", e, e1)):
        one_of = dict(leaves(one))
        for path, leaf in leaves(mine):
            assert leaf.shape[0] == 1, (name, path)
            assert torch.equal(leaf[0], one_of[path][rank]), (name, path)
    assert any(float(v.abs().max()) > 0 for _, v in leaves(e))
    return history


@pytest.mark.parametrize("optimizer", list(STEP_CASES))
@pytest.mark.parametrize("n", [2, 4])
def test_compressed_step_across_ranks_equals_one_process(tmp_path, n,
                                                         optimizer):
    """Two steps of the compressed step, one replica a rank, equal the
    one-process step with ``n`` replicas bit for bit: each rank's
    parameters, optimizer state and error feedback are the oracle's
    replica, its metrics the oracle's; kernels 7 and 8 once a leaf a
    step on each rank."""
    out = _spawn(_step_rank, n, tmp_path, optimizer)
    assert all(h == out[0] for h in out)
    assert out[0][1]["loss"] != out[0][0]["loss"]


def test_compressed_step_checks_its_mesh():
    """``fsdp`` and a wide model axis raise, as does an ``n_pods`` that
    the mesh contradicts; a wide data axis builds (the pod's data ranks
    reduce their gradients before the exchange); the one-process form
    still needs at least one replica."""
    from repro_torch.launch.mesh import AbstractMesh

    cfg, run, opt = _step_setup("adamw")
    pods = AbstractMesh((2, 1, 1), ("pod", "data", "model"))
    with pytest.raises(ValueError):
        ttrain.make_train_step_compressed(cfg, RunConfig(fsdp=True), 2, opt)
    step, _ = ttrain.make_train_step_compressed(
        cfg, run, opt_cfg=opt,
        mesh=AbstractMesh((2, 2, 1), ("pod", "data", "model")))
    assert callable(step)
    with pytest.raises(ValueError):
        ttrain.make_train_step_compressed(
            cfg, run, opt_cfg=opt,
            mesh=AbstractMesh((1, 1, 2), ("pod", "data", "model")))
    with pytest.raises(ValueError):
        ttrain.make_train_step_compressed(cfg, run, 4, opt, mesh=pods)
    with pytest.raises(ValueError):
        ttrain.make_train_step_compressed(cfg, run, 0, opt)


# ------------------------------------------------------------ the restore

RESTORE_ARCH = "deepseek_7b"


def _write_reference_checkpoint(d: str) -> None:
    """The reference's ``CheckpointManager`` saves its smoke model (bf16)
    and AdamW state at step 4."""
    import jax

    from repro.checkpoint.manager import CheckpointManager as RCkpt
    from repro.configs import smoke_config as r_smoke
    from repro.models import model as rmodel
    from repro.models.layers import init_from_specs
    from repro.optim.adamw import AdamWConfig, adamw_init

    params = init_from_specs(rmodel.model_specs(r_smoke(RESTORE_ARCH)),
                             jax.random.PRNGKey(3))
    RCkpt(d).save(4, params, adamw_init(params, AdamWConfig()),
                  blocking=True)


def _write_port_checkpoint(d: str) -> None:
    """The port's one-process ``train_loop`` writes its step-2 state."""
    from repro_torch.data import lm_batches

    cfg = smoke_config(RESTORE_ARCH)
    shape = SimpleNamespace(global_batch=2, seq_len=16)
    handler = signal.getsignal(signal.SIGTERM)
    try:
        ttrain.train_loop(cfg, RunConfig(remat="none"),
                          lm_batches(cfg, shape, seed=3, device="cpu"),
                          steps=2, checkpoint_dir=d, checkpoint_every=2,
                          generator=torch.Generator().manual_seed(5),
                          device="cpu")
    finally:
        signal.signal(signal.SIGTERM, handler)


def _restore_rank(rank, n, device, mesh_shape, dirs):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import layers as tlayers
    from repro_torch.models import model as tmodel

    names = ("data", "model")[:len(mesh_shape)]
    mesh = _mesh(device, mesh_shape, names)
    coord = mesh.get_coordinate()
    cfg = smoke_config(RESTORE_ARCH)
    rules = tsh.rules_for(mesh, RunConfig(fsdp=True))
    shardings = tsh.param_shardings(tmodel.model_specs(cfg), mesh, rules)
    pl_of = dict(leaves(shardings))
    report = {}
    for label, d in dirs.items():
        mgr = CheckpointManager(d, device=device)
        p, o, s = mgr.restore_latest(mesh=mesh, shardings=shardings)
        p1, o1, s1 = mgr.restore_latest()
        assert s == s1
        local = full = n_sharded = 0
        p_of = dict(leaves(p))
        for path, whole in leaves(p1):
            dt = p_of[path]
            assert isinstance(dt, DTensor), (label, path)
            assert dt.placements == pl_of[path] and dt.shape == whole.shape
            want = tsh.local_slice(whole, mesh, pl_of[path], coord)
            assert torch.equal(dt.to_local(), want), (label, path)
            assert torch.equal(dt.full_tensor(), whole), (label, path)
            n_sharded += any(isinstance(q, Shard) for q in dt.placements)
            local += dt.to_local().numel() * whole.element_size()
            full += whole.numel() * whole.element_size()
        assert n_sharded > 0, label
        o_of = dict(leaves(o1))
        for path, leaf in leaves(o):
            assert not isinstance(leaf, DTensor)
            assert torch.equal(leaf, o_of[path]), (label, path)
        report[label] = {"step": s, "local_bytes": local, "full_bytes": full}
    if "model" in names:
        # an activation, replicated, constrained to its rules' placements
        x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
        dx = DTensor.from_local(x, mesh, (Replicate(),) * 2,
                                run_check=False)
        with tlayers.mesh_context(mesh, rules):
            out = tlayers.shard(dx, "batch", None, "vocab")
        assert out.placements == (Shard(0), Shard(2))
        assert torch.equal(out.to_local(), tsh.local_slice(
            x, mesh, out.placements, coord))
    return report


@pytest.mark.parametrize("mesh_shape", [(2,), (2, 2)])
def test_elastic_restore_gives_each_rank_its_slice(tmp_path, mesh_shape):
    """A reference-written and a port-written checkpoint restored onto
    ``(data=2)`` and ``(data=2, model=2)`` with ``fsdp=True``: each
    rank's shard of each parameter is its slice of the single-process
    restore, the optimizer state stays whole; the ranks together hold
    each shard once."""
    dirs = {"reference": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    _write_reference_checkpoint(dirs["reference"])
    _write_port_checkpoint(dirs["port"])
    n = int(np.prod(mesh_shape))
    out = _spawn(_restore_rank, n, tmp_path, mesh_shape, dirs)
    for label in dirs:
        full = out[0][label]["full_bytes"]
        assert all(o[label]["full_bytes"] == full for o in out)
        assert sum(o[label]["local_bytes"] for o in out) < n * full
    assert out[0]["reference"]["step"] == 4 and out[0]["port"]["step"] == 2


# ------------------------------------------------------------ the card

@pytest.mark.cuda
def test_exchange_across_ranks_on_card(tmp_path):
    """Two gloo ranks on ``cuda:0``: the exchange across ranks equals the
    one-process exchange on the card bit for bit, kernels 7 and 8 each
    launched once a leaf on each rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import build

    build.build_all()          # the ranks load the built kernels only
    out = _spawn(_exchange_rank, 2, tmp_path, 71, device="cuda")
    assert out[0] == out[1]
