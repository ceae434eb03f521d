"""The resilient train loop on a mesh (``train_loop(mesh=)``), the save of
sharded state, and the ``train_lm`` entry point, on the CPU.

Two gloo ranks (``test_torch_mesh_ranks._spawn``: spawned, a ``file://``
rendezvous, one intra-op thread a rank; no rank imports ``jax`` or
``repro``) run every ``(data=2)`` case in one spawn, with ``fsdp`` off
and on; the one-rank ``(1, 1)`` smoke mesh runs in the test process.
The setup is ``test_torch_data_parallel``'s float32 smoke loop:
deepseek-7b smoke in float32, ``RunConfig(microbatches=1)``,
``AdamWConfig(lr=1e-3)``, the ``ShapeConfig("t", "train", seq_len=32,
global_batch=4)`` token stream from seed 0.

* **The save.** A two-rank ``save`` writes the file a one-process
  manager writes for the ranks' state gathered whole, byte for byte
  (npz and json; lossless, and lossy at ``eb_rel = 1e-3`` with the byte
  codec pinned to zlib, as ``test_torch_checkpoint.py`` pins it; the zip
  members' clock pinned, since ``np.savez`` stamps each member with the
  current time at a two-second grain); the other rank writes and
  encodes nothing.  The reference's ``CheckpointManager.restore`` (in a
  JAX child process: this file run as a script) reads those files to the
  same arrays bit for bit.
* **The restore.** Each rank's parameter and optimizer shards are its
  ``local_slice`` of the file's leaves, bit for bit, placed by
  ``param_shardings`` / ``opt_shardings``; the step counter on the host.
* **Resume and failure** (the counterparts of the reference's red
  ``test_checkpoint_roundtrip_and_resume`` and
  ``test_failure_injection_and_restart_recovery``): a resumed run starts
  at its checkpoint; a failure raised from the stream on every rank at
  step 3, with blocking saves, leaves the latest file at step 3; the run
  resumed from it ends bit-equal to the uninterrupted run.
* **Preemption on one rank.** ``SIGTERM`` to rank 1's own process while
  step 1's batch is drawn stops both ranks after step 1 with step 2
  saved, in a spawn whose join timeout lies far below the group's.
* **Elastic.** A ``(data=2)`` file resumes in one process and on
  ``(1, 1)``, a one-process file on ``(data=2)``: the next step's loss is
  the run's that never changed mesh, within 1e-6 (relative).
* **Against one process.** The ``(data=2)`` loop's losses stay within
  1e-4 of the one-process loop's over 4 steps (which ``test_torch_train_
  loop.py`` holds to the reference's composition).
* ``ShapeConfig`` is the reference's, and ``python -m
  repro_torch.launch.train_lm`` runs and resumes on the CPU.
"""
import contextlib
import functools
import itertools
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import zipfile
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import RunConfig, ShapeConfig, smoke_config
from repro_torch.data import lm_batches
from repro_torch.io import tensor as ttensor
from repro_torch.launch import sharding as tsh
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.tree import leaves, local
from repro_torch.runtime import FailureInjector, SimulatedFailure
from test_torch_mesh_ranks import PG_TIMEOUT, _entry, _mesh, _spawn

HERE = os.path.dirname(os.path.abspath(__file__))
ARCH = "deepseek_7b"
SHAPE = ShapeConfig("t", "train", seq_len=32, global_batch=4)
LR = 1e-3
FSDP = (False, True)
#: the one-process and uninterrupted runs' length; the periodic save's
#: interval (the reference's test_checkpoint_roundtrip_and_resume)
STEPS, EVERY = 6, 5
FAIL_AT = 3
EB_REL = 1e-3
#: the zip members' pinned clock (seconds since the epoch)
ZIP_CLOCK = 1_700_000_000.0
TOL_ELASTIC, TOL_ONE_PROCESS, ONE_PROCESS_STEPS = 1e-6, 1e-4, 4
#: the preemption spawn must end well within the group's timeout
PREEMPT_JOIN_S = PG_TIMEOUT.total_seconds() / 2
WHERE = ["smoke", "data2-fsdp0", "data2-fsdp1"]


def _cfg():
    return replace(smoke_config(ARCH), dtype="float32")


def _run(fsdp: bool) -> RunConfig:
    return RunConfig(microbatches=1, fsdp=fsdp)


def _stream(start: int = 0, device: str = "cpu"):
    """The stream from batch ``start`` (a resumed run takes its next batch
    from where the iterator stands)."""
    return itertools.islice(lm_batches(_cfg(), SHAPE, seed=0, device=device),
                            start, None)


def _loop(steps, data, ckpt=None, *, mesh=None, fsdp=False, device="cpu",
          **kw):
    return ttrain.train_loop(
        _cfg(), _run(fsdp), data, steps=steps, opt_cfg=AdamWConfig(lr=LR),
        checkpoint_dir=ckpt, generator=torch.Generator(
            device=device).manual_seed(0), mesh=mesh, device=device, **kw)


def _failing(stream, at: int):
    """``stream`` raising ``SimulatedFailure`` when batch ``at`` is drawn."""
    inj = FailureInjector(fail_at_step=at)
    for i, batch in enumerate(stream):
        inj.check(i)
        yield batch


def _preempting(stream, at: int):
    """``stream`` that sends ``SIGTERM`` to its own process when batch
    ``at`` is drawn."""
    for i, batch in enumerate(stream):
        if i == at:
            os.kill(os.getpid(), signal.SIGTERM)
        yield batch


def _pin_zip_clock() -> None:
    zipfile.time = SimpleNamespace(time=lambda: ZIP_CLOCK,
                                   localtime=time.localtime)


def _whole(tree) -> dict:
    """A tree's leaves whole (a collective on a mesh), as plain tensors."""
    return ttrain._gather_params(tree, dist.group.WORLD)


def _state(params, opt) -> dict:
    return {"params": _whole(params), "opt": _whole(opt)}


def _files(directory: str, step: int) -> dict:
    out = {}
    for ext in ("npz", "json"):
        with open(os.path.join(directory, f"step_{step:08d}.{ext}"),
                  "rb") as f:
            out[ext] = f.read()
    return out


def _flat(tree) -> dict:
    return {"/".join(p): t for p, t in leaves(tree)}


def _equal(a: dict, b: dict) -> bool:
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]) for k in fa)


class _Calls:
    """Counts, while active, calls of ``CheckpointManager._write`` and of
    the tensor codec's encoder (on this rank)."""

    def __enter__(self):
        from repro_torch.checkpoint import manager

        self.n = {"write": 0, "encode": 0}
        self.orig = (CheckpointManager._write, manager.tacz_tensor)
        write, codec = self.orig

        def counted_write(mgr, *a, **kw):
            self.n["write"] += 1
            return write(mgr, *a, **kw)

        def counted_encode(*a, **kw):
            self.n["encode"] += 1
            return codec.encode_tensor(*a, **kw)
        CheckpointManager._write = counted_write
        manager.tacz_tensor = SimpleNamespace(
            encode_tensor=counted_encode, decode_tensor=codec.decode_tensor)
        return self.n

    def __exit__(self, *exc):
        from repro_torch.checkpoint import manager

        CheckpointManager._write, manager.tacz_tensor = self.orig


@contextlib.contextmanager
def _blocking_saves():
    orig = CheckpointManager.save
    CheckpointManager.save = functools.partialmethod(orig, blocking=True)
    try:
        yield
    finally:
        CheckpointManager.save = orig


# ------------------------------------------------------------ the cases

def _placement_check(mesh, device, fsdp, ckpt, step, params, opt) -> dict:
    """Each of this rank's shards against its ``local_slice`` of the
    file's leaf: ``{"bad": [paths], "step_on_host": bool, "checked": n}``."""
    cfg, run = _cfg(), _run(fsdp)
    specs = tmodel.model_specs(cfg)
    rules = tsh.rules_for(mesh, run)
    psh = tsh.param_shardings(specs, mesh, rules)
    osh = tsh.opt_shardings(AdamWConfig(lr=LR), specs, psh, mesh, rules)
    fp, fo, _ = CheckpointManager(ckpt, device=device).restore(step)
    coord = mesh.get_coordinate()
    bad, n = [], 0
    for tree, file_tree, pls in ((params, fp, psh),
                                 ({k: v for k, v in opt.items()
                                   if k != "step"},
                                  {k: v for k, v in fo.items()
                                   if k != "step"}, osh)):
        pl_of, f_of = dict(leaves(pls)), dict(leaves(file_tree))
        for path, t in leaves(tree):
            want = tsh.local_slice(f_of[path], mesh, pl_of[path], coord)
            ok = (t.placements == pl_of[path]
                  and torch.equal(local(t), want))
            bad += [] if ok else ["/".join(path)]
            n += 1
    counter = opt["step"]
    return {"bad": bad, "checked": n, "step_equal": torch.equal(
        counter, fo["step"]), "step_on_host": (
            not hasattr(counter, "placements")
            and counter.device.type == "cpu" and counter.dim() == 0)}


def _mesh_cases(mesh, device: str, fsdp: bool, root: str,
                one_dir: str) -> dict:
    """Every loop case on ``mesh`` with ``fsdp``, under ``root``: the
    readings the tests hold (the same calls on every rank, in order)."""
    os.makedirs(root, exist_ok=True)
    out = {}
    kw = {"mesh": mesh, "fsdp": fsdp, "device": device}

    # the uninterrupted run; its state saved whole, lossless and lossy
    out["dir"] = d_a = os.path.join(root, "a")
    p, o, h = _loop(STEPS, _stream(), d_a, checkpoint_every=EVERY,
                    log_every=1, **kw)
    out["history"] = h
    out["final"] = _state(p, o)
    out["saves"] = {}
    for eb in (0.0, EB_REL):
        d = os.path.join(root, f"save_{eb}")
        with _Calls() as calls:
            CheckpointManager(d, device=device, lossy_eb_rel=eb).save(
                STEPS, p, o, blocking=True)
        out["saves"][eb] = {"dir": d, "calls": dict(calls),
                            "files": sorted(os.listdir(d))}
    del p, o

    # the restore onto the mesh: no step left to take
    p, o, h = _loop(EVERY, iter(()), d_a, **kw)
    out["restore"] = _placement_check(mesh, device, fsdp, d_a, EVERY, p, o)
    out["restore_history"] = h
    del p, o

    # resume from the step-5 checkpoint (log every second step)
    _, o, h = _loop(8, _stream(EVERY), d_a, checkpoint_every=EVERY,
                    log_every=2, **kw)
    out["resumed"] = {"history": h, "opt_step": int(o["step"]),
                      "steps": CheckpointManager(d_a, device=device)
                      .list_steps()}

    # a failure on every rank at step 3, blocking saves each step; then
    # the run resumed from the latest file
    d_f = os.path.join(root, "f")
    with _blocking_saves():
        try:
            _loop(STEPS, _failing(_stream(), FAIL_AT), d_f,
                  checkpoint_every=1, log_every=1, **kw)
            out["failure"] = None
        except SimulatedFailure as e:
            out["failure"] = str(e)
        mgr = CheckpointManager(d_f, device=device)
        latest = mgr.restore_latest()
        out["failed_steps"] = mgr.list_steps()
        out["failed_latest"] = None if latest is None else latest[2]
        p, o, h = _loop(STEPS, _stream(FAIL_AT), d_f, checkpoint_every=1,
                        log_every=1, **kw)
    out["after_failure"] = {"history": h, "state": _state(p, o)}
    del p, o

    # the one-process file resumed on the mesh: the next step's loss
    _, _, h = _loop(STEPS, _stream(EVERY), one_dir, checkpoint_every=100,
                    log_every=1, **kw)
    out["from_one_process"] = h
    return out


def _data2_rank(rank, n, device, root, one_dir):
    _pin_zip_clock()
    ttensor.HAVE_ZSTD = False
    mesh = _mesh(device, (n, 1), ("data", "model"))
    return {fsdp: _mesh_cases(mesh, device, fsdp,
                              os.path.join(root, f"fsdp{int(fsdp)}"), one_dir)
            for fsdp in FSDP}


def _preempt_rank(rank, n, device, root):
    """The preemption loop on ``(data=2)``, fsdp off and on: rank 1's
    stream sends ``SIGTERM`` to its own process as batch 1 is drawn."""
    from repro_torch.runtime import PreemptionGuard

    mesh = _mesh(device, (n, 1), ("data", "model"))
    out = {"main_thread": threading.current_thread()
           is threading.main_thread()}
    for fsdp in FSDP:
        d = os.path.join(root, f"preempt{int(fsdp)}")
        prev = signal.getsignal(signal.SIGTERM)
        stream = _preempting(_stream(), 1) if rank == 1 else _stream()
        _, o, h = _loop(10, stream, d, checkpoint_every=100, log_every=1,
                        mesh=mesh, fsdp=fsdp, device=device)
        handler = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, prev)
        out[fsdp] = {
            "history": [s for s, _ in h], "opt_step": int(o["step"]),
            "steps": CheckpointManager(d, device=device).list_steps(),
            "guard_installed": isinstance(getattr(handler, "__self__", None),
                                          PreemptionGuard)}
    return out


def _spawn_within(fn, n: int, tmp_path, join_s: float, *args) -> list:
    """``_spawn`` with a join timeout of ``join_s`` seconds."""
    ctx = mp.start_processes(_entry, args=(fn, n, str(tmp_path), "cpu",
                                           args),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + join_s
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"{n} ranks did not end within {join_s} s: a "
                            f"rank hangs in a collective")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(n)]


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The one-process loop: ``STEPS`` steps, saving at step ``EVERY``;
    its history, final state and directory."""
    d = str(tmp_path_factory.mktemp("one") / "ckpt")
    prev = signal.getsignal(signal.SIGTERM)
    try:
        p, o, h = _loop(STEPS, _stream(), d, checkpoint_every=EVERY,
                        log_every=1)
    finally:
        signal.signal(signal.SIGTERM, prev)
    return {"dir": d, "history": h, "params": p, "opt": o}


@pytest.fixture(scope="module")
def data2(tmp_path_factory, one_process):
    """Every rank's readings on ``(data=2)``, from one spawn:
    ``[rank0, rank1]``, each ``{fsdp: readings}``."""
    tmp = tmp_path_factory.mktemp("data2")
    return _spawn(_data2_rank, 2, tmp, str(tmp / "cases"),
                  one_process["dir"])


@pytest.fixture(scope="module")
def preempted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("preempt")
    return _spawn_within(_preempt_rank, 2, tmp, PREEMPT_JOIN_S, str(tmp))


@pytest.fixture(autouse=True)
def restore_sigterm():
    """The loop's ``PreemptionGuard`` leaves its ``SIGTERM`` handler:
    put the previous one back."""
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


@pytest.fixture
def smoke_mesh():
    """The one-rank ``(1, 1)`` smoke mesh of the test process."""
    from repro_torch.launch.mesh import make_smoke_mesh

    assert not dist.is_initialized()
    try:
        yield make_smoke_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture
def pinned(monkeypatch):
    """The zip clock pinned and the tensor codec's byte pass on zlib."""
    monkeypatch.setattr(zipfile, "time", SimpleNamespace(
        time=lambda: ZIP_CLOCK, localtime=time.localtime))
    monkeypatch.setattr(ttensor, "HAVE_ZSTD", False)


@pytest.fixture(scope="module")
def smoke(tmp_path_factory, one_process):
    """The smoke mesh's readings (fsdp on), run once in the test process
    with the zip clock and the byte codec pinned."""
    from repro_torch.launch.mesh import make_smoke_mesh

    assert not dist.is_initialized()
    prev = (zipfile.time, ttensor.HAVE_ZSTD, signal.getsignal(signal.SIGTERM))
    _pin_zip_clock()
    ttensor.HAVE_ZSTD = False
    try:
        mesh = make_smoke_mesh(device="cpu")
        return _mesh_cases(mesh, "cpu", True,
                           str(tmp_path_factory.mktemp("smoke")),
                           one_process["dir"])
    finally:
        dist.destroy_process_group()
        zipfile.time, ttensor.HAVE_ZSTD = prev[:2]
        signal.signal(signal.SIGTERM, prev[2])


def _readings(request, where: str) -> list:
    """Each rank's readings: the ``(data=2)`` spawn's at one fsdp, or the
    smoke mesh's."""
    if where == "smoke":
        return [request.getfixturevalue("smoke")]
    fsdp = where.endswith("1")
    return [r[fsdp] for r in request.getfixturevalue("data2")]


# ------------------------------------------------------------ the save

def _one_process_files(state: dict, tmp_path, eb: float) -> dict:
    d = str(tmp_path / f"one_{eb}")
    CheckpointManager(d, device="cpu", lossy_eb_rel=eb).save(
        STEPS, state["params"], state["opt"], blocking=True)
    return _files(d, STEPS)


@pytest.mark.parametrize("eb", [0.0, EB_REL], ids=["lossless", "lossy"])
@pytest.mark.parametrize("where", WHERE)
def test_mesh_save_equals_one_process_save(request, tmp_path, pinned,
                                           where, eb):
    """The mesh's save of its state is, byte for byte, the one-process
    save of that state gathered whole; rank 0 alone writes and encodes."""
    outs = _readings(request, where)
    r0 = outs[0]
    for o in outs[1:]:
        assert _equal(o["final"], r0["final"])
    save = r0["saves"][eb]
    assert save["files"] == [f"step_{STEPS:08d}.json",
                             f"step_{STEPS:08d}.npz"]
    assert _files(save["dir"], STEPS) == _one_process_files(
        r0["final"], tmp_path, eb)
    lossy = sum(t.dim() >= 2 and t.numel() > 4096
                for _, t in leaves(r0["final"]["params"]))
    assert lossy > 0
    assert save["calls"] == {"write": 1, "encode": lossy if eb else 0}, save
    for o in outs[1:]:
        assert o["saves"][eb]["calls"] == {"write": 0, "encode": 0}


def _reference_restore(out: str, pairs: list) -> None:
    """The reference's restore of each ``(directory, step)``, flattened
    into ``out`` under ``"<i>/<path>"``."""
    from repro.checkpoint.manager import CheckpointManager as RManager

    res = {}
    for i, (d, step) in enumerate(pairs):
        p, o, s = RManager(d).restore(int(step))
        res[f"{i}/step"] = np.asarray(s)
        for name, tree in (("params", p), ("opt", o)):
            stack = [(name, tree)]
            while stack:
                path, node = stack.pop()
                if isinstance(node, dict):
                    stack += [(f"{path}/{k}", v) for k, v in node.items()]
                else:
                    res[f"{i}/{path}"] = np.asarray(node)
    np.savez(out, **res)


@pytest.fixture(scope="module")
def reference_restores(tmp_path_factory, data2):
    """The reference's restore of the four ``(data=2)`` files, in one JAX
    child process: ``{(fsdp, eb): {path: array}}``."""
    keys = [(f, eb) for f in FSDP for eb in (0.0, EB_REL)]
    out = str(tmp_path_factory.mktemp("reference") / "restored.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(os.path.join(HERE, "..", "src"))]
        + [p for p in [env.get("PYTHONPATH")] if p])
    args = [f"{data2[0][f]['saves'][eb]['dir']}:{STEPS}" for f, eb in keys]
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), out]
                          + args, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = {k: {} for k in keys}
    with np.load(out) as z:
        for name in z.files:
            i, path = name.split("/", 1)
            got[keys[int(i)]][path] = z[name]
    return got


@pytest.mark.parametrize("eb", [0.0, EB_REL], ids=["lossless", "lossy"])
@pytest.mark.parametrize("fsdp", FSDP, ids=["fsdp0", "fsdp1"])
def test_reference_restores_mesh_file(data2, reference_restores, fsdp, eb):
    """The reference restores the two-rank file to the port's own restore
    of it bit for bit, and (lossless) to the ranks' state."""
    save = data2[0][fsdp]["saves"][eb]
    p, o, s = CheckpointManager(save["dir"], device="cpu").restore(STEPS)
    ref = reference_restores[fsdp, eb]
    assert int(ref.pop("step")) == s == STEPS
    port = {f"params/{k}": v for k, v in _flat(p).items()}
    port.update({f"opt/{k}": v for k, v in _flat(o).items()})
    assert ref.keys() == port.keys()
    for k, t in port.items():
        np.testing.assert_array_equal(ref[k], t.numpy(), err_msg=k)
        assert ref[k].dtype == t.numpy().dtype, k
    if not eb:
        final = data2[0][fsdp]["final"]
        assert _equal({"params": p, "opt": o}, final)


# ------------------------------------------------------------ the restore

@pytest.mark.parametrize("where", WHERE)
def test_restore_places_rank_slices(request, where):
    """``train_loop(mesh=)`` resumed with no step left: every parameter
    and moment shard is the rank's slice of the file's leaf with the
    sharding rules' placements; the step counter stays on the host."""
    for o in _readings(request, where):
        r = o["restore"]
        assert not r["bad"] and r["checked"] > 0, r
        assert r["step_on_host"] and r["step_equal"], r
        assert o["restore_history"] == []


# ------------------------------------------------------------ resume, failure

@pytest.mark.parametrize("where", WHERE)
def test_resume_at_saved_step(request, where):
    """``_loop(6)`` then ``_loop(8)``: the second run starts at the step-5
    checkpoint and logs every second step and the last."""
    for o in _readings(request, where):
        r = o["resumed"]
        assert [s for s, _ in r["history"]] == [6, 7], r
        assert r["opt_step"] == 8 and r["steps"] == [EVERY], r


@pytest.mark.parametrize("where", WHERE)
def test_failure_leaves_latest_at_step(request, where):
    """A failure raised from the stream on every rank at step 3 (blocking
    saves each step): the latest checkpoint is step 3."""
    for o in _readings(request, where):
        assert "step 3" in o["failure"], o["failure"]
        assert o["failed_latest"] == FAIL_AT
        assert o["failed_steps"] == [1, 2, 3]


@pytest.mark.parametrize("where", WHERE)
def test_resume_after_failure_is_bit_equal(request, where):
    """The run resumed from the failure's step-3 file (its stream advanced
    to batch 3) ends with the uninterrupted run's parameters and optimizer
    state, bit for bit, and its losses."""
    for o in _readings(request, where):
        a = o["after_failure"]
        assert _equal(a["state"], o["final"])
        assert a["history"] == o["history"][FAIL_AT:]


# ------------------------------------------------------------ preemption

@pytest.mark.parametrize("fsdp", FSDP, ids=["fsdp0", "fsdp1"])
def test_preemption_on_one_rank_stops_both(preempted, fsdp):
    """``SIGTERM`` to rank 1 alone as batch 1 is drawn: both ranks finish
    step 1, save step 2 and stop; each rank's guard handles the signal in
    its main thread."""
    for r in preempted:
        assert r["main_thread"]
        got = r[fsdp]
        assert got["guard_installed"], got
        assert got["history"] == [0, 1] and got["opt_step"] == 2, got
        assert got["steps"] == [2], got


def test_preemption_on_smoke_mesh(smoke_mesh, tmp_path):
    """The one-rank ``(1, 1)`` mesh: a ``SIGTERM`` as batch 1 is drawn
    saves step 2 and stops."""
    d = str(tmp_path)
    _, o, h = _loop(10, _preempting(_stream(), 1), d, checkpoint_every=100,
                    log_every=1, mesh=smoke_mesh, fsdp=True)
    assert [s for s, _ in h] == [0, 1] and int(o["step"]) == 2
    assert CheckpointManager(d, device="cpu").list_steps() == [2]


# ------------------------------------------------------------ elastic

def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("fsdp", FSDP, ids=["fsdp0", "fsdp1"])
def test_elastic_one_process_file_on_data2(data2, one_process, fsdp):
    """A one-process file resumes on ``(data=2)``: step 5's loss is the
    one-process run's."""
    want = dict(one_process["history"])[EVERY]
    for r in data2:
        (step, loss), = r[fsdp]["from_one_process"]
        assert step == EVERY
        assert _rel(loss, want) <= TOL_ELASTIC, (loss, want)


@pytest.mark.parametrize("to", ["one_process", "smoke"])
@pytest.mark.parametrize("fsdp", FSDP, ids=["fsdp0", "fsdp1"])
def test_elastic_data2_file_elsewhere(request, data2, tmp_path, fsdp, to):
    """A ``(data=2)`` file resumes in one process and on the ``(1, 1)``
    mesh: step 5's loss is the ``(data=2)`` run's."""
    d = str(tmp_path / "ckpt")
    shutil.copytree(data2[0][fsdp]["dir"], d)
    mesh = request.getfixturevalue("smoke_mesh") if to == "smoke" else None
    _, _, h = _loop(STEPS, _stream(EVERY), d, checkpoint_every=100,
                    log_every=1, mesh=mesh, fsdp=fsdp)
    (step, loss), = h
    want = dict(data2[0][fsdp]["history"])[EVERY]
    assert step == EVERY and _rel(loss, want) <= TOL_ELASTIC, (loss, want)


# ------------------------------------------------------------ one process

@pytest.mark.parametrize("fsdp", FSDP, ids=["fsdp0", "fsdp1"])
def test_data2_loop_tracks_one_process(data2, one_process, fsdp):
    """Every logged loss of the ``(data=2)`` loop over 4 steps within 1e-4
    of the one-process loop's, the same on both ranks; the largest
    parameter difference after 6 steps is printed, not gated (Adam near
    ``eps``, ROADMAP queue 3)."""
    want = one_process["history"]
    h0 = data2[0][fsdp]["history"]
    assert all(r[fsdp]["history"] == h0 for r in data2)
    assert [s for s, _ in h0] == [s for s, _ in want] == list(range(STEPS))
    errs = [_rel(g, w) for (_, g), (_, w) in zip(h0, want)]
    p_err = max(float((t - _flat(one_process["params"])[k]).abs().max())
                for k, t in _flat(data2[0][fsdp]["final"]["params"]).items())
    print(f"fsdp={fsdp}: loss errors {errs}; largest parameter difference "
          f"after {STEPS} steps {p_err}")
    assert max(errs[:ONE_PROCESS_STEPS]) <= TOL_ONE_PROCESS, errs


# ------------------------------------------------------------ unsupported

@pytest.mark.parametrize("case", ["model2", "adafactor_fsdp"])
def test_unsupported_mesh_raises_before_reading(tmp_path, monkeypatch, case):
    """A ``model`` axis of 2 (ROADMAP item 2.6b-4), with AdamW or with
    Adafactor under fsdp (which runs on a data-parallel mesh), raises the
    step's ``ValueError`` before any checkpoint is read or any state is
    made."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.optim.adafactor import AdafactorConfig

    def never(*a, **kw):
        raise AssertionError("read or initialized before the mesh check")
    monkeypatch.setattr(CheckpointManager, "restore_latest", never)
    monkeypatch.setattr(ttrain, "init_train_state", never)
    if case == "model2":
        mesh, run, opt, match = (AbstractMesh((1, 2), ("data", "model")),
                                 _run(True), AdamWConfig(lr=LR), "2.6b-4")
    else:
        mesh, run, opt, match = (AbstractMesh((2, 2), ("data", "model")),
                                 RunConfig(optimizer="adafactor", fsdp=True),
                                 AdafactorConfig(lr=LR), "2.6b-4")
    with pytest.raises(ValueError, match=match):
        ttrain.train_loop(_cfg(), run, _stream(), steps=2, opt_cfg=opt,
                          checkpoint_dir=str(tmp_path), mesh=mesh,
                          device="cpu")


# ------------------------------------------------------------ configs, entry

def test_shape_config_matches_reference():
    """The port's ``ShapeConfig`` is the reference's frozen dataclass,
    field for field, and the streams take it."""
    import dataclasses

    from repro.configs import ShapeConfig as RShape

    assert ([(f.name, f.type, f.default) for f in dataclasses.fields(
        ShapeConfig)] == [(f.name, f.type, f.default)
                          for f in dataclasses.fields(RShape)])
    assert ShapeConfig.__dataclass_params__.frozen
    assert RShape.__dataclass_params__.frozen
    assert dataclasses.asdict(SHAPE) == dataclasses.asdict(
        RShape("t", "train", seq_len=32, global_batch=4))
    from repro_torch.configs import ShapeConfig as Exported

    assert Exported is ShapeConfig


def _train_lm(*args):
    from repro_torch.launch import train_lm

    return train_lm.main(["--device", "cpu", *args])


def test_train_lm_runs_and_resumes(tmp_path, capsys):
    """``train_lm.main`` on the CPU: its first logged loss is the
    one-process ``train_loop``'s on the same stream (within 1e-6); ten
    steps save step 10, and a run with ``--steps 12`` on the same
    directory resumes there.  (The example's save interval,
    ``max(steps // 4, 10)``, writes nothing in fewer than ten steps.)"""
    from repro_torch.launch.train_lm import PRESETS

    ckpt = str(tmp_path / "ckpt")
    base = ["--preset", "20m", "--batch", "2", "--seq", "16", "--ckpt", ckpt]
    h1 = _train_lm("--steps", "10", *base)
    report = capsys.readouterr().out
    assert "10 steps in" in report and "mesh of 1 rank(s), cpu" in report
    assert [s for s, _ in h1] == list(range(10))
    assert CheckpointManager(ckpt, device="cpu").list_steps() == [10]
    cfg = PRESETS["20m"]
    _, _, want = ttrain.train_loop(
        cfg, RunConfig(microbatches=2, remat="layer"),
        lm_batches(cfg, ShapeConfig("train", "train", seq_len=16,
                                    global_batch=2), seed=0, device="cpu"),
        steps=1, opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=5,
                                     total_steps=10), device="cpu")
    assert _rel(h1[0][1], want[0][1]) <= TOL_ELASTIC, (h1[0], want[0])
    h2 = _train_lm("--steps", "12", *base)
    assert [s for s, _ in h2] == [10, 11]
    assert "2 steps in" in capsys.readouterr().out
    assert not dist.is_initialized()


@pytest.mark.parametrize("flags", [["--arch", "deepseek_7b", "--smoke"],
                                   ["--amr-data"]],
                         ids=["arch_smoke", "amr_data"])
def test_train_lm_flags(tmp_path, flags):
    """``--arch … --smoke`` and ``--amr-data`` each run two steps."""
    h = _train_lm(*flags, "--steps", "2", "--batch", "2", "--seq", "16",
                  "--ckpt", str(tmp_path))
    assert [s for s, _ in h] == [0, 1]
    assert all(np.isfinite(loss) for _, loss in h)


# ------------------------------------------------------------ the card

def _card_rank(rank, n, device, root):
    _pin_zip_clock()
    mesh = _mesh(device, (n, 1), ("data", "model"))
    d = os.path.join(root, "card")
    p, o, h = _loop(3, _stream(device=device), d, checkpoint_every=2,
                    log_every=1, mesh=mesh, fsdp=True, device=device)
    out = {"history": h}
    mesh_dir, one_dir = os.path.join(root, "mesh"), os.path.join(root, "one")
    CheckpointManager(mesh_dir, device=device).save(3, p, o, blocking=True)
    state = _state(p, o)
    if rank == 0:
        CheckpointManager(one_dir, device=device).save(
            3, state["params"], state["opt"], blocking=True)
        out["files"] = [_files(mesh_dir, 3), _files(one_dir, 3)]
    del p, o, state
    # resumed from the step-2 file
    _, _, out["resumed"] = _loop(3, _stream(2, device), d,
                                 checkpoint_every=100, log_every=1,
                                 mesh=mesh, fsdp=True, device=device)
    return out


@pytest.mark.cuda
def test_train_loop_mesh_on_card(tmp_path):
    """Two gloo ranks on ``cuda:0`` (``data=2``, fsdp): the same history
    on both ranks, a resumed run's step equal to the uninterrupted one's,
    and the mesh's save byte for byte the one-process save of its state
    gathered whole."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = _spawn(_card_rank, 2, tmp_path, str(tmp_path), device="cuda")
    h = out[0]["history"]
    assert [s for s, _ in h] == [0, 1, 2]
    assert all(o["history"] == h for o in out)
    (step, loss), = out[0]["resumed"]
    assert step == 2 and _rel(loss, h[2][1]) <= TOL_ELASTIC, (loss, h[2])
    mesh_files, one_files = out[0]["files"]
    assert mesh_files == one_files


if __name__ == "__main__":
    _reference_restore(sys.argv[1], [a.rsplit(":", 1) for a in sys.argv[2:]])
