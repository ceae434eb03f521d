"""The port's resilient train loop (``repro_torch.launch.train.train_loop``)
and its runtime (``repro_torch.runtime``), on the CPU.

The reference's own loop tests (``test_loss_decreases``,
``test_checkpoint_roundtrip_and_resume``,
``test_failure_injection_and_restart_recovery``) are red on this tree:
its loop needs a mesh (ROADMAP.md, queue 3).  The loop is held instead

* to the reference's composition, step by step over four steps:
  each step's batch is the reference's ``lm_batches``, its loss and
  gradients are the reference's ``jax.value_and_grad(loss_fn)`` at the
  parameters the port's loop held before that step (``TOL["loss"]``,
  ``TOL["grads"]``; the reference runs in one child process, this file
  executed as a script), and its new parameters are the reference's
  ``adamw_update`` of the step's own gradients (``TOL["update"]``: Adam
  divides each gradient by its magnitude, so a gradient near ``eps``
  turns a float32 summation difference into a visible one, and the state
  is carried along the port's trajectory, as ``tests/test_torch_train.py``
  holds the single step);
* to itself: a run resumed after a ``SimulatedFailure`` ends bit-equal to
  an uninterrupted run, and a resumed run starts at its checkpoint.

Port twins of the reference's green ``test_preemption_checkpoint_and_stop``
and ``test_watchdog_flags_stragglers`` are here too.  Every test restores
the ``SIGTERM`` handler that the loop's ``PreemptionGuard`` installs.
"""
import importlib.util
import itertools
import os
import signal
import subprocess
import sys
import time
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import RunConfig, smoke_config
from repro_torch.data import lm_batches
from repro_torch.launch import train as ttrain
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import (FailureInjector, PreemptionGuard,
                                 SimulatedFailure, StepWatchdog)

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "make_card_reference",
    os.path.join(HERE, "card_reference", "make_card_reference.py"))
fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture)

ARCH = "deepseek_7b"
SHAPE = SimpleNamespace(global_batch=4, seq_len=32)
SEED = 5
STEPS = 4
LR = 1e-3


def _cfg(smoke):
    return replace(smoke(ARCH), dtype="float32")


def _opt():
    return AdamWConfig(lr=LR, warmup_steps=1)


@pytest.fixture(autouse=True)
def restore_sigterm():
    """The loop's ``PreemptionGuard`` installs a ``SIGTERM`` handler and,
    as the reference's, leaves it: put the previous one back."""
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def _loop(steps, data, ckpt_dir=None, **kw):
    return ttrain.train_loop(
        _cfg(smoke_config), RunConfig(), data, steps=steps, opt_cfg=_opt(),
        checkpoint_dir=ckpt_dir, generator=torch.Generator().manual_seed(0),
        device="cpu", **kw)


def _stream(start: int = 0):
    """The port's stream, advanced to batch ``start`` (the loop takes
    ``next`` from where the iterator stands, as the reference's does)."""
    return itertools.islice(lm_batches(_cfg(smoke_config), SHAPE, seed=SEED,
                                       device="cpu"), start, None)


# --------------------------------------------- the reference's composition

def _reference_outputs(inp: str, out: str) -> None:
    """The reference's batches, losses and gradients at the parameters the
    port held before each step (``inp``), saved to ``out``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import RunConfig as RRun
    from repro.configs import smoke_config as r_smoke
    from repro.data.pipeline import lm_batches as r_lm
    from repro.launch.train import loss_fn

    cfg = _cfg(r_smoke)
    stream = r_lm(cfg, SHAPE, seed=SEED)
    res = {}
    with np.load(inp) as z:
        for k in range(STEPS):
            batch = next(stream)
            res.update({f"{k}/batch/{n}": v for n, v in batch.items()})
            prefix = f"{k}/params/"
            params = fixture.nested({n[len(prefix):]: jnp.asarray(z[n])
                                     for n in z.files if n.startswith(prefix)})
            (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, {n: jnp.asarray(v) for n, v in batch.items()}, cfg,
                RRun())
            res[f"{k}/loss"] = np.asarray(loss, np.float32)
            res.update({f"{k}/grads/{p}": np.asarray(g, np.float32)
                        for p, g in fixture.flat(grads).items()})
    np.savez(out, **res)


def _run_reference(tmp_path, steps: list) -> dict:
    inp, out = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    np.savez(inp, **{f"{k}/params/{p}": v.numpy()
                     for k, s in enumerate(steps)
                     for p, v in fixture.flat(s["params"]).items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(os.path.join(HERE, "..", "src"))]
        + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), inp,
                           out], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _rel(want, got) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(want - np.asarray(got, np.float64)).max()
                 / (np.abs(want).max() + 1e-30))


def test_train_loop_matches_reference_composition(tmp_path, monkeypatch):
    """Four steps of ``train_loop`` (AdamW, float32 deepseek-7b smoke,
    the port's ``lm_batches``): each step's batch, loss and gradients are
    the reference's ``lm_batches`` and ``jax.value_and_grad(loss_fn)``
    at the step's parameters; each step's new parameters are the
    reference's ``adamw_update`` of the step's gradients, its moments
    carried from the port's gradients; ``history`` holds every step."""
    import jax.numpy as jnp

    from repro.optim import adamw as radam

    steps = []
    real = ttrain._microbatched_grads

    def record(params, batch, cfg, run, **kw):
        loss, metrics, grads = real(params, batch, cfg, run, **kw)
        steps.append({"params": _copy(params), "batch": dict(batch),
                      "loss": loss.clone(), "grads": _copy(grads)})
        return loss, metrics, grads

    monkeypatch.setattr(ttrain, "_microbatched_grads", record)
    params, opt, history = _loop(STEPS, _stream(), log_every=1)
    assert [s for s, _ in history] == list(range(STEPS))
    assert len(steps) == STEPS and int(opt["step"]) == STEPS
    ref = _run_reference(tmp_path, steps)
    as_r = lambda t: {k: as_r(v) if isinstance(v, dict)
                      else jnp.asarray(v.numpy()) for k, v in t.items()}
    ropt = radam.AdamWConfig(lr=LR, warmup_steps=1)
    rstate = None
    for k, s in enumerate(steps):
        for n, v in s["batch"].items():
            np.testing.assert_array_equal(v.numpy(), ref[f"{k}/batch/{n}"])
        assert history[k][1] == float(s["loss"])
        assert _rel(ref[f"{k}/loss"], s["loss"].numpy()) <= fixture.tol(
            "loss", "float32"), k
        for p, g in fixture.flat(s["grads"]).items():
            assert _rel(ref[f"{k}/grads/{p}"], g.numpy()) <= fixture.tol(
                "grads", "float32"), (k, p)
        rp = as_r(s["params"])
        rstate = rstate or radam.adamw_init(rp, ropt)
        rnew, rstate, _ = radam.adamw_update(rp, as_r(s["grads"]), rstate,
                                             ropt)
        new = steps[k + 1]["params"] if k + 1 < STEPS else params
        for p, w in fixture.flat(rnew).items():
            w = np.asarray(w)
            old = fixture.flat(s["params"])[p].numpy()
            got = fixture.flat(new)[p].numpy()
            limit = (fixture.TOL["update"]["float32"] * np.abs(w - old).max()
                     + np.spacing(np.abs(w)))
            assert (np.abs(got - w) <= limit).all(), (k, p)
    for name in ("mu", "nu"):
        for p, w in fixture.flat(rstate[name]).items():
            assert _rel(np.asarray(w), fixture.flat(opt[name])[p].numpy()
                        ) <= fixture.TOL["update"]["float32"], (name, p)


# ------------------------------------------------------------ resilience

def _wait_for(path: str, timeout: float = 60.0) -> None:
    """Until ``path`` exists: a non-blocking save's writer may still run
    when the loop raises."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        assert time.monotonic() - t0 < timeout, path
        time.sleep(0.01)


def _failing(stream, fail_at: int, ready: str):
    """``stream`` that raises ``SimulatedFailure`` when batch ``fail_at``
    is asked for, once ``ready`` (the checkpoint written before it) is on
    disk."""
    inj = FailureInjector(fail_at_step=fail_at)
    for i, batch in enumerate(stream):
        if i == fail_at:
            _wait_for(ready)
        inj.check(i)
        yield batch


def test_resume_after_failure_is_bit_equal(tmp_path):
    """A run that fails when step 4's batch is fetched (checkpoints every
    3 steps) and is resumed from its step-3 checkpoint, its stream
    advanced to batch 3, ends with the parameters and optimizer state of
    an uninterrupted 6-step run, bit for bit; the resumed history starts
    at step 3."""
    want_p, want_o, want_h = _loop(6, _stream(), str(tmp_path / "a"),
                                   checkpoint_every=3, log_every=1)
    d = str(tmp_path / "c")
    with pytest.raises(SimulatedFailure):
        _loop(6, _failing(_stream(), 4, os.path.join(
            d, "step_00000003.json")), d, checkpoint_every=3, log_every=1)
    assert CheckpointManager(d, device="cpu").list_steps() == [3]
    got_p, got_o, got_h = _loop(6, _stream(3), d, checkpoint_every=3,
                                log_every=1)
    assert got_h[0][0] == 3 and got_h == want_h[3:]
    for want, got in ((want_p, got_p), (want_o, got_o)):
        for path, t in fixture.flat(want).items():
            assert torch.equal(t, fixture.flat(got)[path]), path
    assert CheckpointManager(d, device="cpu").list_steps() == [3, 6]


def test_checkpoint_roundtrip_and_resume(tmp_path):
    """The reference's ``test_checkpoint_roundtrip_and_resume``: a fresh
    8-step loop resumes from the 6-step run's step-5 checkpoint; its
    history starts there and logs every second step and the last."""
    d = str(tmp_path)
    _, _, h1 = _loop(6, _stream(), d, checkpoint_every=5, log_every=2)
    assert [s for s, _ in h1] == [0, 2, 4, 5]
    assert CheckpointManager(d, device="cpu").list_steps() == [5]
    _, opt, h2 = _loop(8, _stream(5), d, checkpoint_every=5, log_every=2)
    assert h2[0][0] >= 5 and [s for s, _ in h2] == [6, 7]
    assert int(opt["step"]) == 8


def test_loss_decreases():
    """The reference's ``test_loss_decreases``: 20 steps of the loop on
    the stream lower the loss."""
    _, _, hist = _loop(20, _stream(), log_every=2)
    assert hist[-1][1] < hist[0][1]


def test_preemption_saves_and_stops(tmp_path):
    """A ``SIGTERM`` during step 2's batch: the loop finishes the step,
    saves step 3 and stops."""
    def stream():
        for i, batch in enumerate(_stream()):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    d = str(tmp_path)
    _, opt, hist = _loop(10, stream(), d, checkpoint_every=100, log_every=1)
    assert [s for s, _ in hist] == [0, 1, 2]
    assert CheckpointManager(d, device="cpu").list_steps() == [3]
    assert int(opt["step"]) == 3


def test_loop_watchdog_times_each_step(monkeypatch):
    """The loop times every step it takes with one ``StepWatchdog`` of
    ``watchdog_timeout``."""
    from repro_torch.runtime import resilience

    made = []

    class Kept(StepWatchdog):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(resilience, "StepWatchdog", Kept)
    _loop(3, _stream(), log_every=1, watchdog_timeout=30.0)
    assert len(made) == 1 and made[0].timeout == 30.0
    assert len(made[0].durations) == 3
    assert all(d > 0 for d in made[0].durations)


def test_preemption_checkpoint_and_stop():
    """The reference's ``test_preemption_checkpoint_and_stop``; and a
    guard on ``SIGTERM`` sets its flag on the signal."""
    g = PreemptionGuard(signals=())
    assert not g.should_stop
    g.trigger()
    assert g.should_stop
    g = PreemptionGuard()
    assert not g.should_stop
    os.kill(os.getpid(), signal.SIGTERM)
    t0 = time.monotonic()
    while not g.should_stop and time.monotonic() - t0 < 5.0:
        time.sleep(0.001)
    assert g.should_stop


def test_watchdog_flags_stragglers():
    """The reference's ``test_watchdog_flags_stragglers``."""
    wd = StepWatchdog(straggler_factor=5.0)
    for s in range(8):
        with wd.step(s):
            time.sleep(0.06 if s == 7 else 0.002)
    assert any(i == 7 for i, _, _ in wd.stragglers)


def test_failure_injector_fires_once():
    inj = FailureInjector(fail_at_step=2)
    inj.check(0)
    with pytest.raises(SimulatedFailure, match="step 2"):
        inj.check(2)
    inj.check(2)


if __name__ == "__main__":
    _reference_outputs(sys.argv[1], sys.argv[2])
