"""End-to-end training entry point: data stream → data-parallel train
step on the smoke mesh → checkpoints → resilience, on any ``--arch``
(reduced or full config), or a preset.

The port's counterpart of the reference's ``examples/train_lm.py``, with
its flags, defaults and presets, plus ``--device`` (default ``cuda``,
which needs a card).  Default: a ~20M-parameter llama-style model on the
synthetic LM stream.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 60
    PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 300 \\
        --preset 100m
    PYTHONPATH=src python -m repro_torch.launch.train_lm \\
        --arch deepseek_7b --smoke --steps 40
    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu \\
        --steps 10 --batch 2 --seq 16 --ckpt ckpt_dir

SIGTERM checkpoints and exits; re-running resumes from the last
checkpoint (saved every ``max(steps // 4, 10)`` steps).  ``--amr-data``
trains on quantization codes of a synthetic AMR field.  The report
counts the steps this run took (a resumed run takes fewer than
``--steps``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist

from ..configs import RunConfig, get_config, smoke_config
from ..configs.base import ModelConfig, ShapeConfig
from ..data.pipeline import amr_token_batches, embedding_batches, lm_batches
from ..device import resolve_device
from ..models.model import param_counts
from ..optim.adamw import AdamWConfig
from .mesh import make_smoke_mesh
from .train import train_loop

__all__ = ["PRESETS", "main"]

PRESETS = {
    # ~110M params: the "train a ~100M model" preset
    "100m": ModelConfig(name="demo-100m", family="dense", n_layers=10,
                        d_model=640, n_heads=10, n_kv_heads=10, d_ff=2560,
                        vocab_size=32768),
    "20m": ModelConfig(name="demo-20m", family="dense", n_layers=6,
                       d_model=320, n_heads=8, n_kv_heads=8, d_ff=1280,
                       vocab_size=8192),
}


class _Counted:
    """An iterator that counts the items drawn from it: the loop draws
    one batch a step it takes."""

    def __init__(self, it):
        self.it, self.n = it, 0

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self.it)
        self.n += 1
        return item


def main(argv=None) -> list[tuple[int, float]]:
    """Parse ``argv`` (default: the command line), train, print the
    report; returns the loop's ``history``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="assigned arch id")
    ap.add_argument("--preset", default="20m", choices=sorted(PRESETS))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config for --arch")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--amr-data", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.arch:
        cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    else:
        cfg = PRESETS[args.preset]
    total, active = param_counts(cfg)
    print(f"model: {cfg.name}  params={total / 1e6:.1f}M "
          f"(active {active / 1e6:.1f}M)")

    run = RunConfig(microbatches=args.microbatches, remat="layer")
    started = not dist.is_initialized()      # the smoke mesh starts a group
    mesh = make_smoke_mesh(device=device.type)
    shape = ShapeConfig("train", "train", seq_len=args.seq,
                        global_batch=args.batch)
    if cfg.input_mode != "tokens":
        stream = embedding_batches(cfg, shape, seed=0, device=device)
    elif args.amr_data:
        stream = amr_token_batches(cfg, shape, seed=0, device=device)
    else:
        stream = lm_batches(cfg, shape, seed=0, device=device)
    stream = _Counted(stream)

    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps)
    t0 = time.time()
    try:
        _, _, hist = train_loop(
            cfg, run, stream, steps=args.steps, opt_cfg=opt,
            checkpoint_dir=args.ckpt,
            checkpoint_every=max(args.steps // 4, 10),
            log_every=max(args.steps // 15, 1), mesh=mesh, device=device)
    finally:
        if started:
            dist.destroy_process_group()
    dt = time.time() - t0
    toks = stream.n * args.batch * args.seq
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print("\nstep, loss")
    for s, l in hist:
        print(f"{s:5d}, {l:.4f}")
    span = f"; loss {hist[0][1]:.3f} → {hist[-1][1]:.3f}" if hist else ""
    print(f"\n{stream.n} steps in {dt:.0f}s "
          f"({toks / dt:.0f} tok/s on a mesh of {mesh.size()} rank(s), "
          f"{where}){span}")
    return hist


if __name__ == "__main__":
    main()
