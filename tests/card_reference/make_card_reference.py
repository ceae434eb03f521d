"""Regenerate the card-reference fixtures: one TAC GSP level, one TAC+
snapshot and one tuned variant set, written by the reference.

Run from the repo root::

    PYTHONPATH=src python tests/card_reference/make_card_reference.py

The reference's numpy host path (``repro``) writes

* one dense level, made from a numpy seed by :func:`level`, through
  ``TACZWriter(algorithm="lorenzo", she=False, strategy="gsp",
  payload_codec="none")`` into ``gsp_lorenzo.tacz``, and stores the
  recon it reads back in ``gsp_lorenzo_recon.npz``.  The level is 64³
  values, so that on the card the global Lorenzo codes and recon
  (kernels 5 and 6) take their ``tile = shape`` routes;
* the TAC+ snapshot of ``synthetic_amr(**TACPLUS)`` (the ``run1_z10``
  structure at 128³), ``compress_amr`` at ``eb = 1e-3 · range`` of the
  finest level and ``write(payload_codec="none")``, into
  ``tacplus.tacz``, and the SHA-256 of each level's recon as read back
  (float32 bytes) into ``tacplus_recon.json``.  Its largest stack of
  16³ bricks holds more than 2¹⁷ values, so that kernel 1 takes its
  plane walk on the card;
* the mixture-of-experts case (:func:`write_moe_reference`) into
  ``moe.npz``: at the smoke width of granite-moe-1b-a400m (8 experts,
  top-2), ``moe_apply``'s output and ``aux`` in float32 and bf16 for a
  parameter tree and an input made from a numpy seed
  (:func:`seeded_tree`, :func:`moe_inputs`), and the smoke model's train
  logits and ``moe_aux`` for such a tree.  Only the outputs are stored:
  the parameters regenerate from the seed in either package.  The
  reference runs with ``--xla_allow_excess_precision=false``, so that
  its bf16 model rounds where its code says so;
* the recurrent case (:func:`write_recurrent_reference`) into
  ``recurrent.npz``: at the smoke widths of rwkv6-7b and zamba2-2.7b,
  ``rwkv6_apply``'s and ``mamba2_apply``'s outputs in float32 and bf16 in
  train (from zeros), prefill and decode (from a seeded carried state),
  and each smoke model's train logits and a prefill plus one decode
  step (zamba2's cut to its first group), on trees made from a numpy
  seed whose leaves that the
  recurrences read are drawn non-zero (:func:`recurrent_tree`,
  :func:`recurrent_inputs`);
* the embedding-input case (:func:`write_frontends_reference`) into
  ``frontends.npz``: at the smoke widths of musicgen-medium and
  internvl2-76b, in float32 and bf16, the train logits, a prefill and
  one decode step fed by seeded frontend embeddings;
* the train case (:func:`write_train_reference`) into ``train.npz``:
  on musicgen-medium's float32 smoke model, the loss and gradients and
  the loss and gradient norm with two microbatches, from the reference's
  unsharded ``loss_fn`` and ``_microbatched_grads``; the parameters after
  one AdamW and one Adafactor step from seeded gradients; and one
  two-replica int8 gradient exchange (digests of the mean and the
  residuals);
* the checkpoint case (:func:`write_checkpoint_reference`) into
  ``checkpoint/``: musicgen-medium's bf16 smoke model cut to one layer,
  on a seeded tree whose large leaves are smoothed as the reference's
  lossy checkpoint test smooths them, with a seeded Adafactor state,
  saved at step 3 by the reference's ``CheckpointManager`` lossless
  (``lossless/``) and lossy at ``eb_rel = 1e-3`` with the zlib byte pass
  pinned (``lossy/``), and ``restored.json``: the dtype, shape and
  SHA-256 (of the float32 values) of every array the reference restores
  from each;
* the variant set ``write_variant_set`` tunes and writes for the
  reference tuning tests' dataset (:data:`TUNED_DATASET`, 32³, two
  levels) and targets (:data:`TUNED_TARGETS`), default ladder, into
  ``tuned.taczv/`` (``hi.tacz``, ``lo.tacz``, ``variants.json``), and
  each variant's tuned ``ebs``, bits, metrics and the SHA-256 of each
  level it decodes to into ``tuned.json``.  Payloads are priced without
  the zstd pass (:func:`huffman_pricing`): with ``zstandard`` installed
  the bits are ``min(Huffman, zstd)``, so the tuner's bits, and the
  choices they steer, would follow the machine.

The payload codec is pinned: ``"auto"`` picks zstd only where
``zstandard`` is installed, so the bytes would follow the machine.  The
port must write the same bytes from the same data and decode them to
the same recon, on the CPU and on the card
(``tests/test_torch_card_reference.py``, ``chip_smoke.py``).

Only :func:`main` and the ``write_*`` functions import the reference:
the card's tests and ``chip_smoke.py`` import this module for
:func:`level`, :data:`TACPLUS`, the MoE case's seeds and the paths.
``--moe PATH`` writes only the MoE case, to ``PATH``; ``--recurrent
PATH`` only the recurrent case; ``--frontends PATH`` only the
embedding-input case; ``--train PATH`` only the train case;
``--checkpoint DIR`` only the checkpoint case, into ``DIR``.
"""
import contextlib
import hashlib
import importlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CONTAINER = os.path.join(HERE, "gsp_lorenzo.tacz")
RECON = os.path.join(HERE, "gsp_lorenzo_recon.npz")
TACPLUS_CONTAINER = os.path.join(HERE, "tacplus.tacz")
TACPLUS_RECON = os.path.join(HERE, "tacplus_recon.json")
TUNED_SET = os.path.join(HERE, "tuned.taczv")
TUNED_JSON = os.path.join(HERE, "tuned.json")
#: ``synthetic_amr`` arguments and targets of the tuned variant set
TUNED_DATASET = dict(finest_shape=(32, 32, 32), densities=[0.35, 0.65],
                     refine_block=4, seed=5)
TUNED_TARGETS = {"hi": "psnr>=70", "lo": "psnr>=50"}
TUNED_DEFAULT = "lo"
#: ``synthetic_amr`` arguments of the TAC+ snapshot (both packages'
#: generators give the same levels)
TACPLUS = dict(finest_shape=(128, 128, 128), densities=[0.23, 0.77],
               refine_block=16, lognormal_sigma=1.8, seed=10)
#: the MoE case: granite-moe-1b-a400m's smoke config, one seed for the
#: parameter trees, one for the inputs; ``moe_apply`` in groups of 16
MOE_FIXTURE = os.path.join(HERE, "moe.npz")
MOE_ARCH = "granite_moe_1b_a400m"
MOE_SEED = 2222
MOE_X_SHAPE = (2, 24)           # (batch, seq) of the moe_apply input
MOE_GROUP = 16
MOE_TOKENS_SHAPE = (2, 8)       # the smoke model's train tokens
MOE_DTYPES = ("float32", "bfloat16")
#: the recurrent case: rwkv6-7b's and zamba2-2.7b's smoke configs, one
#: seed for the parameter trees (:func:`recurrent_tree`), one for the
#: inputs; the blocks at chunk 8 on 40 positions, the smoke models
#: (zamba2's cut to its first group: :func:`recurrent_model_cfg`) on 12
#: tokens (train; a prefill of 11 and one decode step).  Stored: the
#: blocks' outputs at the last ``RECURRENT_KEEP`` positions (they follow
#: from every chunk through the carried state) and the decode step's, the
#: models' train logits at their last ``RECURRENT_KEEP // 2`` positions,
#: the prefill's and the decode step's logits
RECURRENT_FIXTURE = os.path.join(HERE, "recurrent.npz")
RECURRENT_ARCHS = ("rwkv6_7b", "zamba2_2_7b")
RECURRENT_SEED = 2323
RECURRENT_DTYPES = ("float32", "bfloat16")
RECURRENT_X_SHAPE = (2, 40)     # (batch, seq) of the block inputs
RECURRENT_CHUNK = 8
RECURRENT_TOKENS_SHAPE = (2, 12)
RECURRENT_KEEP = 8
#: the embedding-input case (``frontends.npz``): musicgen-medium's and
#: internvl2-76b's smoke configs on a numpy-seeded tree
#: (:func:`model_tree`) and seeded frontend embeddings, N(0, 1) · 0.02 in
#: float32 as the reference's stub frontend makes them
#: (:func:`frontend_inputs`): the train logits over ``FRONTEND_SHAPE``, a
#: prefill of all but the last position (bf16 cache) and one decode step
#: of the last
FRONTEND_FIXTURE = os.path.join(HERE, "frontends.npz")
FRONTEND_ARCHS = ("musicgen_medium", "internvl2_76b")
FRONTEND_SEED = 2424
FRONTEND_DTYPES = ("float32", "bfloat16")
FRONTEND_SHAPE = (2, 12)        # (batch, positions)
#: the train case (``train.npz``), on musicgen-medium's float32 smoke
#: model, a numpy-seeded tree and batch (:func:`train_batch`: labels whose
#: last position is -1, as the reference's pipelines mask it),
#: ``RunConfig(remat="layer")``: the loss and gradients, the loss and
#: gradient norm with two microbatches; the parameters after one AdamW
#: and after one Adafactor step, and one two-replica gradient exchange,
#: from seeded gradients and residuals shaped as the model's leaves
#: (:func:`exchange_inputs`; the steps take replica 0's), the exchange
#: stored as SHA-256 digests of the mean and the new residuals (it is
#: exact on either device)
TRAIN_FIXTURE = os.path.join(HERE, "train.npz")
TRAIN_ARCH = "musicgen_medium"
TRAIN_SEED = 2525
TRAIN_BATCH = (4, 16)           # (batch, positions)
TRAIN_ADAMW = dict(lr=1e-2, warmup_steps=1, total_steps=10)
TRAIN_ADAFACTOR = dict(lr=1e-2, warmup_steps=1, total_steps=10)
TRAIN_PODS = 2

#: The checkpoint case (:func:`write_checkpoint_reference`): the smoke
#: model of ``CHECKPOINT_ARCH`` cut to ``CHECKPOINT_LAYERS`` layers, its
#: tree from ``CHECKPOINT_SEED`` (:func:`checkpoint_params`), a seeded
#: Adafactor state (:func:`checkpoint_opt`), saved at ``CHECKPOINT_STEP``
#: once for each ``CHECKPOINT_KINDS`` entry (its ``lossy_eb_rel``)
CHECKPOINT_DIR = os.path.join(HERE, "checkpoint")
CHECKPOINT_ARCH = "musicgen_medium"
CHECKPOINT_LAYERS = 1
CHECKPOINT_SEED = 2626
CHECKPOINT_STEP = 3
CHECKPOINT_KINDS = {"lossless": 0.0, "lossy": 1e-3}
CHECKPOINT_EXTRA = {"arch": CHECKPOINT_ARCH, "seed": CHECKPOINT_SEED}

#: Relative max-error tolerances of the port's language-model tests, in
#: one table for tests/test_torch_lm_serving.py,
#: tests/test_torch_recurrent.py and tests/test_torch_card_reference.py:
#: ``TOL[kind][dtype]``, replaced for an arch by ``ARCH_TOL[(kind,
#: arch)]`` (read both through :func:`tol`).  Kinds: ``"block"``, a
#: recurrent block's outputs and states against the reference's;
#: ``"logits"``, a smoke model's train and prefill logits against the
#: reference's; ``"steps"``, its decode steps after a prefill;
#: ``"decode_vs_train"``, the port's prefill plus one decode step against
#: its own train logits.  float32 allows only a different summation
#: order; bf16 allows roundings one step apart, the tolerance of the
#: reference's own decode-vs-train test (tests/test_models.py).
TOL = {"block": {"float32": 1e-5, "bfloat16": 1e-2},
       "logits": {"float32": 1e-4, "bfloat16": 1e-2},
       "steps": {"float32": 1e-4, "bfloat16": 1e-2},
       "decode_vs_train": {"float32": 1e-4, "bfloat16": 1e-2}}
#: zamba2-2.7b at its full smoke depth (six groups of two Mamba2 layers
#: and the shared attention) amplifies a rounding difference about
#: twofold a group, in the reference as in the port: cut to one group it
#: keeps ``TOL``, and its reference's own bf16 logits move by 0.20–0.66
#: between XLA's two legal precision modes.  Its decode steps read the
#: conv state rounded to bf16 (the reference keeps it bf16 in every
#: dtype), where a float32 difference can flip a rounding; and the
#: reference's own decode-vs-train test holds it at 2e-2 in bf16
#: The train path's kinds (tests/test_torch_train.py and the train case
#: of tests/test_torch_card_reference.py): ``"loss"``, a smoke model's
#: loss; ``"grads"``, each gradient leaf's relative max error (bf16
#: gradients are rounded to bf16 and flow back through bf16 activations
#: whose roundings may fall one step apart: 1.9e-2 is the worst leaf
#: read, zamba2's one-group ``conv_w``); ``"update"``, each leaf's
#: optimizer update (new − old parameters) after a step from the same
#: gradients, whose only differences are float32 summation order (the
#: global norm, the factored means) and XLA's ``cos``/``pow``/``rsqrt``,
#: one ulp from libm's (held per value: within this share of the leaf's
#: largest update, plus one ulp of the value).
TOL.update({"loss": {"float32": 1e-6, "bfloat16": 1e-4},
            "grads": {"float32": 1e-5, "bfloat16": 2.5e-2},
            "update": {"float32": 1e-5}})
ARCH_TOL = {("logits", "zamba2_2_7b"): {"float32": 1e-4, "bfloat16": 1e-1},
            ("steps", "zamba2_2_7b"): {"float32": 1e-2, "bfloat16": 1e-1},
            ("decode_vs_train", "zamba2_2_7b"): {"float32": 5e-2,
                                                 "bfloat16": 2e-2}}
#: the embedding-input smoke models' float32 decode steps read the bf16
#: KV cache, where K/V values whose float32 bits differ in the last place
#: round to the other bf16 neighbour: 1–3 of the 4,608 values of the
#: second layer on the CPU (the first layer's are equal), each moving the
#: steps' logits by up to ~2e-4 (1.9e-4 read on the CPU, 8.4e-4 on the
#: card, whose float32 sums part further from the CPU's)
ARCH_TOL.update({("steps", arch): {"float32": 2e-3, "bfloat16": 1e-2}
                 for arch in FRONTEND_ARCHS})
#: rwkv6-7b's chunked WKV multiplies by exp(±Σ log w) within a chunk,
#: which amplifies float32 rounding in the backward: 1.4e-5 read on one
#: float32 leaf (its forward keeps TOL["logits"])
ARCH_TOL[("grads", "rwkv6_7b")] = {"float32": 5e-5, "bfloat16": 2.5e-2}


def tol(kind: str, dtype: str, arch: str | None = None) -> float:
    """The tolerance of ``kind`` in ``dtype`` for ``arch`` (see
    :data:`TOL`)."""
    return ARCH_TOL.get((kind, arch), TOL[kind])[dtype]
SHAPE = (64, 64, 64)
BLOCK = 8          # occupancy is decided per 8³ block
DENSITY = 0.9      # above the TAC path's GSP threshold
SEED = 1616
COMPRESS = dict(algorithm="lorenzo", she=False, strategy="gsp")
# no lossless pass: "auto" picks zstd where zstandard is installed, and
# its bytes follow the installed version
WRITER = dict(COMPRESS, payload_codec="none")


def level() -> tuple[np.ndarray, np.ndarray, float]:
    """The seeded dense level: float32 data, bool mask and the error
    bound (1e-3 of the masked values' range).  A smooth field plus
    lognormal noise; empty 8³ blocks hold zeros."""
    rng = np.random.default_rng(SEED)
    g = np.meshgrid(*(np.linspace(0.0, 2.0 * np.pi, s) for s in SHAPE),
                    indexing="ij")
    smooth = np.sin(g[0]) * np.cos(2.0 * g[1]) + 0.5 * np.sin(3.0 * g[2])
    data = (10.0 * smooth + rng.lognormal(0.0, 0.8, SHAPE)).astype(np.float32)
    nb = tuple(s // BLOCK for s in SHAPE)
    occupied = rng.random(nb) < DENSITY
    mask = np.repeat(np.repeat(np.repeat(occupied, BLOCK, 0), BLOCK, 1),
                     BLOCK, 2)
    data[~mask] = 0.0
    vals = data[mask]
    return data, mask, 1e-3 * float(vals.max() - vals.min())


def write_reference(path: str) -> np.ndarray:
    """Write the level with the reference into ``path``; returns the
    recon the reference reads back from it."""
    from repro import io as rio

    data, mask, eb = level()
    with rio.TACZWriter(path, eb=eb, **WRITER) as w:
        w.add_level(data, mask, ratio=1)
    recon, = rio.read(path)
    return recon


def spec_leaves(specs, prefix: str = "") -> dict:
    """``{"a/b": (shape, init)}`` for every leaf of a spec tree of either
    package (leaves read duck-typed: ``shape`` and ``init``)."""
    out = {}
    for k, v in specs.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(spec_leaves(v, path))
        else:
            out[path] = (tuple(v.shape), v.init)
    return out


def seeded_tree(leaves: dict, seed: int) -> dict:
    """A nested dict of float32 numpy leaves for :func:`spec_leaves`'
    output, drawn in sorted path order from ``default_rng(seed)``: ones
    and zeros as their ``init`` says, else ``N(0, 1) / √shape[-2]`` (a
    matrix's input width; 1 for a vector)."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for path in sorted(leaves):
        shape, init = leaves[path]
        if init == "ones":
            a = np.ones(shape, np.float32)
        elif init == "zeros":
            a = np.zeros(shape, np.float32)
        else:
            fan_in = shape[-2] if len(shape) > 1 else 1
            a = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32)
        node = tree
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = a
    return tree


def recurrence_leaf(name: str, shape: tuple, rng) -> np.ndarray | None:
    """A seeded float32 value for a leaf that the RWKV6 or Mamba2
    recurrence reads and the reference initialises to zeros or ones
    (``None`` for any other leaf): the token-shift mixes ``mu_*`` in
    U(0, 1); the decay base ``w0`` in U(-6, 1), so that the clipped
    decay spans slow to fast channels; the bonus ``u_bonus`` N(0, 0.5²);
    Mamba2's ``a_log`` = log U(1, 16) (a decay rate per head);
    ``dt_bias`` the inverse softplus of U(1e-3, 0.1) (Mamba2's step
    range); ``d_skip`` U(0.5, 1.5)."""
    if name.startswith("mu_"):
        a = rng.uniform(0.0, 1.0, shape)
    elif name == "w0":
        a = rng.uniform(-6.0, 1.0, shape)
    elif name == "u_bonus":
        a = rng.normal(0.0, 0.5, shape)
    elif name == "a_log":
        a = np.log(rng.uniform(1.0, 16.0, shape))
    elif name == "dt_bias":
        a = np.log(np.expm1(rng.uniform(1e-3, 0.1, shape)))
    elif name == "d_skip":
        a = rng.uniform(0.5, 1.5, shape)
    else:
        return None
    return a.astype(np.float32)


def with_recurrence_leaves(tree: dict, seed: int) -> dict:
    """``tree`` (nested dicts of float32 numpy leaves) with every leaf
    named by :func:`recurrence_leaf` redrawn, in sorted path order, from
    ``default_rng(seed)``; the other leaves are kept.  A new tree."""
    rng = np.random.default_rng(seed)

    def walk(node: dict) -> dict:
        out = {}
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            else:
                a = recurrence_leaf(k, np.shape(v), rng)
                out[k] = v if a is None else a
        return out
    return walk(tree)


def recurrent_tree(leaves: dict, seed: int) -> dict:
    """:func:`seeded_tree` with the recurrence's leaves redrawn
    (:func:`with_recurrence_leaves`, from ``seed + 1``)."""
    return with_recurrence_leaves(seeded_tree(leaves, seed), seed + 1)


def recurrent_inputs(cfg) -> tuple[np.ndarray, dict, np.ndarray]:
    """The recurrent case's inputs for ``cfg``'s family, from
    ``RECURRENT_SEED + 2``: the float32 block input ``(2, 40, d_model)``,
    a carried state of one block (float32 leaves; RWKV: ``wkv``,
    ``shift_t``, ``shift_c``; Mamba2: ``ssm`` and ``conv``, the conv
    values bf16-representable as the reference stores them) and the
    smoke model's tokens ``(2, 12)``."""
    rng = np.random.default_rng(RECURRENT_SEED + 2)
    B, S = RECURRENT_X_SHAPE
    d = cfg.d_model
    x = (0.5 * rng.standard_normal((B, S, d))).astype(np.float32)
    if cfg.family == "ssm":
        nh, hd = d // cfg.rwkv_head, cfg.rwkv_head
        state = {"wkv": 0.3 * rng.standard_normal((B, nh, hd, hd)),
                 "shift_t": rng.standard_normal((B, d)),
                 "shift_c": rng.standard_normal((B, d))}
    else:
        din = cfg.ssm_expand * d
        nh = din // cfg.ssm_head
        conv = rng.standard_normal((B, 3, din + 2 * cfg.ssm_state))
        # round to bf16 (to nearest even) through the float32 bits
        bits = conv.astype(np.float32).view(np.uint32)
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
        state = {"ssm": 0.3 * rng.standard_normal(
                     (B, nh, cfg.ssm_head, cfg.ssm_state)),
                 "conv": bits.astype(np.uint32).view(np.float32)}
    state = {k: np.asarray(v, np.float32) for k, v in state.items()}
    tokens = rng.integers(0, cfg.vocab_size, RECURRENT_TOKENS_SHAPE)
    return x, state, tokens


def recurrent_model_cfg(cfg):
    """The recurrent case's smoke model for ``cfg``: a hybrid cut to its
    first group (its Mamba2 layers, the shared attention and the shared
    MLP), so that it is held at ``TOL["logits"]`` (see :data:`ARCH_TOL`);
    an ssm model whole."""
    from dataclasses import replace

    if cfg.family == "hybrid":
        return replace(cfg, n_layers=cfg.shared_attn_every)
    return cfg


def recurrent_block(cfg) -> str:
    """``"rwkv"`` or ``"mamba"``: the block of ``cfg``'s family."""
    return "rwkv" if cfg.family == "ssm" else "mamba"


def write_recurrent_reference(path: str) -> dict:
    """Run the recurrent case on the reference and save its outputs
    (float32 arrays) to ``path``; returns them.  Set ``XLA_FLAGS`` before
    JAX starts (see :func:`main`)."""
    from dataclasses import replace

    import jax.numpy as jnp

    from repro.configs import RunConfig, smoke_config
    from repro.models import model as rmodel
    from repro.models import rwkv as rrwkv
    from repro.models import ssm as rssm
    from repro.serving import engine as rengine

    def cast(tree, specs):
        return {k: cast(v, specs[k]) if isinstance(v, dict)
                else jnp.asarray(v).astype(specs[k].dtype)
                for k, v in tree.items()}

    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    keep = RECURRENT_KEEP
    out = {}
    for arch in RECURRENT_ARCHS:
        for dtype in RECURRENT_DTYPES:
            cfg = replace(smoke_config(arch), dtype=dtype)
            block = recurrent_block(cfg)
            x, state, tokens = recurrent_inputs(cfg)
            apply, specs = ((rrwkv.rwkv6_apply, rrwkv.rwkv6_specs(cfg))
                            if block == "rwkv" else
                            (rssm.mamba2_apply, rssm.mamba2_specs(cfg)))
            params = cast(recurrent_tree(spec_leaves(specs),
                                         RECURRENT_SEED), specs)
            st = {k: jnp.asarray(v).astype(
                jnp.bfloat16 if k == "conv" else jnp.float32)
                for k, v in state.items()}
            xj = jnp.asarray(x).astype(dtype)
            tag = f"{block}/{dtype}"
            y, _ = apply(params, xj, cfg, mode="train",
                         chunk=RECURRENT_CHUNK)
            out[f"{tag}/train"] = f32(y[:, -keep:])
            y, _ = apply(params, xj, cfg, mode="prefill", state=st,
                         chunk=RECURRENT_CHUNK)
            out[f"{tag}/prefill"] = f32(y[:, -keep:])
            y, _ = apply(params, xj[:, :1], cfg, mode="decode", state=st)
            out[f"{tag}/decode"] = f32(y)
            cfg = recurrent_model_cfg(cfg)
            specs = rmodel.model_specs(cfg)
            params = cast(recurrent_tree(spec_leaves(specs),
                                         RECURRENT_SEED), specs)
            tag = f"model/{arch}/{dtype}"
            tk = jnp.asarray(tokens)
            logits, _ = rmodel.forward(params, cfg, tokens=tk, mode="train")
            out[f"{tag}/train"] = f32(logits[:, -keep // 2:])
            run = RunConfig(kv_quant=False)
            lg, state1 = rengine.make_prefill_step(cfg, run)(
                params, {"tokens": tk[:, :-1]})
            out[f"{tag}/prefill"] = f32(lg)
            state1 = rengine.ServingEngine(cfg, run)._grow_cache(state1, 1)
            lg, _ = rengine.make_serve_step(cfg, run)(
                params, state1, {"tokens": tk[:, -1:]},
                jnp.int32(tokens.shape[1] - 1))
            out[f"{tag}/decode"] = f32(lg)
    np.savez_compressed(path, **out)
    return out


def model_tree(specs, cfg, seed: int) -> dict:
    """A smoke model's float32 numpy tree for either package's
    ``model_specs(cfg)``: :func:`seeded_tree`, and for an ssm or hybrid
    config the recurrence's leaves redrawn from ``seed + 1``
    (:func:`recurrent_tree`)."""
    if cfg.family in ("ssm", "hybrid"):
        return recurrent_tree(spec_leaves(specs), seed)
    return seeded_tree(spec_leaves(specs), seed)


def embeddings(rng, shape: tuple) -> np.ndarray:
    """Frontend embeddings as the reference's stub frontend makes them:
    N(0, 1) · 0.02, float32."""
    return rng.standard_normal(shape).astype(np.float32) * np.float32(0.02)


def frontend_inputs(cfg) -> np.ndarray:
    """The embedding-input case's ``FRONTEND_SHAPE + (d_model,)``
    embeddings, from ``FRONTEND_SEED + 1``."""
    return embeddings(np.random.default_rng(FRONTEND_SEED + 1),
                      FRONTEND_SHAPE + (cfg.d_model,))


def train_batch(cfg, shape: tuple, seed: int) -> dict:
    """A seeded train batch: ``tokens`` (int32) or ``embeds`` for the
    config's input mode, and ``labels`` (int32) in ``[0, vocab)`` with the
    last position -1 (masked)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_mode == "tokens":
        out["tokens"] = rng.integers(0, cfg.vocab_size, shape).astype(
            np.int32)
    else:
        out["embeds"] = embeddings(rng, shape + (cfg.d_model,))
    labels = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels[:, -1] = -1
    out["labels"] = labels
    return out


def exchange_inputs(leaves: dict, n_pods: int, seed: int
                    ) -> tuple[dict, dict]:
    """Seeded ``(gradients, residuals)`` for a two-replica exchange: for
    each ``{"a/b": (shape, init)}`` leaf, in sorted path order, float32
    ``(n_pods, …)`` gradients N(0, 1) · 1e-2 and residuals N(0, 1) ·
    1e-4, as flat ``{"a/b": array}`` dicts."""
    rng = np.random.default_rng(seed)
    grads, ef = {}, {}
    for path in sorted(leaves):
        shape = (n_pods,) + tuple(leaves[path][0])
        grads[path] = (1e-2 * rng.standard_normal(shape)).astype(np.float32)
        ef[path] = (1e-4 * rng.standard_normal(shape)).astype(np.float32)
    return grads, ef


def nested(flat_tree: dict) -> dict:
    """The nested dict of ``{"a/b": leaf}``."""
    out: dict = {}
    for path, v in flat_tree.items():
        node = out
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


def flat(tree, prefix: str = "") -> dict:
    """``{"a/b": leaf}`` of a nested dict."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _as_reference(tree: dict, specs: dict) -> dict:
    import jax.numpy as jnp

    return {k: _as_reference(v, specs[k]) if isinstance(v, dict)
            else jnp.asarray(v).astype(specs[k].dtype)
            for k, v in tree.items()}


def write_frontends_reference(path: str) -> dict:
    """Run the embedding-input case on the reference and save its outputs
    (float32 arrays) to ``path``; returns them.  Set ``XLA_FLAGS`` before
    JAX starts (see :func:`main`)."""
    from dataclasses import replace

    import jax.numpy as jnp

    from repro.configs import RunConfig, smoke_config
    from repro.models import model as rmodel
    from repro.serving import engine as rengine

    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    out = {}
    for arch in FRONTEND_ARCHS:
        for dtype in FRONTEND_DTYPES:
            cfg = replace(smoke_config(arch), dtype=dtype)
            specs = rmodel.model_specs(cfg)
            params = _as_reference(model_tree(specs, cfg, FRONTEND_SEED),
                                   specs)
            emb = jnp.asarray(frontend_inputs(cfg))
            tag = f"{arch}/{dtype}"
            logits, _ = rmodel.forward(params, cfg, embeds=emb, mode="train")
            out[f"{tag}/train"] = f32(logits)
            run = RunConfig(kv_quant=False)
            lg, state = rengine.make_prefill_step(cfg, run)(
                params, {"embeds": emb[:, :-1]})
            out[f"{tag}/prefill"] = f32(lg)
            state = rengine.ServingEngine(cfg, run)._grow_cache(state, 1)
            lg, _ = rengine.make_serve_step(cfg, run)(
                params, state, {"embeds": emb[:, -1:]},
                jnp.int32(FRONTEND_SHAPE[1] - 1))
            out[f"{tag}/decode"] = f32(lg)
    np.savez_compressed(path, **out)
    return out


def reference_exchange(grads: list, efs: list) -> tuple[dict, list]:
    """The reference's two-replica exchange, its ``_quant_leaf`` and
    ``_dequant_leaf`` composed as ``make_train_step_compressed``'s
    ``exchange.one`` composes them, run eagerly: ``grads``/``efs`` one
    nested dict of a replica each.  Returns ``(the mean gradient, each
    replica's new residual)``."""
    import jax.numpy as jnp

    from repro.optim.grad_compress import _dequant_leaf, _quant_leaf

    g_flat, e_flat = [flat(g) for g in grads], [flat(e) for e in efs]
    mean, new_e = {}, [{} for _ in grads]
    for path in sorted(g_flat[0]):
        deqs = []
        for r, (g, e) in enumerate(zip(g_flat, e_flat)):
            leaf = g[path]
            gc = leaf.astype(jnp.float32) + e[path]
            q, scale = _quant_leaf(gc.reshape(-1))
            deq = _dequant_leaf(q, scale, gc.shape)
            new_e[r][path] = gc - deq
            deqs.append(deq)
        mean[path] = jnp.stack(deqs).mean(axis=0).astype(
            g_flat[0][path].dtype)
    return mean, new_e


def write_train_reference(path: str) -> dict:
    """Run the train case on the reference's unsharded functions and save
    its outputs to ``path`` (float32 arrays; the exchange as digests);
    returns them."""
    from dataclasses import replace

    import jax
    import jax.numpy as jnp

    from repro.configs import RunConfig, smoke_config
    from repro.launch.train import _microbatched_grads, loss_fn
    from repro.models import model as rmodel
    from repro.optim.adafactor import (AdafactorConfig, adafactor_init,
                                       adafactor_update)
    from repro.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                   global_norm)

    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    cfg = replace(smoke_config(TRAIN_ARCH), dtype="float32")
    specs = rmodel.model_specs(cfg)
    params = _as_reference(model_tree(specs, cfg, TRAIN_SEED), specs)
    batch = {k: jnp.asarray(v) for k, v in
             train_batch(cfg, TRAIN_BATCH, TRAIN_SEED + 1).items()}
    run = RunConfig(remat="layer")
    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, batch, cfg, run)
    out = {"loss": f32(loss)}
    out.update({f"grads/{k}": f32(v) for k, v in flat(grads).items()})
    # the optimizer steps take replica 0's seeded gradients: the model's
    # own would carry their float32 summation order into Adam's first
    # step, which divides each gradient by its magnitude
    g2, e2 = exchange_inputs(spec_leaves(specs), TRAIN_PODS, TRAIN_SEED + 2)
    step_grads = nested({k: jnp.asarray(v[0]) for k, v in g2.items()})
    for name, opt, init, update in (
            ("adamw", AdamWConfig(**TRAIN_ADAMW), adamw_init, adamw_update),
            ("adafactor", AdafactorConfig(**TRAIN_ADAFACTOR), adafactor_init,
             adafactor_update)):
        new, _, stats = update(params, step_grads, init(params, opt), opt)
        out.update({f"{name}/{k}": f32(v) for k, v in stats.items()})
        out.update({f"{name}/params/{k}": f32(v)
                    for k, v in flat(new).items()})
    loss, _, grads = _microbatched_grads(params, batch, cfg,
                                         replace(run, microbatches=2))
    out["mb2/loss"] = f32(loss)
    out["mb2/grad_norm"] = f32(global_norm(grads))
    mean, new_e = reference_exchange(
        [{k: jnp.asarray(v[r]) for k, v in g2.items()}
         for r in range(TRAIN_PODS)],
        [{k: jnp.asarray(v[r]) for k, v in e2.items()}
         for r in range(TRAIN_PODS)])
    for k in g2:
        out[f"exchange/mean/{k}"] = np.asarray(digest(f32(mean[k])))
        out[f"exchange/ef/{k}"] = np.asarray(digest(np.stack(
            [f32(e[k]) for e in new_e])))
    np.savez_compressed(path, **out)
    return out


def smooth_leaf(a: np.ndarray) -> np.ndarray:
    """A float32 leaf as the reference's lossy checkpoint test shapes it
    (trained weights have structure, random ones do not compress): for
    rank ≥ 2 and more than 4096 values, ``0.02 · sin(r / 9) · cos(c / 7)``
    over its last two axes plus ``0.001`` of the leaf; else as it is."""
    if a.ndim < 2 or a.size <= 4096:
        return a
    r = np.arange(a.shape[-2], dtype=np.float32)
    c = np.arange(a.shape[-1], dtype=np.float32)
    field = np.sin(r[:, None] / np.float32(9.0)) * np.cos(
        c[None, :] / np.float32(7.0))
    return (field * np.float32(0.02) + np.float32(0.001) * a).astype(
        np.float32)


def checkpoint_cfg(smoke):
    """The checkpoint case's config from either package's
    ``smoke_config``."""
    from dataclasses import replace

    return replace(smoke(CHECKPOINT_ARCH), n_layers=CHECKPOINT_LAYERS)


def checkpoint_params(specs) -> dict:
    """``{"a/b": float32 array}``: :func:`seeded_tree` from
    ``CHECKPOINT_SEED``, each leaf through :func:`smooth_leaf`."""
    tree = seeded_tree(spec_leaves(specs), CHECKPOINT_SEED)
    return {k: smooth_leaf(v) for k, v in flat(tree).items()}


def checkpoint_opt(shapes: dict) -> dict:
    """``{"a/b": array}`` for an optimizer state of the leaf shapes
    ``shapes``: ``step`` the int32 ``CHECKPOINT_STEP``, every other leaf
    ``|N(0, 1)| · 1e-4`` (float32), drawn in sorted path order from
    ``CHECKPOINT_SEED + 1``."""
    rng = np.random.default_rng(CHECKPOINT_SEED + 1)
    out = {}
    for path in sorted(shapes):
        if path == "step":
            out[path] = np.asarray(CHECKPOINT_STEP, np.int32)
        else:
            out[path] = (1e-4 * np.abs(rng.standard_normal(
                shapes[path]))).astype(np.float32)
    return out


def restored_summary(params: dict, opt: dict) -> dict:
    """``{"params/a/b": [dtype, shape, digest]}`` of a restored state,
    whose leaves are numpy arrays (of any dtype, ``digest`` of their
    float32 values)."""
    return {path: [str(a.dtype), list(a.shape),
                   digest(np.asarray(a).astype(np.float32))]
            for path, a in flat({"params": params, "opt": opt}).items()}


def write_checkpoint_reference(directory: str) -> dict:
    """Save the checkpoint case with the reference's ``CheckpointManager``
    into ``directory/{lossless,lossy}/`` (the lossy one with the zlib
    byte pass, as where ``zstandard`` is missing) and write
    ``directory/restored.json``: :func:`restored_summary` of what the
    reference restores from each.  Returns that summary."""
    from repro.checkpoint.manager import CheckpointManager
    from repro.configs import smoke_config
    from repro.io import tensor as rtensor
    from repro.models import model as rmodel
    from repro.optim.adafactor import AdafactorConfig, adafactor_init

    cfg = checkpoint_cfg(smoke_config)
    specs = rmodel.model_specs(cfg)
    params = _as_reference(nested(checkpoint_params(specs)), specs)
    shapes = {k: tuple(v.shape) for k, v in flat(
        adafactor_init(params, AdafactorConfig())).items()}
    opt = nested(checkpoint_opt(shapes))
    summary = {}
    have_zstd = rtensor.HAVE_ZSTD
    rtensor.HAVE_ZSTD = False
    try:
        for kind, eb_rel in CHECKPOINT_KINDS.items():
            mgr = CheckpointManager(os.path.join(directory, kind),
                                    lossy_eb_rel=eb_rel)
            mgr.save(CHECKPOINT_STEP, params, opt, extra=CHECKPOINT_EXTRA,
                     blocking=True)
            rp, ro, step = mgr.restore(CHECKPOINT_STEP)
            assert step == CHECKPOINT_STEP
            summary[kind] = restored_summary(rp, ro)
    finally:
        rtensor.HAVE_ZSTD = have_zstd
    with open(os.path.join(directory, "restored.json"), "w") as f:
        json.dump(summary, f, indent=1, sort_keys=True)
        f.write("\n")
    return summary


def moe_inputs(cfg) -> tuple[np.ndarray, np.ndarray]:
    """The MoE case's float32 ``moe_apply`` input ``(2, 24, d_model)`` and
    the smoke model's train tokens ``(2, 8)``, from ``MOE_SEED + 1``."""
    rng = np.random.default_rng(MOE_SEED + 1)
    x = rng.standard_normal(MOE_X_SHAPE + (cfg.d_model,)).astype(np.float32)
    return x, rng.integers(0, cfg.vocab_size, MOE_TOKENS_SHAPE)


def write_moe_reference(path: str) -> dict:
    """Run the MoE case on the reference and save its outputs (float32
    arrays) to ``path``; returns them.  Set ``XLA_FLAGS`` before JAX
    starts (see :func:`main`)."""
    from dataclasses import replace

    import jax.numpy as jnp

    from repro.configs import smoke_config
    from repro.models import model as rmodel
    from repro.models import moe as rmoe

    def cast(tree, specs):
        return {k: cast(v, specs[k]) if isinstance(v, dict)
                else jnp.asarray(v).astype(specs[k].dtype)
                for k, v in tree.items()}

    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    out = {}
    for dtype in MOE_DTYPES:
        cfg = replace(smoke_config(MOE_ARCH), dtype=dtype)
        x, tokens = moe_inputs(cfg)
        specs = rmoe.moe_specs(cfg)
        params = cast(seeded_tree(spec_leaves(specs), MOE_SEED), specs)
        y, aux = rmoe.moe_apply(params, jnp.asarray(x).astype(dtype), cfg,
                                group_size=MOE_GROUP)
        out[f"moe_apply/{dtype}/out"], out[f"moe_apply/{dtype}/aux"] = (
            f32(y), f32(aux))
        specs = rmodel.model_specs(cfg)
        params = cast(seeded_tree(spec_leaves(specs), MOE_SEED), specs)
        logits, aux = rmodel.forward(params, cfg, tokens=jnp.asarray(tokens),
                                     mode="train")
        out[f"model/{dtype}/logits"] = f32(logits)
        out[f"model/{dtype}/moe_aux"] = f32(aux["moe_aux"])
    np.savez_compressed(path, **out)
    return out


def finest_eb(ds) -> float:
    """1e-3 of the finest level's masked range: the snapshot's bound."""
    vals = ds.levels[0].data[ds.levels[0].mask]
    return 1e-3 * float(vals.max() - vals.min())


def digest(a: np.ndarray) -> str:
    """SHA-256 of a float32 array's bytes."""
    return hashlib.sha256(np.ascontiguousarray(
        a, dtype=np.float32).tobytes()).hexdigest()


def write_tacplus_reference(path: str) -> list[str]:
    """Write the TAC+ snapshot with the reference into ``path``; returns
    the digests of the levels the reference reads back from it."""
    from repro import io as rio
    from repro.core import amr, hybrid

    ds = amr.synthetic_amr(**TACPLUS)
    res = hybrid.compress_amr(ds, eb=finest_eb(ds))
    rio.write(path, res, payload_codec="none")
    return [digest(r) for r in rio.read(path)]


def tuned_summary(set_dir: str, read) -> dict:
    """Each variant's catalog row (``ebs``, ``bits``, ``metrics``) and the
    digests of the levels ``read(path)`` decodes its file to."""
    with open(os.path.join(set_dir, "variants.json")) as f:
        catalog = json.load(f)
    return {"default": catalog["default"], "variants": {
        v["name"]: {"ebs": v["ebs"], "bits": v["bits"],
                    "metrics": v["metrics"],
                    "levels": [digest(r) for r in
                               read(os.path.join(set_dir, v["file"]))]}
        for v in catalog["variants"]}}


@contextlib.contextmanager
def huffman_pricing(package: str):
    """While active, ``package`` (``"repro"`` or ``"repro_torch"``)
    prices code streams by their Huffman bits alone, as on a machine
    without ``zstandard``; the file bytes do not change."""
    mods = [importlib.import_module(f"{package}.core.{m}")
            for m in ("she", "sz")]
    saved = [m.zstd_size_bits for m in mods]
    for m in mods:
        m.zstd_size_bits = lambda buf, **kw: None
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.zstd_size_bits = fn


def write_tuned_reference(set_dir: str) -> dict:
    """Tune and write the variant set with the reference into
    ``set_dir``; returns :func:`tuned_summary` of it."""
    from repro import io as rio
    from repro.core import amr
    from repro.tuning import write_variant_set

    ds = amr.synthetic_amr(**TUNED_DATASET)
    with huffman_pricing("repro"):
        write_variant_set(set_dir, ds, TUNED_TARGETS, default=TUNED_DEFAULT,
                          payload_codec="none")
    return tuned_summary(set_dir, rio.read)


def main() -> None:
    recon = write_reference(CONTAINER)
    write_moe_reference(MOE_FIXTURE)
    write_recurrent_reference(RECURRENT_FIXTURE)
    write_frontends_reference(FRONTEND_FIXTURE)
    write_train_reference(TRAIN_FIXTURE)
    np.savez_compressed(RECON, recon=recon)
    levels = write_tacplus_reference(TACPLUS_CONTAINER)
    with open(TACPLUS_RECON, "w") as f:
        json.dump({"levels": levels}, f, indent=1)
        f.write("\n")
    write_checkpoint_reference(CHECKPOINT_DIR)
    tuned = write_tuned_reference(TUNED_SET)
    with open(TUNED_JSON, "w") as f:
        json.dump(tuned, f, indent=1, sort_keys=True)
        f.write("\n")
    for p in (CONTAINER, RECON, MOE_FIXTURE, RECURRENT_FIXTURE,
              FRONTEND_FIXTURE, TRAIN_FIXTURE, TACPLUS_CONTAINER,
              TACPLUS_RECON,
              *(os.path.join(CHECKPOINT_DIR, k, f"step_{CHECKPOINT_STEP:08d}{e}")
                for k in CHECKPOINT_KINDS for e in (".npz", ".json")),
              os.path.join(CHECKPOINT_DIR, "restored.json"),
              *(os.path.join(TUNED_SET, n)
                for n in sorted(os.listdir(TUNED_SET))), TUNED_JSON):
        print(f"{p}: {os.path.getsize(p)} bytes")


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(HERE, "..", "..", "src"))
    # before JAX starts: bf16 rounds where the reference's code says so
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_allow_excess_precision=false").strip()
    if sys.argv[1:2] == ["--moe"]:
        write_moe_reference(sys.argv[2])
    elif sys.argv[1:2] == ["--recurrent"]:
        write_recurrent_reference(sys.argv[2])
    elif sys.argv[1:2] == ["--frontends"]:
        write_frontends_reference(sys.argv[2])
    elif sys.argv[1:2] == ["--train"]:
        write_train_reference(sys.argv[2])
    elif sys.argv[1:2] == ["--checkpoint"]:
        write_checkpoint_reference(sys.argv[2])
    else:
        main()
