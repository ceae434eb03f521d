"""Regenerate the card-reference fixtures: one TAC GSP level and one
TAC+ snapshot, written by the reference.

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
  plane walk on the card.

The payload codec is pinned: ``"auto"`` picks zstd only where
``zstandard`` is installed, so the bytes would follow the machine.  The
port must write the same bytes from the same data and decode them to
the same recon, on the CPU and on the card
(``tests/test_torch_card_reference.py``, ``chip_smoke.py``).

Only :func:`main` and the ``write_*`` functions import the reference:
the card's tests and ``chip_smoke.py`` import this module for
:func:`level`, :data:`TACPLUS` and the paths.
"""
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CONTAINER = os.path.join(HERE, "gsp_lorenzo.tacz")
RECON = os.path.join(HERE, "gsp_lorenzo_recon.npz")
TACPLUS_CONTAINER = os.path.join(HERE, "tacplus.tacz")
TACPLUS_RECON = os.path.join(HERE, "tacplus_recon.json")
#: ``synthetic_amr`` arguments of the TAC+ snapshot (both packages'
#: generators give the same levels)
TACPLUS = dict(finest_shape=(128, 128, 128), densities=[0.23, 0.77],
               refine_block=16, lognormal_sigma=1.8, seed=10)
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


def main() -> None:
    recon = write_reference(CONTAINER)
    np.savez_compressed(RECON, recon=recon)
    levels = write_tacplus_reference(TACPLUS_CONTAINER)
    with open(TACPLUS_RECON, "w") as f:
        json.dump({"levels": levels}, f, indent=1)
        f.write("\n")
    for p in (CONTAINER, RECON, TACPLUS_CONTAINER, TACPLUS_RECON):
        print(f"{p}: {os.path.getsize(p)} bytes")


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(HERE, "..", "..", "src"))
    main()
