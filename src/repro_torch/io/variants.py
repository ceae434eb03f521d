"""Multi-variant TACZ snapshot sets: catalog framing and selection (the
port of ``repro.io.variants``; the catalog bytes are the reference's for
the same body).

A *variant set* is a directory holding several eb-variant snapshots of
the same dataset under one catalog::

    snap.taczv/
      variants.json          (published last, atomically — commit point)
      default.tacz           (one snapshot per variant; single-file or
      psnr60.tacz             multi-part directories both work)
      ...

Each variant entry records the snapshot file name, the per-level eb
vector it was compressed at, its encoded bits, and the application
metrics measured from its decoded form — i.e. one
:class:`repro_torch.io.frontier.FrontierPoint` per variant, plus a name and a
file.  A distortion-target request (``"psnr>=60"``) selects the
cheapest variant whose recorded metrics satisfy the target; no target
selects the catalog's ``default``.

The catalog reuses the manifest's canonical-JSON CRC scheme
(:func:`repro_torch.io.manifest.manifest_crc`): magic ``"TACZV"``, version,
``crc32`` over the sorted-key JSON body sans the ``crc32`` key.  The
autotuner's :func:`repro_torch.tuning.write_variant_set` is the writer;
:class:`repro_torch.serving.variants.VariantServer` is the serving
consumer.  Spec: ``docs/tuning.md``.
"""
from __future__ import annotations

import json
import os

from . import manifest as mfst
from .frontier import (HIGHER_IS_BETTER, Target, TargetUnsatisfiable,
                       parse_target)

__all__ = ["VARIANTS_MAGIC", "VARIANTS_NAME", "VARIANTS_VERSION",
           "is_variant_set", "load_catalog", "select_variant",
           "variant_names", "write_catalog"]

VARIANTS_NAME = "variants.json"
VARIANTS_MAGIC = "TACZV"
VARIANTS_VERSION = 1


def _catalog_path(path: str) -> str:
    if os.path.basename(path) == VARIANTS_NAME:
        return path
    return os.path.join(path, VARIANTS_NAME)


def is_variant_set(path) -> bool:
    """True when ``path`` is a variant-set directory (or its catalog
    file) — the dispatch test ``repro_torch.serving.serve`` uses."""
    if not isinstance(path, (str, os.PathLike)):
        return False
    path = os.fspath(path)
    if os.path.isdir(path):
        return os.path.exists(os.path.join(path, VARIANTS_NAME))
    return os.path.basename(path) == VARIANTS_NAME and os.path.exists(path)


def write_catalog(set_dir: str, body: dict) -> str:
    """Stamp magic/version/``crc32`` into ``body`` and publish the
    catalog atomically (tmp + fsync + ``os.replace``).

    :param set_dir: the variant-set directory (must exist).
    :param body: catalog body with ``default`` and ``variants`` keys;
        ``magic``/``version``/``crc32`` are overwritten.
    :returns: the catalog path.
    """
    body = dict(body)
    body["magic"] = VARIANTS_MAGIC
    body["version"] = VARIANTS_VERSION
    body.pop("crc32", None)
    body["crc32"] = mfst.manifest_crc(body)
    path = _catalog_path(set_dir)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(body, f, sort_keys=True, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_catalog(path: str) -> dict:
    """Read and validate a variant catalog (magic, version, CRC, and
    the structural minimum: a non-empty ``variants`` list whose
    ``default`` entry exists).

    :param path: variant-set directory or catalog file path.
    :raises ValueError: on bad magic, an unsupported version, a CRC
        mismatch, malformed JSON, or a missing default variant.
    :raises OSError: if the file cannot be read.
    """
    cpath = _catalog_path(os.fspath(path))
    with open(cpath, encoding="utf-8") as f:
        try:
            body = json.load(f)
        except json.JSONDecodeError as exc:
            raise ValueError(f"corrupt variant catalog {cpath}: "
                             f"{exc}") from exc
    if not isinstance(body, dict) or body.get("magic") != VARIANTS_MAGIC:
        raise ValueError(f"not a TACZ variant catalog: {cpath}")
    if int(body.get("version", 0)) > VARIANTS_VERSION:
        raise ValueError(
            f"unsupported variant catalog version {body.get('version')}")
    if int(body.get("crc32", -1)) != mfst.manifest_crc(body):
        raise ValueError(f"corrupt variant catalog {cpath}: CRC mismatch")
    variants = body.get("variants")
    if not variants or not isinstance(variants, list):
        raise ValueError(f"variant catalog {cpath} lists no variants")
    names = [str(v["name"]) for v in variants]
    if len(set(names)) != len(names):
        raise ValueError(f"variant catalog {cpath} repeats a name")
    if str(body.get("default")) not in names:
        raise ValueError(
            f"variant catalog {cpath}: default variant not in catalog")
    return body


def variant_names(catalog: dict) -> list[str]:
    """Variant names a catalog binds, in catalog order."""
    return [str(v["name"]) for v in catalog.get("variants", [])]


def select_variant(catalog: dict, target: Target | str | None) -> dict:
    """The catalog entry a request resolves to.

    No ``target`` → the catalog's default variant; otherwise the
    cheapest (fewest bits) variant whose recorded metrics satisfy the
    target.

    :raises TargetUnsatisfiable: when a target is given and no variant
        qualifies (carries the best achievable value).
    :raises ValueError: on a malformed target spec.
    """
    variants = catalog["variants"]
    if target is None:
        default = str(catalog["default"])
        return next(v for v in variants if str(v["name"]) == default)
    if isinstance(target, str):
        target = parse_target(target)
    ok = [v for v in variants
          if target.satisfies(v.get("metrics", {}))]
    if not ok:
        vals = [v["metrics"][target.metric] for v in variants
                if target.metric in v.get("metrics", {})]
        best = None
        if vals:
            best = (max(vals) if HIGHER_IS_BETTER.get(target.metric, False)
                    else min(vals))
        raise TargetUnsatisfiable(target, best)
    return min(ok, key=lambda v: int(v.get("bits", 0)))
