"""Multi-part TACZ snapshot manifest: framing, (de)serialization, probing.

A multi-part snapshot is a directory::

    snap.taczd/
      manifest.json        (published last, atomically — the commit point)
      part-0000.tacz       (each a complete, valid TACZ container)
      part-0001.tacz
      ...

Each part holds one rendezvous-hash partition of the snapshot's
``(level, sub_block)`` key universe (``repro_torch.io.placement``); the
manifest binds the parts into one logical snapshot.  It records, per
part, the file name, size, footer ``index_crc``, and — per level — the
*global* sub-block indices the part's payloads correspond to (in the
part's local file order).  The manifest body carries its own CRC32 so a
torn or hand-edited file fails loudly, and the recorded per-part
``index_crc`` values bind the exact part bytes: a part republished
without its manifest (or vice versa) is detected at open time.

Publishing is two-phase: every part is *finalized* at ``<name>.tmp``
(index, footer, fsync) first; only when all of them succeeded are they
renamed into place, and the manifest is written last.  A crash or
worker failure at any point before the rename loop leaves
``part-*.tacz.tmp`` litter and the *old* snapshot — manifest and part
files — fully intact; a manifest never names parts that do not check
out.  ``stale_parts`` enumerates the litter; a re-run of the writer
cleans it up and converges to a valid snapshot.

Byte-level spec: ``docs/tacz_format.md`` §9.  The port writes the same
bytes as the reference's ``repro.io.manifest`` for the same body, so
both packages publish, validate and probe each other's snapshots.
"""
from __future__ import annotations

import json
import os
import re
import zlib

__all__ = ["MANIFEST_MAGIC", "MANIFEST_NAME", "MANIFEST_VERSION",
           "is_multipart", "load", "manifest_crc", "part_name",
           "probe_crc", "stale_parts", "write_atomic"]

MANIFEST_NAME = "manifest.json"
MANIFEST_MAGIC = "TACZM"
MANIFEST_VERSION = 1

#: Part files are named ``part-NNNN.tacz`` (zero-padded decimal index).
_PART_RE = re.compile(r"^part-(\d{4,})\.tacz$")
_TMP_RE = re.compile(r"^part-(\d{4,})\.tacz\.tmp$")


def part_name(i: int) -> str:
    """Canonical file name of part ``i`` (``part-0000.tacz`` for 0)."""
    if i < 0:
        raise ValueError("part index must be non-negative")
    return f"part-{i:04d}.tacz"


def part_stem(i: int) -> str:
    """Part name without the ``.tacz`` suffix — the id the partition's
    rendezvous hashing scores (and a part-aligned shard would use)."""
    return part_name(i)[:-len(".tacz")]


def canonical_bytes(body: dict) -> bytes:
    """The byte form the manifest CRC covers: JSON with sorted keys and
    ``(",", ":")`` separators, UTF-8 — byte-stable across writers."""
    return json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def manifest_crc(body: dict) -> int:
    """CRC32 of :func:`canonical_bytes` over ``body`` (sans ``crc32``)."""
    body = {k: v for k, v in body.items() if k != "crc32"}
    return zlib.crc32(canonical_bytes(body)) & 0xFFFFFFFF


def _manifest_path(path: str) -> str:
    """Resolve a snapshot directory or direct manifest path."""
    if os.path.basename(path) == MANIFEST_NAME:
        return path
    return os.path.join(path, MANIFEST_NAME)


def write_atomic(snapshot_dir: str, body: dict) -> str:
    """Stamp ``crc32`` into ``body`` and publish it atomically.

    Written to ``manifest.json.tmp``, fsynced, then moved into place via
    ``os.replace`` — the manifest is the snapshot's commit point, so a
    crash before the replace leaves the previous snapshot (or nothing)
    fully intact.

    :param snapshot_dir: the snapshot directory.
    :param body: manifest body (``crc32`` is overwritten).
    :returns: the manifest path.
    """
    body = dict(body)
    body["crc32"] = manifest_crc(body)
    path = _manifest_path(snapshot_dir)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(body, f, sort_keys=True, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load(path: str) -> dict:
    """Read and validate a manifest (magic, version, CRC).

    :param path: snapshot directory or manifest file path.
    :returns: the manifest dict (``crc32`` verified).
    :raises ValueError: on bad magic, an unsupported version, a CRC
        mismatch, or malformed JSON.
    :raises OSError: if the file cannot be read.
    """
    mpath = _manifest_path(path)
    with open(mpath, encoding="utf-8") as f:
        try:
            body = json.load(f)
        except json.JSONDecodeError as exc:
            raise ValueError(f"corrupt multi-part manifest {mpath}: "
                             f"{exc}") from exc
    if not isinstance(body, dict) or body.get("magic") != MANIFEST_MAGIC:
        raise ValueError(f"not a TACZ multi-part manifest: {mpath}")
    if int(body.get("version", 0)) > MANIFEST_VERSION:
        raise ValueError(
            f"unsupported manifest version {body.get('version')}")
    if int(body.get("crc32", -1)) != manifest_crc(body):
        raise ValueError(f"corrupt multi-part manifest {mpath}: "
                         f"CRC mismatch")
    return body


def is_multipart(path) -> bool:
    """True when ``path`` is a multi-part snapshot directory (or its
    manifest file) — the dispatch test ``open_snapshot`` uses."""
    if not isinstance(path, (str, os.PathLike)):
        return False
    path = os.fspath(path)
    if os.path.isdir(path):
        return os.path.exists(os.path.join(path, MANIFEST_NAME))
    return os.path.basename(path) == MANIFEST_NAME and os.path.exists(path)


def probe_crc(path) -> int | None:
    """The manifest CRC of a multi-part snapshot, or None.

    The multi-part analogue of
    :func:`repro_torch.io.reader.probe_index_crc`
    — one small JSON read, used by the serving layer's per-request
    hot-swap check.  Returns None when the manifest is missing, torn,
    or fails validation (a half-published state is never adopted).
    """
    try:
        return int(load(os.fspath(path))["crc32"])
    except (OSError, ValueError, KeyError, TypeError):
        return None


def stale_parts(snapshot_dir: str) -> list[str]:
    """Leftover ``part-*.tacz.tmp`` files from a crashed/killed writer.

    A published snapshot never references them (the manifest is written
    last); the parallel writer truncates and replaces them on a re-run.

    :param snapshot_dir: the snapshot directory.
    :returns: sorted tmp file names (not paths); empty when clean.
    """
    try:
        names = os.listdir(snapshot_dir)
    except OSError:
        return []
    return sorted(n for n in names if _TMP_RE.match(n))


def referenced_parts(body: dict) -> list[str]:
    """Part file names a manifest binds, in part order."""
    return [str(p["name"]) for p in body.get("parts", [])]
