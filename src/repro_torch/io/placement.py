"""Rendezvous (highest-random-weight) placement of sub-block keys.

The single hash rule that both sides of the multi-host pipeline share:

  * the **write side** (the multi-part writer, not yet ported)
    partitions each level's ``(level, sub_block)`` keys over the part
    files of a multi-part snapshot, and
  * the **serving side** (``repro_torch.serving.sharded.ShardMap``)
    places the same keys onto shard servers.

Keeping the scoring function here — below both of them — is what lets a
deployment align shards with parts: a ``ShardMap`` built from a
multi-part manifest's ``partition`` config owns exactly the keys its
part file holds, so a shard never needs another part's payload bytes.

Every key scores each shard with a keyed 64-bit BLAKE2b of
``(seed, level, sub_block, shard_id)`` and is owned by the highest
score (ties broken by shard id).  The scheme is a pure function of
``(shards, seed, key)``: independent of shard-list order, process,
platform, and ``PYTHONHASHSEED``, and minimal under resizing (adding a
shard only moves keys onto it; removing one only moves the keys it
owned).
"""
from __future__ import annotations

import hashlib
import struct

__all__ = ["ALGORITHM", "owner", "score"]

#: Config-file identifier of this placement scheme.  Serialized shard
#: maps and multi-part manifests both record it; loaders must reject any
#: other value instead of silently placing keys elsewhere.
ALGORITHM = "rendezvous-blake2b64"


def score(seed: int, key: tuple[int, int], shard: str) -> int:
    """HRW score of ``shard`` for one ``(level, sub_block)`` key.

    :param seed: placement salt; changing it reshuffles every key.
    :param key: ``(level_index, sub_block_index)`` —
        ``repro_torch.io.reader.WHOLE_LEVEL`` (-1) for single-payload levels.
    :param shard: shard (or part) identifier.
    :returns: an unsigned 64-bit score.
    """
    h = hashlib.blake2b(digest_size=8)
    h.update(struct.pack("<qqq", int(seed), int(key[0]), int(key[1])))
    h.update(shard.encode("utf-8"))
    return int.from_bytes(h.digest(), "little")


def owner(shards, seed: int, key: tuple[int, int]) -> str:
    """The highest-scoring shard for ``key`` (ties broken by shard id).

    :param shards: candidate shard identifiers (non-empty).
    :param seed: placement salt.
    :param key: ``(level_index, sub_block_index)``.
    :returns: the owning shard id.
    """
    return max(shards, key=lambda s: (score(seed, key, s), s))
