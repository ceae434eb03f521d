"""``repro_torch.serving.sharded`` — the shard map of sharded region
serving.

:class:`ShardMap` places the ``(level, sub_block)`` key universe of a
snapshot onto named shards by rendezvous hashing (the rule of
:mod:`repro_torch.io.placement`).  It is what a shard-filtered
:class:`~repro_torch.serving.regions.RegionServer` (``shard_map=``,
``shard_id=``), its :meth:`~repro_torch.serving.regions.RegionServer.
reshard` and its cache-import filter range over.  The scatter-gather
router, which needs the HTTP client, is not yet ported.
"""
from __future__ import annotations

import json

from ..io import placement
from .regions import CacheKey

__all__ = ["ShardMap"]


class ShardMap:
    """Deterministic rendezvous-hash placement of sub-block keys.

    Every ``(level, sub_block)`` key scores each shard with a keyed
    64-bit BLAKE2b of ``(seed, level, sub_block, shard_id)`` and is owned
    by the highest score.  Rendezvous hashing gives the two properties a
    serving fleet needs when resizing:

      * adding a shard moves only the keys whose new highest score is the
        added shard (~``1/(N+1)`` of them) — no key moves between two
        pre-existing shards;
      * removing a shard moves only the keys it owned.

    Ownership is a pure function of ``(shards, seed, key)``: it does not
    depend on shard-list order, process, platform, or ``PYTHONHASHSEED``,
    so a router and its shard servers agree as long as they were built
    from the same serialized config (:meth:`to_json`/:meth:`from_json`).

    The scoring function itself lives in :mod:`repro_torch.io.placement`:
    the same rule the reference's multi-part writer partitions part files
    with, so a map built from a multi-part manifest's ``partition``
    config assigns each shard exactly the keys its part file holds.

    :param shards: shard identifiers (non-empty unique strings) — usually
        the names the deployment uses to look up endpoints.
    :param seed: placement salt; changing it reshuffles every key.
    :raises ValueError: on an empty/duplicate shard list or empty ids.
    """

    _ALGORITHM = placement.ALGORITHM

    def __init__(self, shards, *, seed: int = 0):
        shards = [str(s) for s in shards]
        if not shards:
            raise ValueError("ShardMap needs at least one shard")
        if any(not s for s in shards):
            raise ValueError("shard ids must be non-empty strings")
        if len(set(shards)) != len(shards):
            raise ValueError(f"duplicate shard ids in {shards!r}")
        self.shards: tuple[str, ...] = tuple(sorted(shards))
        self.seed = int(seed)

    # ------------------------------ placement ------------------------------

    def _score(self, shard: str, key: CacheKey) -> int:
        return placement.score(self.seed, key, shard)

    def owner(self, key: CacheKey) -> str:
        """The shard owning one ``(level, sub_block)`` key.

        :param key: ``(level_index, sub_block_index)``;
            ``sub_block_index`` is :data:`~repro_torch.io.reader.WHOLE_LEVEL`
            for single-payload levels.
        :returns: the owning shard id.
        """
        return placement.owner(self.shards, self.seed, key)

    def partition(self, keys) -> dict[str, list[CacheKey]]:
        """Group keys by owner.

        :param keys: iterable of ``(level, sub_block)`` keys.
        :returns: ``{shard_id: [keys it owns]}`` — only shards owning at
            least one key appear.
        """
        out: dict[str, list[CacheKey]] = {}
        for key in keys:
            out.setdefault(self.owner(key), []).append(key)
        return out

    # ------------------------------ resizing -------------------------------

    def with_shard(self, shard_id: str) -> "ShardMap":
        """A new map with ``shard_id`` added (same seed).

        :raises ValueError: if the shard already exists.
        """
        return ShardMap(self.shards + (str(shard_id),), seed=self.seed)

    def without_shard(self, shard_id: str) -> "ShardMap":
        """A new map with ``shard_id`` removed (same seed).

        :raises ValueError: if the shard is unknown, or it was the last.
        """
        if str(shard_id) not in self.shards:
            raise ValueError(f"unknown shard {shard_id!r}")
        return ShardMap([s for s in self.shards if s != str(shard_id)],
                        seed=self.seed)

    def grow(self, shard_id: str, keys,
             ) -> tuple["ShardMap", list[CacheKey]]:
        """The map with ``shard_id`` added, plus exactly which of
        ``keys`` change owner — the live-resharding work list.

        Rendezvous hashing guarantees every moved key's *new* owner is
        the added shard (no key moves between two pre-existing shards),
        and only ~``1/(N+1)`` of the keys move at all.  The moved list
        drives the cache handoff: each moved key's old owner exports its
        decoded brick, the new shard imports it, and the fleet serves
        warm through the transition.

        :param shard_id: the shard to add.
        :param keys: the key universe to diff ownership over (normally
            ``reader.subblock_keys()``).
        :returns: ``(new_map, moved_keys)``.
        :raises ValueError: if the shard already exists.
        """
        new = self.with_shard(shard_id)
        moved = [k for k in keys if self.owner(k) != new.owner(k)]
        return new, moved

    # ---------------------------- serialization ----------------------------

    def to_dict(self) -> dict:
        """JSON-safe config; :meth:`from_dict` rebuilds an equal map."""
        return {"algorithm": self._ALGORITHM, "seed": self.seed,
                "shards": list(self.shards)}

    @classmethod
    def from_dict(cls, d: dict) -> "ShardMap":
        """Inverse of :meth:`to_dict`.

        :raises ValueError: if the config names a different placement
            algorithm (a config from a future/incompatible version must
            fail loudly, not silently place keys elsewhere).
        """
        algo = d.get("algorithm", cls._ALGORITHM)
        if algo != cls._ALGORITHM:
            raise ValueError(f"unsupported shard-map algorithm {algo!r}")
        return cls(d["shards"], seed=int(d.get("seed", 0)))

    def to_json(self) -> str:
        """Canonical JSON form of :meth:`to_dict` (stable key order)."""
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ShardMap":
        """Inverse of :meth:`to_json`."""
        return cls.from_dict(json.loads(s))

    # ------------------------------- dunder --------------------------------

    def __len__(self) -> int:
        return len(self.shards)

    def __eq__(self, other) -> bool:
        return (isinstance(other, ShardMap) and self.shards == other.shards
                and self.seed == other.seed)

    def __hash__(self) -> int:
        return hash((self.shards, self.seed))

    def __repr__(self) -> str:
        return f"ShardMap(shards={list(self.shards)!r}, seed={self.seed})"
