"""Rate–distortion frontier data model and the optional ``TACF`` section.

A ``.tacz`` file may carry a frontier — the per-level error-bound vectors
an autotuner probed, with their sizes and measured metrics — as a framed
``TACF`` section between the index and the footer.  The footer locates
only the index, so readers that predate the section skip it; this reader
parses the gap and reports a damaged section as ``frontier_error``
instead of failing.  This module holds the data model and the section
framing; target selection and the tuner are not yet ported.
"""
from __future__ import annotations

import json
import zlib
from dataclasses import dataclass, field
from struct import Struct

__all__ = ["FRONTIER_MAGIC", "FRONTIER_VERSION", "Frontier",
           "FrontierPoint", "SECTION_HEAD_SIZE", "pack_section",
           "parse_section"]

FRONTIER_MAGIC = b"TACF"
FRONTIER_VERSION = 1

#: Section framing: magic, version (u16), flags (u16, reserved), body
#: length (u32), body CRC32 (u32); the body is canonical JSON
#: (sorted keys, ``(",", ":")`` separators, UTF-8).
_SECTION_HEAD = Struct("<4sHHII")
SECTION_HEAD_SIZE = _SECTION_HEAD.size


@dataclass
class FrontierPoint:
    """One rate–distortion point: a per-level eb vector, the encoded
    size it produced, and the application metrics measured from the
    decoded snapshot."""

    ebs: tuple[float, ...]          # per-level error bounds, finest first
    bits: int                       # total encoded bits at these ebs
    metrics: dict                   # {"psnr": ..., "max_abs_error": ...}

    def to_dict(self) -> dict:
        return {"ebs": [float(e) for e in self.ebs],
                "bits": int(self.bits),
                "metrics": {str(k): float(v)
                            for k, v in sorted(self.metrics.items())}}

    @classmethod
    def from_dict(cls, d: dict) -> "FrontierPoint":
        return cls(ebs=tuple(float(e) for e in d["ebs"]),
                   bits=int(d["bits"]),
                   metrics={str(k): float(v)
                            for k, v in d["metrics"].items()})


@dataclass
class Frontier:
    """A recorded rate–distortion frontier.

    ``points`` are sorted by increasing ``bits``; ``default`` indexes
    the point the snapshot was actually written at (the one served when
    no distortion target is given).
    """

    metric: str                      # the metric the tuner optimized for
    points: list[FrontierPoint] = field(default_factory=list)
    default: int = 0

    def to_dict(self) -> dict:
        return {"magic": FRONTIER_MAGIC.decode(),
                "version": FRONTIER_VERSION,
                "metric": str(self.metric),
                "default": int(self.default),
                "points": [p.to_dict() for p in self.points]}

    @classmethod
    def from_dict(cls, d: dict) -> "Frontier":
        if d.get("magic") != FRONTIER_MAGIC.decode():
            raise ValueError("not a TACZ frontier body")
        if int(d.get("version", 0)) > FRONTIER_VERSION:
            raise ValueError(
                f"unsupported frontier version {d.get('version')}")
        points = [FrontierPoint.from_dict(p) for p in d.get("points", [])]
        default = int(d.get("default", 0))
        if points and not 0 <= default < len(points):
            raise ValueError("frontier default index out of range")
        return cls(metric=str(d.get("metric", "")), points=points,
                   default=default)

    @property
    def default_point(self) -> FrontierPoint | None:
        """The point the snapshot was written at, if any."""
        if not self.points:
            return None
        return self.points[self.default]


# ------------------------------ wire section -------------------------------


def pack_section(frontier: Frontier) -> bytes:
    """Frame a frontier as the ``TACF`` byte section (head + canonical
    JSON body, body CRC32 in the head)."""
    body = json.dumps(frontier.to_dict(), sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    head = _SECTION_HEAD.pack(FRONTIER_MAGIC, FRONTIER_VERSION, 0,
                              len(body), zlib.crc32(body) & 0xFFFFFFFF)
    return head + body


def parse_section(buf: bytes) -> Frontier:
    """Parse a ``TACF`` section (as written by :func:`pack_section`).

    :param buf: the bytes between index end and footer start; trailing
        bytes beyond the framed body are rejected.
    :raises ValueError: on bad magic, an unsupported version, a length
        mismatch, a body CRC mismatch, or a malformed body.
    """
    if len(buf) < SECTION_HEAD_SIZE:
        raise ValueError("frontier section truncated (no head)")
    magic, version, _flags, body_len, body_crc = _SECTION_HEAD.unpack(
        buf[:SECTION_HEAD_SIZE])
    if magic != FRONTIER_MAGIC:
        raise ValueError("bad frontier section magic")
    if version > FRONTIER_VERSION:
        raise ValueError(f"unsupported frontier section version {version}")
    body = buf[SECTION_HEAD_SIZE:SECTION_HEAD_SIZE + body_len]
    if len(body) != body_len or len(buf) != SECTION_HEAD_SIZE + body_len:
        raise ValueError("frontier section truncated or oversized")
    if zlib.crc32(body) & 0xFFFFFFFF != body_crc:
        raise ValueError("frontier section body CRC mismatch")
    try:
        d = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ValueError(f"malformed frontier body: {exc}") from exc
    return Frontier.from_dict(d)
