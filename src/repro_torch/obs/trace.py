"""``repro_torch.obs.trace`` — nested per-stage timing spans + request IDs.

A :class:`Span` is a named stopwatch that can hold child spans; the
``trace(name)`` helper opens a child of whatever span is active on the
*current thread* — so instrumented library code (the decode planner, the
writer's encode stage) never needs a span handle threaded through its
signature.  When no root span is active, ``trace()`` hands back a shared
no-op object whose ``__enter__``/``__exit__`` do nothing — the disabled
cost is one thread-local attribute read.

The span stack is thread-local on purpose: worker threads (the router's
scatter-gather pool, the parallel writer's encoder threads) do not
inherit the caller's root span.  Code that fans out collects child
summaries explicitly — e.g. ``ShardedRegionRouter`` opens one root per
batch, runs each shard group under its own root *in the pool thread*,
and grafts the finished summaries back into the batch root.

Request IDs (:func:`new_request_id`) are 16 hex chars from
``os.urandom`` — unique enough to grep a fleet's access logs, cheap
enough to mint per batch.  They ride the :data:`REQUEST_ID_HEADER`
HTTP header from router to shards.
"""
from __future__ import annotations

import os
import threading
import time

__all__ = ["Span", "trace", "root_span", "current_span",
           "new_request_id", "REQUEST_ID_HEADER"]

#: HTTP header carrying the request ID from router to shard (and echoed
#: back in every response).
REQUEST_ID_HEADER = "X-Repro-Request-Id"

_local = threading.local()


def new_request_id() -> str:
    """A 16-hex-char ID for correlating one batch across the fleet."""
    return os.urandom(8).hex()


class Span:
    """One named, timed region with optional nested children.

    Use as a context manager.  ``duration`` is in seconds and is only
    meaningful after ``__exit__``.  ``summary()`` flattens the finished
    tree into a JSON-friendly dict suitable for response metadata.
    """

    __slots__ = ("name", "t0", "duration", "children", "meta", "_parent")

    def __init__(self, name: str):
        self.name = name
        self.t0 = 0.0
        self.duration = 0.0
        self.children: list["Span"] = []
        self.meta: dict = {}
        self._parent: "Span | None" = None

    def __enter__(self) -> "Span":
        parent = getattr(_local, "span", None)
        if parent is not None:
            parent.children.append(self)
        self._parent = parent
        _local.span = self
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.duration = time.perf_counter() - self.t0
        # spans nest strictly on one thread, so the saved parent is the
        # span that was active at __enter__
        _local.span = self._parent

    def add_child(self, child: "Span") -> None:
        """Graft a finished span (e.g. from a pool thread) under this one."""
        self.children.append(child)

    def summary(self) -> dict:
        """The finished tree as ``{name, ms, [meta], [stages]}``."""
        out: dict = {"name": self.name,
                     "ms": round(self.duration * 1000.0, 3)}
        if self.meta:
            out.update(self.meta)
        if self.children:
            out["stages"] = [c.summary() for c in self.children]
        return out


class _NullSpan:
    """Shared do-nothing span handed out when tracing is inactive."""

    __slots__ = ()
    name = ""
    duration = 0.0
    children: list = []
    meta: dict = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def add_child(self, child) -> None:
        pass

    def summary(self) -> dict:
        return {}


_NULL = _NullSpan()


class _RootCtx:
    """Context manager installing ``span`` as this thread's root."""

    __slots__ = ("span", "_saved_span", "_saved_root")

    def __init__(self, span: Span):
        self.span = span

    def __enter__(self) -> Span:
        self._saved_span = getattr(_local, "span", None)
        self._saved_root = getattr(_local, "root", None)
        _local.root = self.span
        _local.span = self.span
        self.span.t0 = time.perf_counter()
        return self.span

    def __exit__(self, *exc) -> None:
        self.span.duration = time.perf_counter() - self.span.t0
        _local.span = self._saved_span
        _local.root = self._saved_root


def root_span(name: str) -> _RootCtx:
    """Open a *root* span on this thread: every ``trace()`` call made
    below it (on the same thread) attaches to its tree.  Used by the
    HTTP handler per request and the router per batch."""
    return _RootCtx(Span(name))


def trace(name: str):
    """A child span of the active span on this thread — or a shared
    no-op when no root is active (the common, uninstrumented case)."""
    if getattr(_local, "span", None) is None:
        return _NULL
    return Span(name)


def current_span() -> Span | None:
    """The innermost active span on this thread, if any."""
    return getattr(_local, "span", None)
