"""``repro_torch.obs.expo`` — parser for the Prometheus text exposition
(the port of ``repro.obs.expo``).

Every region endpoint serves a ``GET /v1/metrics`` scrape; this module
is the read side of that wire contract: :func:`parse` turns the
``text/plain; version=0.0.4`` body back into typed families and samples,
and :func:`to_snapshot` reduces the parsed form to exactly the shape
:meth:`repro_torch.obs.registry.MetricsRegistry.snapshot` produces — the
round trip ``to_snapshot(parse(reg.render())) == reg.snapshot()`` is
property-tested over metric names, label escaping edge cases, and
``+Inf`` buckets.

Design points:

  * **Typed, not stringly.**  A scrape becomes ``{name:``
    :class:`ParsedFamily```}``; counter/gauge series are floats keyed by
    their label pairs, histogram series are :class:`ParsedHistogram`
    objects that keep the bucket *bounds* (recovered from the ``le``
    labels) alongside de-cumulated per-bucket counts — which is what
    lets a fleet collector compute windowed quantiles from scrape
    deltas.
  * **Escaping round-trips.**  Label values (and help text) are
    unescaped with the inverse of the renderer's rules (``\\\\``,
    ``\\n``, ``\\"``), so a label value containing quotes, backslashes,
    or newlines survives scrape → parse intact.
  * **Lines end at ``\\n`` only.**  The renderer escapes only ``\\n``,
    so a label value may hold ``\\r``, ``\\x0b``, ``\\x0c``,
    ``\\x1c``–``\\x1e``, ``\\x85``, ``\\u2028`` or ``\\u2029`` raw;
    ``str.splitlines()`` breaks at each of them and would cut such a
    sample line in two (the reference's parser does).  This one splits
    on ``"\\n"`` and round-trips those values.
  * **Lenient where the spec is.**  Samples with no preceding ``# TYPE``
    line are collected as ``untyped``; unknown comment lines and blank
    lines are skipped; a malformed sample line raises ``ValueError``
    with the offending line (a truncated scrape should fail loudly, not
    silently drop series).

``RegionClient.metrics()`` returns this module's parsed form;
``RegionClient.metrics_text()`` keeps the raw body.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

__all__ = ["ParsedHistogram", "ParsedFamily", "parse", "to_snapshot"]

#: label pairs of one series, in exposition order — ``()`` for the
#: anonymous child of a label-less family
LabelPairs = tuple[tuple[str, str], ...]


@dataclass
class ParsedHistogram:
    """One histogram series reassembled from its ``_bucket``/``_sum``/
    ``_count`` sample lines.

    ``bounds`` are the finite ``le`` values in ascending order;
    ``counts`` are **non-cumulative** per-bucket counts with the +Inf
    overflow last (``len(counts) == len(bounds) + 1``) — the same layout
    :meth:`repro_torch.obs.registry.Histogram.snapshot` returns.
    """

    bounds: tuple[float, ...] = ()
    counts: list[int] = field(default_factory=list)
    sum: float = 0.0
    count: int = 0
    # builder state: cumulative counts keyed by le, folded in finalize()
    _cum: dict[float, int] = field(default_factory=dict, repr=False)

    def finalize(self) -> None:
        """De-cumulate the collected ``le`` buckets into ``counts``.

        :raises ValueError: if cumulative counts decrease with ``le``
            (a corrupt scrape) or the +Inf bucket is missing.
        """
        if math.inf not in self._cum:
            raise ValueError("histogram series has no +Inf bucket")
        finite = sorted(b for b in self._cum if not math.isinf(b))
        self.bounds = tuple(finite)
        counts, prev = [], 0
        for b in finite + [math.inf]:
            cum = self._cum[b]
            if cum < prev:
                raise ValueError(
                    f"histogram bucket counts decrease at le={b}")
            counts.append(cum - prev)
            prev = cum
        self.counts = counts
        self._cum.clear()

    def quantile(self, q: float) -> float | None:
        """Bucket-interpolated quantile (None with zero observations)."""
        from .registry import quantile_from_buckets
        return quantile_from_buckets(self.bounds, self.counts, q)


@dataclass
class ParsedFamily:
    """One metric family recovered from a scrape."""

    name: str
    kind: str = "untyped"
    help: str = ""
    #: label names in exposition order (first-seen sample; ``le`` never
    #: appears — it is folded into :class:`ParsedHistogram`)
    label_names: tuple[str, ...] = ()
    #: series keyed by their label pairs — floats for counters/gauges,
    #: :class:`ParsedHistogram` for histograms
    series: dict[LabelPairs, "float | ParsedHistogram"] = \
        field(default_factory=dict)

    def get(self, **labels) -> "float | ParsedHistogram | None":
        """The series matching exactly these labels, or None."""
        key = tuple((n, str(labels[n])) for n in self.label_names
                    if n in labels)
        if len(key) != len(labels):          # unknown label name given
            return None
        return self.series.get(key)


def _unescape(value: str) -> str:
    """Inverse of the renderer's label-value escaping."""
    if "\\" not in value:
        return value
    out, i, n = [], 0, len(value)
    while i < n:
        c = value[i]
        if c == "\\" and i + 1 < n:
            nxt = value[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt in ("\\", '"'):
                out.append(nxt)
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _parse_labels(text: str, line: str) -> list[tuple[str, str]]:
    """Parse the inside of one ``{...}`` label block."""
    pairs: list[tuple[str, str]] = []
    i, n = 0, len(text)
    while i < n:
        eq = text.find("=", i)
        if eq < 0 or eq + 1 >= n or text[eq + 1] != '"':
            raise ValueError(f"malformed label block in line {line!r}")
        name = text[i:eq].strip()
        # scan the quoted value, honoring backslash escapes
        j = eq + 2
        buf = []
        while j < n:
            c = text[j]
            if c == "\\" and j + 1 < n:
                buf.append(c)
                buf.append(text[j + 1])
                j += 2
                continue
            if c == '"':
                break
            buf.append(c)
            j += 1
        else:
            raise ValueError(f"unterminated label value in line {line!r}")
        pairs.append((name, _unescape("".join(buf))))
        i = j + 1
        if i < n and text[i] == ",":
            i += 1
    return pairs


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    return float(s)


def _split_sample(line: str) -> tuple[str, list[tuple[str, str]], float]:
    """One sample line → (name, label pairs, value)."""
    brace = line.find("{")
    if brace >= 0:
        close = line.rfind("}")
        if close < brace:
            raise ValueError(f"malformed sample line {line!r}")
        name = line[:brace]
        labels = _parse_labels(line[brace + 1:close], line)
        rest = line[close + 1:].strip()
    else:
        name, _, rest = line.partition(" ")
        labels = []
        rest = rest.strip()
    if not name or not rest:
        raise ValueError(f"malformed sample line {line!r}")
    # ignore an optional trailing timestamp (we never render one, but
    # other exporters may)
    value = rest.split()[0]
    return name, labels, _parse_value(value)


def parse(text: str) -> dict[str, ParsedFamily]:
    """Parse one exposition body into typed families.

    :param text: a ``text/plain; version=0.0.4`` scrape body (e.g. the
        return of :meth:`MetricsRegistry.render` or
        ``RegionClient.metrics_text()``).
    :returns: ``{family_name: ParsedFamily}`` in document order.
        Histogram families carry fully reassembled
        :class:`ParsedHistogram` series; a family declared by ``# TYPE``
        with no samples appears with empty ``series`` (a valid state —
        e.g. a catalog family before first traffic).
    :raises ValueError: on a malformed sample line, a histogram series
        missing its +Inf bucket, or decreasing cumulative buckets.
    """
    families: dict[str, ParsedFamily] = {}

    def family(name: str) -> ParsedFamily:
        fam = families.get(name)
        if fam is None:
            fam = families[name] = ParsedFamily(name)
        return fam

    # lines end at "\n" only: str.splitlines() would also break inside a
    # label value at the line separators the renderer leaves raw
    for raw in text.split("\n"):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)   # '#', kw, name, text...
            if len(parts) >= 3 and parts[1] == "HELP":
                family(parts[2]).help = _unescape(
                    parts[3] if len(parts) > 3 else "")
            elif len(parts) >= 4 and parts[1] == "TYPE":
                family(parts[2]).kind = parts[3]
            continue                      # other comments: skipped
        name, labels, value = _split_sample(line)

        # histogram sample names carry a suffix; resolve to the family
        # declared by # TYPE (falls back to the raw name → untyped).
        # An exact-name non-histogram family wins first, so a counter
        # that merely *ends* in _sum/_count next to a histogram with the
        # matching base name is never misattributed.
        base, suffix = name, ""
        exact = families.get(name)
        if exact is None or exact.kind == "histogram":
            for cand_suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(cand_suffix):
                    cand = name[:-len(cand_suffix)]
                    if families.get(cand) is not None \
                            and families[cand].kind == "histogram":
                        base, suffix = cand, cand_suffix
                        break
        fam = family(base)

        if fam.kind == "histogram" and suffix:
            pairs = tuple((n, v) for n, v in labels if n != "le")
            if not fam.label_names and pairs:
                fam.label_names = tuple(n for n, _ in pairs)
            h = fam.series.get(pairs)
            if h is None:
                h = fam.series[pairs] = ParsedHistogram()
            if suffix == "_bucket":
                le = next((v for n, v in labels if n == "le"), None)
                if le is None:
                    raise ValueError(
                        f"histogram bucket without le: {line!r}")
                h._cum[_parse_value(le)] = int(value)
            elif suffix == "_sum":
                h.sum = value
            else:
                h.count = int(value)
        else:
            pairs = tuple(labels)
            if not fam.label_names and pairs:
                fam.label_names = tuple(n for n, _ in pairs)
            fam.series[pairs] = value

    for fam in families.values():
        if fam.kind == "histogram":
            for h in fam.series.values():
                h.finalize()
    return families


def to_snapshot(families: dict[str, ParsedFamily]) -> dict:
    """Reduce parsed families to the exact
    :meth:`MetricsRegistry.snapshot` shape.

    ``to_snapshot(parse(reg.render())) == reg.snapshot()`` is the
    round-trip contract (property-tested): counters/gauges become
    floats, histograms become ``{"count", "sum", "buckets"}`` with
    non-cumulative bucket counts, and series keys use the snapshot's
    ``"k=v,k2=v2"`` (or ``"_"``) label encoding.
    """
    out: dict = {}
    for fam in families.values():
        series: dict = {}
        for pairs, v in fam.series.items():
            key = ",".join(f"{n}={val}" for n, val in pairs) or "_"
            if isinstance(v, ParsedHistogram):
                series[key] = {"count": v.count, "sum": v.sum,
                               "buckets": list(v.counts)}
            else:
                series[key] = v
        out[fam.name] = {"type": fam.kind, "help": fam.help,
                         "series": series}
    return out
