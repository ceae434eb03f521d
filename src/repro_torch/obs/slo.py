"""``repro_torch.obs.slo`` — a declarative SLO rule engine over the
fleet collector (the port of ``repro.obs.slo``).

An :class:`SLORule` states an objective the fleet must hold — ``p99 of
tacz_server_request_seconds < 50 ms``, ``error rate < 0.1 %``,
``cache hit ratio > 0.8`` — as data, not code: a *rule kind* (one of
:data:`RULE_TYPES`, the reference's rule kinds), a comparison, a
threshold, and a ``for``-duration.  An :class:`SLOEngine` evaluates the
rules against a :class:`~repro_torch.obs.collect.FleetCollector` and
runs the Prometheus-style alert state machine per rule:

    ``ok`` → (violating) → ``pending`` → (still violating after
    ``for_seconds``) → ``firing`` → (healthy again) → ``resolved``
    (one evaluation) → ``ok``

Two properties matter operationally:

  * **No data is not a transition.**  A rule whose value evaluates to
    None (no scrapes yet, empty window, just-started shard) keeps its
    current state — a fleet coming up must not flap pending/resolved
    before first traffic.
  * **Windowed, so firing rules can resolve.**  Latency rules read
    *windowed* histogram deltas from the collector, not lifetime
    histograms — once recent traffic is fast again, the p99 the rule
    sees recovers, and the rule walks back through ``resolved`` to
    ``ok``.  (A lifetime quantile never forgets one slow burst.)

Firing state is exported back into the process registry as gauges
(``tacz_slo_firing``/``tacz_slo_state``/``tacz_slo_value``, labeled by
rule name) so the alert plane is itself scrapable, and
:meth:`SLOEngine.report` renders the human-readable fleet verdict the
load-generator benchmark prints.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from . import metrics as obsm

__all__ = ["RULE_TYPES", "SLORule", "RuleState", "SLOEngine",
           "STATE_CODES"]

#: rule kind → one-line contract (the docs rule table mirrors this)
RULE_TYPES: dict[str, str] = {}
_EVALUATORS: dict[str, "callable"] = {}

#: alert states in escalation order, with the numeric codes
#: ``tacz_slo_state`` exports (0=ok 1=pending 2=firing 3=resolved)
STATE_CODES = {"ok": 0, "pending": 1, "firing": 2, "resolved": 3}

_OPS = {
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
}


def _rule_type(name: str, doc: str):
    def deco(fn):
        RULE_TYPES[name] = doc
        _EVALUATORS[name] = fn
        return fn
    return deco


# ----------------------------- evaluators ---------------------------------
# Each evaluator maps (collector, rule) -> float | None.  None means "no
# data in the window" and never drives a state transition.

@_rule_type("quantile",
            "windowed fleet quantile of a histogram metric "
            "(params: metric, q, window, labels)")
def _eval_quantile(collector, rule):
    p = rule.params
    return collector.quantile(p["metric"], p.get("q", 0.99),
                              p.get("labels"), window=p.get("window"))


@_rule_type("quantile_ratio",
            "ratio of two windowed quantiles of one histogram, e.g. "
            "p99/p50 tail spread (params: metric, q_hi, q_lo, window)")
def _eval_quantile_ratio(collector, rule):
    p = rule.params
    h = collector.histogram_delta(p["metric"], p.get("labels"),
                                  window=p.get("window"))
    if h is None or h.count == 0:
        return None
    hi = h.quantile(p.get("q_hi", 0.99))
    lo = h.quantile(p.get("q_lo", 0.50))
    if hi is None or lo is None or lo <= 0:
        return None
    return hi / lo


@_rule_type("rate",
            "windowed fleet-summed per-second counter rate "
            "(params: metric, window, labels)")
def _eval_rate(collector, rule):
    p = rule.params
    return collector.counter_rate(p["metric"], p.get("labels"),
                                  window=p.get("window"))


@_rule_type("ratio",
            "windowed delta share a/(a+b) of two monotonic series, e.g. "
            "cache hit ratio from hits/misses (params: metric_a, "
            "metric_b, window)")
def _eval_ratio(collector, rule):
    p = rule.params
    a = collector.counter_delta(p["metric_a"], p.get("labels_a"),
                                window=p.get("window"))
    b = collector.counter_delta(p["metric_b"], p.get("labels_b"),
                                window=p.get("window"))
    if a is None or b is None or a + b <= 0:
        return None
    return a / (a + b)


@_rule_type("error_rate",
            "windowed share of a labeled counter's increments whose "
            "label value falls outside the ok set, e.g. non-2xx HTTP "
            "(params: metric, label, ok_prefixes, window)")
def _eval_error_rate(collector, rule):
    p = rule.params
    metric = p.get("metric", "tacz_http_requests_total")
    label = p.get("label", "status")
    ok_prefixes = tuple(p.get("ok_prefixes", ("2",)))
    deltas = collector.counter_deltas_by_series(
        metric, window=p.get("window"))
    if deltas is None:
        return None
    total, bad = 0.0, 0.0
    for pairs, inc in deltas.items():
        value = dict(pairs).get(label, "")
        total += inc
        if not str(value).startswith(ok_prefixes):
            bad += inc
    if total <= 0:
        return None
    return bad / total


@_rule_type("gauge",
            "latest gauge value aggregated across up endpoints "
            "(params: metric, agg=max|min|sum, labels)")
def _eval_gauge(collector, rule):
    p = rule.params
    return collector.gauge(p["metric"], p.get("labels"),
                           agg=p.get("agg", "max"))


@_rule_type("up",
            "fraction of fleet endpoints currently up, from scrape "
            "success + /v1/health (params: none)")
def _eval_up(collector, rule):
    return collector.up_fraction()


# -------------------------------- rules -----------------------------------

@dataclass
class SLORule:
    """One declarative objective.

    :param name: unique rule name — the ``rule`` label on the exported
        ``tacz_slo_*`` gauges.
    :param kind: one of :data:`RULE_TYPES`.
    :param op: comparison the *healthy* fleet satisfies: ``"<"``,
        ``"<="``, ``">"``, ``">="`` (e.g. a latency rule is ``p99 <
        0.05`` — the rule *violates* when the comparison is false).
    :param threshold: right-hand side of the comparison.
    :param for_seconds: how long the rule must stay violating before
        ``pending`` escalates to ``firing`` (0 fires immediately).
    :param params: evaluator parameters (see each kind's line in
        :data:`RULE_TYPES`).
    """

    name: str
    kind: str
    op: str
    threshold: float
    for_seconds: float = 0.0
    params: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in RULE_TYPES:
            raise ValueError(
                f"unknown SLO rule kind {self.kind!r}; "
                f"known: {sorted(RULE_TYPES)}")
        if self.op not in _OPS:
            raise ValueError(f"unknown comparison {self.op!r}")

    def evaluate(self, collector) -> float | None:
        """This rule's current value against ``collector`` (no state)."""
        return _EVALUATORS[self.kind](collector, self)

    def satisfied(self, value: float | None) -> bool | None:
        """Whether ``value`` meets the objective (None with no data)."""
        if value is None:
            return None
        return _OPS[self.op](value, self.threshold)

    def describe(self) -> str:
        base = self.params.get("metric") or self.params.get("metric_a") \
            or self.kind
        return f"{self.kind}({base}) {self.op} {self.threshold:g}"


@dataclass
class RuleState:
    """Mutable alert state of one rule inside an engine."""

    rule: SLORule
    state: str = "ok"
    value: float | None = None
    pending_since: float | None = None
    last_transition: float | None = None
    ever_fired: bool = False
    evaluations: int = 0

    @property
    def satisfied(self) -> bool | None:
        return self.rule.satisfied(self.value)


class SLOEngine:
    """Evaluate a rule set against a fleet collector, tracking alert
    state and exporting it back into the metrics registry.

    :param collector: the :class:`~repro_torch.obs.collect.FleetCollector`
        rules read from.
    :param rules: the :class:`SLORule` objectives (names must be
        unique).
    :param clock: time source for ``for``-duration tracking (monotonic;
        injectable so tests can step it).
    :param export: when True (default), every evaluation writes
        ``tacz_slo_firing``/``tacz_slo_state``/``tacz_slo_value``
        gauges labeled by rule name into the process registry.
    """

    def __init__(self, collector, rules, *, clock=time.monotonic,
                 export: bool = True):
        rules = list(rules)
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO rule names in {names}")
        self.collector = collector
        self.states: dict[str, RuleState] = {
            r.name: RuleState(rule=r) for r in rules}
        self._clock = clock
        self._export = export

    @property
    def rules(self) -> list[SLORule]:
        return [s.rule for s in self.states.values()]

    # ------------------------------ stepping -------------------------------

    def evaluate(self) -> dict[str, RuleState]:
        """Evaluate every rule once and step its state machine.

        Transitions (per rule, in order):

        * value None → state unchanged (no data is not evidence);
        * violating: ``ok``/``resolved`` → ``pending`` (stamp
          ``pending_since``); ``pending`` → ``firing`` once
          ``for_seconds`` elapsed; ``firing`` stays;
        * healthy: ``pending`` → ``ok`` (a blip shorter than
          ``for_seconds`` never alerts); ``firing`` → ``resolved``
          (visible for exactly one evaluation); ``resolved`` → ``ok``.

        :returns: the engine's state map (live objects, not copies).
        """
        now = self._clock()
        for st in self.states.values():
            st.evaluations += 1
            value = st.rule.evaluate(self.collector)
            if value is not None:
                st.value = value
            ok = st.rule.satisfied(value)
            if ok is None:
                self._export_rule(st)
                continue
            if not ok:
                if st.state in ("ok", "resolved"):
                    st.state = "pending"
                    st.pending_since = now
                    st.last_transition = now
                elif st.state == "pending" and \
                        now - st.pending_since >= st.rule.for_seconds:
                    st.state = "firing"
                    st.ever_fired = True
                    st.last_transition = now
            else:
                if st.state == "pending":
                    st.state = "ok"
                    st.pending_since = None
                    st.last_transition = now
                elif st.state == "firing":
                    st.state = "resolved"
                    st.pending_since = None
                    st.last_transition = now
                elif st.state == "resolved":
                    st.state = "ok"
                    st.last_transition = now
            self._export_rule(st)
        return self.states

    def _export_rule(self, st: RuleState) -> None:
        if not self._export:
            return
        name = st.rule.name
        obsm.SLO_FIRING.labels(name).set(1.0 if st.state == "firing"
                                         else 0.0)
        obsm.SLO_STATE.labels(name).set(STATE_CODES[st.state])
        if st.value is not None:
            obsm.SLO_VALUE.labels(name).set(st.value)

    # ------------------------------ verdicts -------------------------------

    def firing(self) -> list[str]:
        """Names of rules currently firing."""
        return [n for n, s in self.states.items() if s.state == "firing"]

    def passed(self) -> bool:
        """True when every rule's latest value meets its objective and
        nothing is pending/firing — the bench's pinned-SLO gate."""
        for st in self.states.values():
            if st.state in ("pending", "firing"):
                return False
            if st.satisfied is False:
                return False
        return True

    def verdict(self) -> dict:
        """Machine-readable per-rule verdict (what the bench merges
        into ``bench_summary.json``)."""
        rules = {}
        for name, st in self.states.items():
            rules[name] = {
                "objective": st.rule.describe(),
                "kind": st.rule.kind,
                "value": st.value,
                "threshold": st.rule.threshold,
                "op": st.rule.op,
                "state": st.state,
                "satisfied": st.satisfied,
                "ever_fired": st.ever_fired,
                "evaluations": st.evaluations,
            }
        return {"passed": self.passed(), "rules": rules}

    def report(self) -> str:
        """Human-readable fleet report — one row per rule plus the
        endpoint up/down roll call."""
        lines = ["SLO fleet report", "================"]
        up = [n for n in self.collector.endpoints if self.collector.up(n)]
        down = [n for n in self.collector.endpoints if n not in up]
        lines.append(f"endpoints: {len(up)}/{len(self.collector.endpoints)}"
                     f" up" + (f" (down: {', '.join(down)})" if down
                               else ""))
        width = max((len(n) for n in self.states), default=4)
        for name, st in self.states.items():
            value = "n/a" if st.value is None else f"{st.value:.6g}"
            mark = {"ok": "PASS", "resolved": "PASS",
                    "pending": "WARN", "firing": "FAIL"}[st.state]
            lines.append(
                f"  [{mark}] {name:<{width}}  {st.rule.describe():<44}"
                f" value={value} state={st.state}")
        lines.append(f"overall: {'PASS' if self.passed() else 'FAIL'}")
        return "\n".join(lines)
