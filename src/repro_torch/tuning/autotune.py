"""Per-level error-bound autotuning against application metrics (paper
§IV-F taken from recipe to closed loop) on the device: the port of
``repro.tuning.autotune``.

``core/adaptive_eb`` gives the paper's *a-priori* fine:coarse eb ratios;
this module closes the loop: compress, measure the application metric on
the decoded snapshot, and search the per-level eb vector for the fewest
encoded bits that still meet a distortion target.  The search is
coordinate descent over a per-level log-spaced eb ladder with two memo
layers — per ``(level, eb)`` compression results (levels compress
independently, so moving one level's bound recompresses one level) and
per eb-vector metric evaluations — seeded at the adaptive-eb heuristic
vector.  Every evaluated point lands on the recorded rate–distortion
:class:`~repro_torch.io.frontier.Frontier` (Pareto-pruned), which the
writers embed in the snapshot and the serving layer answers
distortion-target requests from.  The search is the reference's step for
step, so the same dataset reaches the same bounds, bits, evaluation and
compression counts and frontier.

The memo keeps every probed :class:`~repro_torch.core.hybrid.LevelResult`
(recon and artifacts) on the tuner's device.  The metrics run there too
(:mod:`repro_torch.core.metrics`); the dataset's own uniform field and
power spectrum are computed once a tuner.

:func:`write_variant_set` is the one-shot producer for the serving
half: tune once per named target, write one snapshot per variant, and
publish the ``variants.json`` catalog (``repro_torch.io.variants``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from ..core import adaptive_eb, hybrid
from ..core import metrics as core_metrics
from ..core.amr import AMRDataset
from ..device import resolve_device
from ..io import frontier as frt
from ..io import variants as vrt
from ..io.parallel import write_multipart
from ..io.writer import write as write_tacz

__all__ = ["AutoTuner", "TuneResult", "measure_metrics",
           "write_variant_set"]

#: Map the target-grammar metric names onto the adaptive-eb heuristic's
#: seed ratios (the paper tunes power-spectrum and halo-finder runs;
#: uniform-field metrics share the power-spectrum recipe — both amplify
#: coarse-level errors by the upsampling rate; stored-value targets seed
#: from the generic recipe).
_SEED_METRIC = {"ps_error": "power_spectrum", "psnr_u": "power_spectrum",
                "psnr": "generic", "max_abs_error": "generic"}

#: Power-spectrum error is evaluated for k < k_max, the paper's pass
#: criterion range.
PS_K_MAX = 10.0


class _Original:
    """What every metric compares against, computed once a dataset and
    device: the stored values, the uniform field and its spectrum."""

    def __init__(self, ds: AMRDataset, device: torch.device):
        self.data = [torch.from_numpy(l.data).to(device) for l in ds.levels]
        self.mask = [torch.from_numpy(l.mask).to(device) for l in ds.levels]
        self.stored = torch.cat([d[m] for d, m in zip(self.data, self.mask)])
        # uniform_resolution's values, up-sampled on the device
        self.uniform = core_metrics._uniform(ds, self.data, device)
        self.k, self.pk = core_metrics.power_spectrum(self.uniform)


def _measure(ds: AMRDataset, result: hybrid.AMRCompressionResult,
             orig: _Original) -> dict:
    max_err = 0.0
    for lvl, lres, data, mask in zip(ds.levels, result.levels, orig.data,
                                     orig.mask):
        if lvl.mask.any():
            err = (lres.recon[mask] - data[mask]).abs().max()
            max_err = max(max_err, float(err))
    rec = torch.cat([r.recon[m] for r, m in zip(result.levels, orig.mask)])
    recon_u = core_metrics.reconstruct_uniform(ds, result)
    _, pr = core_metrics.power_spectrum(recon_u)
    ps = core_metrics._ps_error(orig.k, orig.pk, pr, PS_K_MAX)
    return {"psnr": core_metrics.psnr(orig.stored, rec),
            "psnr_u": core_metrics.psnr(orig.uniform, recon_u),
            "max_abs_error": max_err,
            "ps_error": float(ps.max()) if ps.numel() else 0.0}


def measure_metrics(ds: AMRDataset,
                    result: hybrid.AMRCompressionResult) -> dict:
    """All frontier metrics of a decoded snapshot, re-measured from its
    reconstruction on its device: ``psnr`` (over stored values),
    ``psnr_u`` (over the uniform-resolution reconstruction, where
    coarse-level errors weigh ``ratio³``×), ``max_abs_error`` (worst
    absolute error over stored values), and ``ps_error`` (max relative
    P(k) error for ``k < PS_K_MAX`` on the uniform field).  The same
    result gives the same floats on every call."""
    return _measure(ds, result,
                    _Original(ds, result.levels[0].recon.device))


@dataclass
class TuneResult:
    """Outcome of one :meth:`AutoTuner.tune` run."""

    target: frt.Target                  # the distortion target tuned for
    ebs: tuple[float, ...]              # chosen per-level bounds
    bits: int                           # encoded bits at the chosen ebs
    metrics: dict                       # measured metrics at the chosen ebs
    frontier: frt.Frontier              # every probed point, Pareto-pruned
    result: hybrid.AMRCompressionResult  # compressed at the chosen ebs
    evaluations: int                    # distinct eb vectors measured
    compressions: int                   # level compressions actually run


class AutoTuner:
    """Searches per-level error bounds for minimum bits at a target.

    One tuner instance amortizes its memo tables across :meth:`tune`
    calls — :func:`write_variant_set` tunes several targets against the
    same dataset through one tuner.

    :param ds: the AMR dataset to tune against.
    :param base_eb: the seed vector's finest-level absolute bound
        (default: ``1e-3`` of the finest level's value range).
    :param factor: ladder step — each candidate eb is ``factor×`` its
        neighbor (log-spaced grid).
    :param steps_down: ladder rungs tighter than the seed per level.
    :param steps_up: ladder rungs looser than the seed per level.
    :param device: where levels compress, the memo lives and metrics
        run (default ``"cuda"``).
    :param compress_kwargs: forwarded to ``hybrid.compress_level``
        (``algorithm``, ``she``, ``strategy``, ``entropy_engine``, ...).
    :raises RuntimeError: for ``device="cuda"`` without a card.
    """

    def __init__(self, ds: AMRDataset, *, base_eb: float | None = None,
                 factor: float = 2.0, steps_down: int = 6,
                 steps_up: int = 6, unit: int = 8,
                 device: str | torch.device = "cuda", **compress_kwargs):
        self.ds = ds
        self.device = resolve_device(device)
        if base_eb is None:
            fin = ds.levels[0].data
            base_eb = 1e-3 * float(fin.max() - fin.min())
        self.base_eb = float(base_eb)
        if factor <= 1.0:
            raise ValueError("ladder factor must be > 1")
        self.factor = float(factor)
        self.steps_down = int(steps_down)
        self.steps_up = int(steps_up)
        self.unit = int(unit)
        self.compress_kwargs = dict(compress_kwargs)
        # memo layers: (level, eb) -> LevelResult, ebs-tuple -> metrics
        self._level_memo: dict[tuple[int, float], hybrid.LevelResult] = {}
        self._metric_memo: dict[tuple[float, ...], dict] = {}
        self._orig: _Original | None = None
        self.compressions = 0

    # ----------------------------- plumbing --------------------------------

    def _ladder(self, seed_eb: float) -> list[float]:
        """Log-spaced candidate bounds for one level, tightest first."""
        return [seed_eb * self.factor ** k
                for k in range(-self.steps_down, self.steps_up + 1)]

    def _compress_level(self, li: int, eb: float) -> hybrid.LevelResult:
        key = (li, float(eb))
        if key not in self._level_memo:
            lvl = self.ds.levels[li]
            lvl_unit = max(2, self.unit // lvl.ratio)
            self._level_memo[key] = hybrid.compress_level(
                lvl.data, lvl.mask, eb=float(eb), unit=lvl_unit,
                ratio=lvl.ratio, keep_artifacts=True, device=self.device,
                **self.compress_kwargs)
            self.compressions += 1
        return self._level_memo[key]

    def result_at(self, ebs) -> hybrid.AMRCompressionResult:
        """The (memoized) compression result at a per-level eb vector."""
        levels = [self._compress_level(li, eb) for li, eb in enumerate(ebs)]
        algo = self.compress_kwargs.get("algorithm", "lor_reg")
        she = self.compress_kwargs.get("she", True)
        name = "tac+" if (she and algo == "lor_reg") else "tac"
        return hybrid.AMRCompressionResult(levels=levels,
                                           method=f"{name}/{algo}")

    def evaluate(self, ebs) -> tuple[int, dict]:
        """(total bits, measured metrics) at a per-level eb vector."""
        ebs = tuple(float(e) for e in ebs)
        res = self.result_at(ebs)
        if ebs not in self._metric_memo:
            if self._orig is None:
                self._orig = _Original(self.ds, self.device)
            self._metric_memo[ebs] = _measure(self.ds, res, self._orig)
        return res.total_bits, self._metric_memo[ebs]

    # ------------------------------- search --------------------------------

    def tune(self, target: frt.Target | str, *,
             max_passes: int = 4) -> TuneResult:
        """Coordinate descent for the fewest bits meeting ``target``.

        The search seeds at the ``adaptive_eb`` heuristic vector,
        tightens uniformly until the target holds (the ladder's tight
        end bounds the search), then runs per-level loosening passes:
        each pass walks every level's bound up its ladder as far as the
        target keeps holding (looser bound → fewer bits), repeating
        until a full pass changes nothing or ``max_passes`` is hit.

        :raises repro_torch.io.frontier.TargetUnsatisfiable: when even the
            tightest grid corner misses the target.
        """
        if isinstance(target, str):
            target = frt.parse_target(target)
        n = self.ds.n_levels
        seed = adaptive_eb.level_error_bounds(
            self.base_eb, n,
            metric=_SEED_METRIC.get(target.metric, "generic"))
        ladders = [self._ladder(e) for e in seed]
        pos = [self.steps_down] * n          # start at the seed rung
        probed: dict[tuple[int, ...], tuple[int, dict]] = {}

        def measure(p) -> tuple[int, dict]:
            key = tuple(p)
            if key not in probed:
                probed[key] = self.evaluate(
                    [ladders[li][k] for li, k in enumerate(key)])
            return probed[key]

        bits, mets = measure(pos)
        # phase 1: tighten uniformly until the target holds
        while not target.satisfies(mets) and any(k > 0 for k in pos):
            pos = [max(0, k - 1) for k in pos]
            bits, mets = measure(pos)
        if not target.satisfies(mets):
            raise frt.TargetUnsatisfiable(target, mets.get(target.metric))
        # phase 2: per-level loosening passes (coordinate descent)
        for _ in range(max_passes):
            changed = False
            for li in range(n):
                while pos[li] + 1 < len(ladders[li]):
                    trial = list(pos)
                    trial[li] += 1
                    tbits, tmets = measure(trial)
                    if not (target.satisfies(tmets) and tbits <= bits):
                        break
                    pos, bits, mets = trial, tbits, tmets
                    changed = True
            if not changed:
                break

        chosen = tuple(ladders[li][k] for li, k in enumerate(pos))
        frontier = self._build_frontier(target.metric, ladders, probed,
                                        tuple(pos))
        return TuneResult(target=target, ebs=chosen, bits=bits,
                          metrics=dict(mets), frontier=frontier,
                          result=self.result_at(chosen),
                          evaluations=len(probed),
                          compressions=self.compressions)

    def _build_frontier(self, metric: str, ladders, probed,
                        chosen: tuple[int, ...]) -> frt.Frontier:
        """Pareto-prune the probed points on (bits, metric) and keep the
        chosen point's index as the frontier default."""
        higher = frt.HIGHER_IS_BETTER.get(metric, False)
        pts = []
        for key, (bits, mets) in probed.items():
            ebs = tuple(ladders[li][k] for li, k in enumerate(key))
            pts.append((key, frt.FrontierPoint(ebs=ebs, bits=bits,
                                               metrics=dict(mets))))

        def dominated(a: frt.FrontierPoint) -> bool:
            va = a.metrics[metric]
            for _, b in pts:
                if b is a:
                    continue
                vb = b.metrics[metric]
                better = vb >= va if higher else vb <= va
                if b.bits <= a.bits and better and (
                        b.bits < a.bits
                        or (vb > va if higher else vb < va)):
                    return True
            return False

        kept = [(key, p) for key, p in pts
                if key == chosen or not dominated(p)]
        kept.sort(key=lambda kp: kp[1].bits)
        default = next(i for i, (key, _) in enumerate(kept)
                       if key == chosen)
        return frt.Frontier(metric=metric,
                            points=[p for _, p in kept], default=default)


def write_variant_set(path, ds: AMRDataset, targets: dict, *,
                      default: str | None = None, parts: int | None = None,
                      tuner: AutoTuner | None = None,
                      payload_codec: str = "auto",
                      device: str | torch.device = "cuda",
                      **tuner_kwargs) -> str:
    """Tune and write one snapshot per named distortion target, bound by
    a ``variants.json`` catalog (the serving layer's variant set).

    :param path: variant-set directory (created if missing).
    :param targets: ``{variant name: target spec}``, e.g.
        ``{"hi": "psnr>=70", "lo": "psnr>=50"}``.
    :param default: variant served when a request names no target
        (default: the first ``targets`` key).
    :param parts: write each variant multi-part with this part count
        (default: single-file ``.tacz`` per variant).
    :param tuner: a prepared :class:`AutoTuner` to reuse (its memo
        carries across targets); default builds one on ``device`` from
        ``tuner_kwargs``.
    :param device: the tuner's device when none is given (default
        ``"cuda"``); the snapshots are written on the tuner's device.
    :returns: the variant-set directory path.
    :raises repro_torch.io.frontier.TargetUnsatisfiable: if any target
        is out of the tuner's grid reach.
    """
    if not targets:
        raise ValueError("need at least one named target")
    names = list(targets)
    if default is None:
        default = names[0]
    if default not in targets:
        raise ValueError(f"default variant {default!r} not in targets")
    if tuner is None:
        tuner = AutoTuner(ds, device=device, **tuner_kwargs)
    path = os.fspath(path)
    os.makedirs(path, exist_ok=True)
    entries = []
    for name in names:
        tr = tuner.tune(targets[name])
        fname = f"{name}.taczd" if parts else f"{name}.tacz"
        dst = os.path.join(path, fname)
        if parts:
            write_multipart(dst, tr.result, parts=parts,
                            payload_codec=payload_codec,
                            frontier=tr.frontier, device=tuner.device)
        else:
            write_tacz(dst, tr.result, payload_codec=payload_codec,
                       frontier=tr.frontier, device=tuner.device)
        entries.append({"name": name, "file": fname,
                        "target": str(tr.target),
                        "ebs": [float(e) for e in tr.ebs],
                        "bits": int(tr.bits),
                        "metrics": {k: float(v)
                                    for k, v in sorted(tr.metrics.items())}})
    vrt.write_catalog(path, {"default": default, "variants": entries})
    return path
