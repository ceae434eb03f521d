"""``repro_torch.tuning`` — error-bound autotuning and variant-set
production on the device (the port of ``repro.tuning``).

The closed loop the paper's §IV-F recipe implies but never automates:
search per-level error bounds for the fewest encoded bits that meet an
application-metric distortion target (PSNR, max abs error, power-
spectrum error), record the probed rate–distortion frontier into the
snapshot (``repro_torch.io.frontier``), and — via
:func:`write_variant_set` — publish multi-variant snapshot sets the
serving layer answers distortion-target requests from
(``repro_torch.serving.variants``).

See ``docs/tuning.md`` for the loop, the frontier section spec, and the
distortion-target wire API.
"""
from .autotune import (AutoTuner, TuneResult, measure_metrics,
                       write_variant_set)

__all__ = ["AutoTuner", "TuneResult", "measure_metrics",
           "write_variant_set"]
