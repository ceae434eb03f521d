"""Per-level adaptive error bounds (paper §IV-F).

Level-wise compression lets TAC/TAC+ give every AMR level its own error
bound — impossible for the 3D baseline, where upsampling flattens all
levels into one field.  The paper derives the fine:coarse ratio in three
steps:

  1. Start from the post-analysis metric's ideal ratio on the
     uniform-resolution data — 1:1 for the (global) power spectrum, 1:2 for
     the halo finder (fine level carries the halo candidates).
  2. Multiply the coarse level's bound down by the upsampling rate (2³ per
     level step): coarse-level errors are replicated 8× in post-analysis.
  3. Temper toward the rate-distortion sweet spot (Fig. 29: at large eb the
     fine level's bit-rate stops falling, so trade fine-level error back).
     The paper lands at 3:1 (power spectrum) and 2:1 (halo finder) for a
     2-level, ratio-8 dataset; the tempering exponent that reproduces those
     numbers is extrapolated to deeper hierarchies.

Pure host arithmetic; the bounds equal the reference's
(``repro.core.adaptive_eb``) float for float.
"""
from __future__ import annotations

import numpy as np

__all__ = ["level_error_bounds", "PAPER_RATIOS"]

# tempering exponents calibrated to the paper's landed ratios for a
# 2-level dataset: (8 * start)^alpha == landed
#   power_spectrum: start 1,  landed 3  →  alpha = ln3/ln8  ≈ 0.528
#   halo_finder:    start 1/2, landed 2 →  alpha = ln2/ln4  = 0.5
_ALPHA = {"power_spectrum": float(np.log(3) / np.log(8)),
          "halo_finder": 0.5,
          "generic": 0.5}
_START = {"power_spectrum": 1.0, "halo_finder": 0.5, "generic": 1.0}

PAPER_RATIOS = {"power_spectrum": 3.0, "halo_finder": 2.0}


def level_error_bounds(base_eb: float, n_levels: int, *,
                       metric: str = "power_spectrum",
                       upsample_rate: int = 8) -> list[float]:
    """Error bound per level (finest first).

    ``base_eb`` is the finest level's bound; each coarser level gets
    ``base_eb / ratio_step`` where the per-step ratio is the tempered
    ``(upsample_rate * start)^alpha`` of the paper's §IV-F recipe.
    """
    alpha = _ALPHA.get(metric, _ALPHA["generic"])
    start = _START.get(metric, 1.0)
    step = (upsample_rate * start) ** alpha
    return [float(base_eb / step ** i) for i in range(n_levels)]
