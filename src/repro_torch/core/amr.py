"""AMR data model and synthetic Nyx-like dataset generator.

The paper (§II-B/II-C, Table I) works on tree-based patch AMR data from
AMReX (Nyx / WarpX / IAMR): each refinement level is a regular 3D grid at
its own resolution, and every spatial point's value lives at *exactly one*
level (tree-based, no cross-level redundancy — redundant patch copies are
discarded before compression, §II-C).

We reproduce that data model exactly:

  * ``AMRLevel``    — one refinement level: a dense 3D array at the level's
    resolution plus a boolean validity mask (True where the point is stored
    at this level).  Levels are kept finest-first; ``ratio`` is the
    coarsening ratio relative to the finest grid (1, 2, 4, ...).
  * ``AMRDataset``  — an ordered list of levels with the tiling invariant:
    the union of the levels' masks, upsampled to the finest resolution,
    covers the domain exactly once.

The synthetic generator mimics a Nyx baryon-density field: a Gaussian
random field with a power-law spectrum, exponentiated to a lognormal field
(dense "halos" on a smooth background), then refined block-wise by value —
exactly the refinement criterion sketched in the paper's Fig. 1 ("refine a
block when its maximum value is larger than a threshold").  Per-level
densities (Table I) are matched by quantile selection of refinement
blocks, so we can generate e.g. a z10-like (23% fine / 77% coarse) or a
Run2_T4-like (0.003% fine) dataset on demand.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "AMRLevel",
    "AMRDataset",
    "gaussian_random_field",
    "synthetic_amr",
    "uniform_resolution",
    "NYX_LIKE_PRESETS",
]


@dataclass
class AMRLevel:
    """One refinement level of a tree-based AMR dataset."""

    data: np.ndarray            # (nx, ny, nz) float32; 0 where mask is False
    mask: np.ndarray            # (nx, ny, nz) bool; True = stored at this level
    ratio: int                  # coarsening ratio vs. the finest grid (1, 2, 4, ..)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def n_valid(self) -> int:
        return int(self.mask.sum())

    @property
    def density(self) -> float:
        """Fraction of the *domain volume* stored at this level (Table I)."""
        covered = self.n_valid * self.ratio ** 3
        finest_cells = int(np.prod([s * self.ratio for s in self.data.shape]))
        return covered / finest_cells

    def valid_values(self) -> np.ndarray:
        return self.data[self.mask]


@dataclass
class AMRDataset:
    """Tree-based AMR dataset: finest level first."""

    levels: list[AMRLevel]
    name: str = "amr"

    @property
    def finest_shape(self) -> tuple[int, ...]:
        return self.levels[0].shape

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def total_values(self) -> int:
        """Number of stored values (= what the simulation writes to disk)."""
        return sum(l.n_valid for l in self.levels)

    def original_size_bits(self, dtype_bits: int = 32) -> int:
        return self.total_values() * dtype_bits

    def densities(self) -> list[float]:
        return [l.density for l in self.levels]

    def check_tiling(self) -> bool:
        """Tiling invariant: every finest-resolution cell stored exactly once."""
        cover = np.zeros(self.finest_shape, dtype=np.int32)
        for l in self.levels:
            up = np.repeat(
                np.repeat(np.repeat(l.mask, l.ratio, 0), l.ratio, 1), l.ratio, 2
            ).astype(np.int32)
            cover += up
        return bool((cover == 1).all())


def gaussian_random_field(shape: tuple[int, int, int], *, beta: float = 3.0,
                          smooth_sigma: float = 1.2,
                          seed: int = 0) -> np.ndarray:
    """Gaussian random field with isotropic power spectrum P(k) ~ k^-beta.

    This is the standard way to mock a cosmological density field: matter
    power spectra fall off as a power law over the scales we test
    (paper §IV-B, Metric 5).  ``smooth_sigma`` applies a Gaussian
    band-limit (in cells): simulation output is *resolved* at the grid
    scale (viscosity/pressure damp Nyquist-scale power), and without this
    cutoff a synthetic field is noise-dominated at the grid scale, which
    inverts the paper's central premise that high-dimensional prediction
    beats 1D prediction.
    """
    rng = np.random.default_rng(seed)
    white = rng.standard_normal(shape).astype(np.float64)
    fw = np.fft.rfftn(white)
    kx = np.fft.fftfreq(shape[0])[:, None, None]
    ky = np.fft.fftfreq(shape[1])[None, :, None]
    kz = np.fft.rfftfreq(shape[2])[None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    k2[0, 0, 0] = 1.0  # keep the DC mode finite
    amp = k2 ** (-beta / 4.0)  # sqrt of P(k) = k^-beta (k^2)^(−beta/4)
    amp[0, 0, 0] = 0.0
    if smooth_sigma > 0:
        # Gaussian low-pass in k-space (cells → radians/cell)
        amp = amp * np.exp(-2.0 * (np.pi * smooth_sigma) ** 2 * k2)
    field = np.fft.irfftn(fw * amp, s=shape, axes=(0, 1, 2))
    field /= field.std() + 1e-30
    return field.astype(np.float64)


def _assign_levels_by_quantile(interest: np.ndarray,
                               densities: list[float]) -> np.ndarray:
    """Assign each refinement block to a level (0=finest) by interest quantile.

    ``densities`` is the target fraction of domain volume per level,
    finest-first, summing to 1.  The most "interesting" blocks (largest
    values — the refinement criterion of Fig. 1) go to the finest level.
    """
    flat = interest.ravel()
    order = np.argsort(-flat, kind="stable")  # descending interest
    n = flat.size
    level_of_block = np.empty(n, dtype=np.int32)
    start = 0
    for lvl, frac in enumerate(densities):
        cnt = int(round(frac * n))
        if lvl == len(densities) - 1:
            cnt = n - start
        level_of_block[order[start:start + cnt]] = lvl
        start += cnt
    return level_of_block.reshape(interest.shape)


def synthetic_amr(finest_shape: tuple[int, int, int] = (64, 64, 64), *,
                  densities: list[float] | None = None,
                  refine_block: int = 8,
                  beta: float = 3.0,
                  smooth_sigma: float = 1.2,
                  lognormal_sigma: float = 1.8,
                  seed: int = 0,
                  name: str = "synthetic") -> AMRDataset:
    """Generate a Nyx-like tree-based AMR dataset.

    Parameters
    ----------
    finest_shape : resolution of the finest level.
    densities    : target fraction of the domain stored per level,
                   finest-first (must sum to ~1).  Default 2-level 23/77
                   (= Nyx Run1_Z10 in Table I).
    refine_block : refinement granularity in finest cells (AMReX
                   ``blocking_factor``).  Must be divisible by every
                   level's ratio.
    lognormal_sigma : contrast of the lognormal transform (bigger = spikier
                   halos = lower natural density at the finest level).
    """
    if densities is None:
        densities = [0.23, 0.77]
    n_levels = len(densities)
    ratios = [2 ** i for i in range(n_levels)]
    for s in finest_shape:
        if s % refine_block:
            raise ValueError(f"finest shape {finest_shape} not divisible by "
                             f"refine_block {refine_block}")
    if refine_block % ratios[-1]:
        raise ValueError(f"refine_block {refine_block} must be divisible by "
                         f"the coarsest ratio {ratios[-1]}")
    total = float(sum(densities))
    densities = [d / total for d in densities]

    g = gaussian_random_field(finest_shape, beta=beta,
                              smooth_sigma=smooth_sigma, seed=seed)
    field = np.exp(lognormal_sigma * g).astype(np.float64)
    # Normalize mean to 1 (density contrast convention; halo finder uses
    # multiples of the mean, paper Metric 6).
    field /= field.mean()
    field = field.astype(np.float32)

    # Block-wise interest = max value in the refinement block (Fig. 1).
    rb = refine_block
    bshape = tuple(s // rb for s in finest_shape)
    blocks = field.reshape(bshape[0], rb, bshape[1], rb, bshape[2], rb)
    interest = blocks.max(axis=(1, 3, 5))
    level_of_block = _assign_levels_by_quantile(interest, densities)

    levels: list[AMRLevel] = []
    for lvl, ratio in enumerate(ratios):
        lshape = tuple(s // ratio for s in finest_shape)
        # Average-pool the finest field down to this level's resolution —
        # the value an AMR code would carry on its coarse grid.
        pooled = field.reshape(lshape[0], ratio, lshape[1], ratio,
                               lshape[2], ratio).mean(axis=(1, 3, 5))
        # Mask: blocks assigned to this level, expanded to level cells.
        sel = (level_of_block == lvl)
        cells_per_block = rb // ratio
        mask = np.repeat(np.repeat(np.repeat(sel, cells_per_block, 0),
                                   cells_per_block, 1), cells_per_block, 2)
        data = np.where(mask, pooled, 0.0).astype(np.float32)
        levels.append(AMRLevel(data=data, mask=mask, ratio=ratio))
    ds = AMRDataset(levels=levels, name=name)
    assert ds.check_tiling(), "synthetic AMR violated the tiling invariant"
    return ds


def uniform_resolution(ds: AMRDataset) -> np.ndarray:
    """Up-sample every level to the finest resolution and combine (Fig. 2).

    This is the representation post-analysis runs on (power spectrum, halo
    finder) and the input of the 3D baseline compressor.  A numpy array,
    as the dataset is.
    """
    out = np.zeros(ds.finest_shape, dtype=np.float32)
    for l in ds.levels:
        up = np.repeat(np.repeat(np.repeat(l.data, l.ratio, 0), l.ratio, 1),
                       l.ratio, 2)
        upm = np.repeat(np.repeat(np.repeat(l.mask, l.ratio, 0), l.ratio, 1),
                        l.ratio, 2)
        out = np.where(upm, up, out)
    return out


# Table I datasets re-scaled to laptop-size grids: same level structure and
# per-level densities as the paper, smaller resolutions.
NYX_LIKE_PRESETS: dict[str, dict] = {
    # name                  finest     densities (fine→coarse)        sigma
    "run1_z10": dict(finest_shape=(64, 64, 64), densities=[0.23, 0.77],
                     lognormal_sigma=1.8, seed=10),
    "run1_z5": dict(finest_shape=(64, 64, 64), densities=[0.58, 0.42],
                    lognormal_sigma=1.4, seed=5),
    "run1_z2": dict(finest_shape=(64, 64, 64), densities=[0.63, 0.37],
                    lognormal_sigma=1.2, seed=2),
    "run2_t3": dict(finest_shape=(64, 64, 64),
                    densities=[0.0202, 0.0556, 0.9242],
                    lognormal_sigma=2.6, seed=3),
    "run2_t4": dict(finest_shape=(128, 128, 128),
                    densities=[0.004, 0.02, 0.022, 0.954],
                    lognormal_sigma=3.0, seed=4, refine_block=16),
    "run3_z1": dict(finest_shape=(64, 64, 64),
                    densities=[0.009, 0.147, 0.844],
                    lognormal_sigma=2.4, seed=1),
    "warpx_800": dict(finest_shape=(32, 32, 128), densities=[0.086, 0.914],
                      lognormal_sigma=2.2, seed=800, refine_block=8),
    "warpx_1600": dict(finest_shape=(32, 32, 128), densities=[0.02, 0.98],
                       lognormal_sigma=2.6, seed=1600, refine_block=8),
    "iamr_90": dict(finest_shape=(64, 64, 64),
                    densities=[0.006, 0.105, 0.889],
                    lognormal_sigma=2.5, seed=90),
    "iamr_150": dict(finest_shape=(64, 64, 64),
                     densities=[0.148, 0.309, 0.543],
                     lognormal_sigma=1.6, seed=150),
}


def load_preset(name: str) -> AMRDataset:
    if name not in NYX_LIKE_PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(NYX_LIKE_PRESETS)}")
    kw = dict(NYX_LIKE_PRESETS[name])
    return synthetic_amr(name=name, **kw)
