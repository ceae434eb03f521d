"""Evaluation metrics (paper §IV-B) on the device.

Metric 2  PSNR                           — over the stored AMR values.
Metric 5  matter power spectrum P(k)     — radially-binned |FFT|² of the
          uniform-resolution field; pass criterion: max relative error
          below a tolerance for k < k_max (paper: 1 %, near-lossless 0.01 %).
Metric 6  halo finder                    — threshold (81.66 × mean mass by
          default, [48]) + 6-connected components + minimum cell count;
          compares mass / cell counts of the largest halos.

Each function works on the device of its tensor input; a numpy input goes
to ``device=``.  The numbers are the reference's (``repro.core.metrics``):

* :func:`psnr` and :func:`amr_psnr` return numpy's float exactly: the
  squared differences are summed in numpy's order
  (:func:`repro_torch.core.sz._numpy_sum`) and the logarithms are taken
  on the host;
* :func:`reconstruct_uniform` is exact (repeats and a select);
* :func:`power_spectrum` takes ``torch.fft.rfftn`` in float64, which
  cannot match pocketfft bit for bit (a few ulps a bin), and bins in a
  fixed order: a stable sort of the bin indices, made once a shape, then
  sums along rows.  Atomic adds (``bincount(weights=)``, ``index_add_``)
  would change the last bits from run to run on the card;
* :func:`halo_finder` runs ``scipy.ndimage`` on the host, as the
  reference does.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch
from scipy import ndimage

from ..device import resolve_device
from .amr import AMRDataset
from .hybrid import AMRCompressionResult
from .sz import _numpy_sum

__all__ = ["psnr", "amr_psnr", "power_spectrum", "power_spectrum_error",
           "Halo", "halo_finder", "halo_diff", "reconstruct_uniform"]


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        resolve_device(device))


def psnr(orig, recon, *, device: str | torch.device = "cuda") -> float:
    """PSNR of ``recon`` against ``orig`` over every value, in dB (inf
    when they are equal).  ``recon`` goes to ``orig``'s device."""
    orig = _tensor(orig, device).double().reshape(-1)
    recon = _tensor(recon, orig.device).to(orig.device).double().reshape(-1)
    rng = float(orig.max() - orig.min())
    mse = _numpy_sum((orig - recon) ** 2) / orig.numel()
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(rng) - 10.0 * np.log10(mse))


def _stored(ds: AMRDataset, arrays, device: torch.device) -> torch.Tensor:
    """Every level's values at its mask, finest level first, each level in
    the mask's C order (numpy's ``a[mask]``)."""
    return torch.cat([
        _tensor(a, device)[torch.from_numpy(l.mask).to(device)]
        for l, a in zip(ds.levels, arrays)])


def amr_psnr(ds: AMRDataset, result: AMRCompressionResult) -> float:
    """PSNR over every *stored* value of the dataset (all levels), on the
    device of ``result``'s reconstructions."""
    device = result.levels[0].recon.device
    orig = _stored(ds, [l.data for l in ds.levels], device)
    rec = _stored(ds, [r.recon for r in result.levels], device)
    return psnr(orig, rec)


def _upsample(a: torch.Tensor, r: int) -> torch.Tensor:
    if r == 1:
        return a
    return (a.repeat_interleave(r, 0).repeat_interleave(r, 1)
            .repeat_interleave(r, 2))


def _uniform(ds: AMRDataset, arrays, device: torch.device
             ) -> torch.Tensor:
    """Every level's array up-sampled to the finest grid and combined by
    the masks, on ``device`` (``uniform_resolution``'s values)."""
    out = torch.zeros(ds.finest_shape, dtype=torch.float32, device=device)
    for lvl, a in zip(ds.levels, arrays):
        r = lvl.ratio
        um = _upsample(torch.from_numpy(lvl.mask).to(device), r)
        out = torch.where(um, _upsample(_tensor(a, device).to(device), r),
                          out)
    return out


def reconstruct_uniform(ds: AMRDataset, result: AMRCompressionResult
                        ) -> torch.Tensor:
    """Uniform-resolution reconstruction for post-analysis (Fig. 2 right),
    a float32 tensor on the device of ``result``'s reconstructions."""
    return _uniform(ds, [r.recon for r in result.levels],
                    result.levels[0].recon.device)


# ----------------------------- power spectrum ------------------------------


@dataclass
class _Binning:
    """Fixed-order radial binning of one rfft shape: bins 1..n_bins laid
    out as rows of ``width`` values (a bin's values in C order, padded
    with zeros), summed along rows, then the row sums of each bin along a
    second padded matrix."""

    src: torch.Tensor        # flat rfft positions of bins 1..n_bins
    dest: torch.Tensor       # their slots in the (rows, width) matrix
    rows: int
    width: int
    row_dest: torch.Tensor   # each row's slot in the (n_bins, depth) matrix
    depth: int
    counts: torch.Tensor     # values a bin, float64 (n_bins,)


_BINNINGS: dict = {}
_BINNINGS_LOCK = threading.Lock()
_ROW_WIDTH = 4096


def _binning(shape: tuple[int, int, int], n_bins: int,
             device: torch.device) -> _Binning:
    key = (shape, n_bins, str(device))
    with _BINNINGS_LOCK:
        b = _BINNINGS.get(key)
    if b is not None:
        return b
    # kmag as numpy builds it: fftfreq · n is not always an integer, so
    # the frequencies come from numpy and the square root runs in float64
    kx = np.fft.fftfreq(shape[0]) * shape[0]
    ky = np.fft.fftfreq(shape[1]) * shape[1]
    kz = np.fft.rfftfreq(shape[2]) * shape[2]
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    kmag = torch.sqrt(t(kx)[:, None, None] ** 2 + t(ky)[None, :, None] ** 2
                      + t(kz)[None, None, :] ** 2)
    bins = t(np.arange(0.5, n_bins + 0.5))
    # np.digitize(x, bins) (right=False) is bucketize(right=True)
    which = torch.bucketize(kmag.reshape(-1), bins, right=True)
    del kmag
    order = torch.argsort(which, stable=True)
    sorted_bins = which[order]
    counts = torch.bincount(which, minlength=n_bins + 1)
    starts = torch.cumsum(counts, 0) - counts
    keep = (sorted_bins >= 1) & (sorted_bins <= n_bins)
    src = order[keep]
    bin_of = sorted_bins[keep]
    rank = torch.arange(order.numel(), device=device)[keep] - starts[bin_of]
    w = _ROW_WIDTH
    cnt = counts[1:n_bins + 1]
    rows_per_bin = (cnt + w - 1) // w
    row_start = torch.cumsum(rows_per_bin, 0) - rows_per_bin
    row = row_start[bin_of - 1] + rank // w
    dest = row * w + rank % w
    rows = int(rows_per_bin.sum())
    depth = max(int(rows_per_bin.max()), 1) if n_bins else 1
    row_bin = torch.repeat_interleave(
        torch.arange(n_bins, device=device), rows_per_bin)
    row_rank = torch.arange(rows, device=device) - row_start[row_bin]
    b = _Binning(src=src, dest=dest, rows=rows, width=w,
                 row_dest=row_bin * depth + row_rank, depth=depth,
                 counts=cnt.double())
    with _BINNINGS_LOCK:
        _BINNINGS[key] = b
    return b


def power_spectrum(field, n_bins: int | None = None, *,
                   device: str | torch.device = "cuda"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Isotropic P(k): radial average of |FFT|² (Metric 5), as float64
    tensors ``(k, pk)`` on the field's device.  The same field gives the
    same floats on every call."""
    field = _tensor(field, device).double()
    n = field.shape[0]
    fk = torch.fft.rfftn(field) / field.numel()
    p3 = (fk.abs() ** 2).reshape(-1)
    del fk
    n_bins = n_bins or n // 2
    b = _binning(tuple(field.shape), n_bins, field.device)
    buf = torch.zeros(b.rows * b.width, dtype=torch.float64,
                      device=field.device)
    buf[b.dest] = p3[b.src]
    del p3
    part = buf.view(b.rows, b.width).sum(dim=1)
    mat = torch.zeros(n_bins * b.depth, dtype=torch.float64,
                      device=field.device)
    mat[b.row_dest] = part
    sums = mat.view(n_bins, b.depth).sum(dim=1)
    k = torch.arange(1, n_bins + 1, dtype=torch.float64, device=field.device)
    return k, sums / torch.clamp(b.counts, min=1.0)


def power_spectrum_error(orig_field, recon_field,
                         k_max: float | None = None, *,
                         device: str | torch.device = "cuda"
                         ) -> torch.Tensor:
    """Per-bin relative P(k) error |p'/p − 1| for k < k_max (paper: k<10)."""
    k, p = power_spectrum(orig_field, device=device)
    _, pr = power_spectrum(recon_field, device=device)
    return _ps_error(k, p, pr, k_max)


def _ps_error(k: torch.Tensor, p: torch.Tensor, pr: torch.Tensor,
              k_max: float | None) -> torch.Tensor:
    if k_max is not None:
        sel = k < k_max
        p, pr = p[sel], pr[sel]
    return torch.abs(pr / torch.clamp(p, min=1e-300) - 1.0)


# ------------------------------- halo finder --------------------------------


@dataclass
class Halo:
    mass: float
    n_cells: int
    position: tuple[float, float, float]


def halo_finder(field, *, threshold_factor: float = 81.66,
                min_cells: int = 8) -> list[Halo]:
    """FoF-like over-density finder (Metric 6, [48]), on the host.

    Candidate cells have value > threshold_factor × mean; candidates are
    grouped by 6-connectivity; groups below ``min_cells`` are dropped.
    Returns halos sorted by decreasing mass.  A tensor comes to the host
    once.
    """
    if isinstance(field, torch.Tensor):
        field = field.detach().cpu().numpy()
    field = np.asarray(field, dtype=np.float64)
    thr = threshold_factor * field.mean()
    cand = field > thr
    structure = ndimage.generate_binary_structure(3, 1)  # 6-connectivity
    labels, n = ndimage.label(cand, structure=structure)
    halos: list[Halo] = []
    if n == 0:
        return halos
    counts = np.bincount(labels.ravel())
    masses = np.bincount(labels.ravel(), weights=field.ravel())
    coms = ndimage.center_of_mass(field, labels, index=range(1, n + 1))
    for i in range(1, n + 1):
        if counts[i] >= min_cells:
            halos.append(Halo(mass=float(masses[i]), n_cells=int(counts[i]),
                              position=tuple(float(c) for c in coms[i - 1])))
    halos.sort(key=lambda h: -h.mass)
    return halos


def halo_diff(orig: list[Halo], recon: list[Halo], top: int = 3
              ) -> tuple[float, float]:
    """(avg relative mass diff, avg relative cell-count diff) over the
    ``top`` largest original halos matched by position (Table II)."""
    if not orig:
        return 0.0, 0.0
    mass_d, cell_d, n = 0.0, 0.0, 0
    for h in orig[:top]:
        if not recon:
            mass_d += 1.0
            cell_d += 1.0
            n += 1
            continue
        # match to the nearest reconstructed halo
        d = [sum((a - b) ** 2 for a, b in zip(h.position, r.position))
             for r in recon]
        m = recon[int(np.argmin(d))]
        mass_d += abs(m.mass - h.mass) / abs(h.mass)
        cell_d += abs(m.n_cells - h.n_cells) / max(h.n_cells, 1)
        n += 1
    return mass_d / n, cell_d / n
