"""Statistical ops on tensors: verification metrics, histograms, region
averages (port of ``fv3net_tpu/ops/statistics.py``; reference:
external/vcm/vcm/calc/metrics.py, vcm/calc/histogram.py, vcm/select.py).

Counts and bin sums are scatter-adds (``index_add_`` / ``scatter_add_``)
on the data's device; ratios of counts are float64.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _reduce(fn, x, axis):
    return fn(x) if axis is None else fn(x, dim=axis)


def mean_squared_error(truth, pred, axis=None, weights=None):
    err = (truth - pred) ** 2
    if weights is not None:
        return (_reduce(torch.sum, err * weights, axis)
                / _reduce(torch.sum, torch.broadcast_to(weights, err.shape),
                          axis))
    return _reduce(torch.mean, err, axis)


def root_mean_squared_error(truth, pred, axis=None, weights=None):
    return torch.sqrt(mean_squared_error(truth, pred, axis, weights))


def bias(truth, pred, axis=None, weights=None):
    diff = pred - truth
    if weights is not None:
        return (_reduce(torch.sum, diff * weights, axis)
                / _reduce(torch.sum, torch.broadcast_to(weights, diff.shape),
                          axis))
    return _reduce(torch.mean, diff, axis)


def r2_score(truth, pred, axis=None):
    """1 - MSE/Var."""
    mse = _reduce(torch.mean, (truth - pred) ** 2, axis)
    var = (torch.var(truth, correction=0) if axis is None
           else torch.var(truth, dim=axis, correction=0))
    return 1.0 - mse / var


def accuracy(truth, pred, axis=None):
    return _reduce(torch.mean, (truth == pred).to(torch.float64), axis)


def _count(x, axis):
    return _reduce(torch.sum, x.to(torch.float64), axis)


def precision(truth, pred, axis=None):
    tp = _count(truth & pred, axis)
    fp = _count(~truth & pred, axis)
    return tp / (tp + fp)


def recall(truth, pred, axis=None):
    tp = _count(truth & pred, axis)
    fn = _count(truth & ~pred, axis)
    return tp / (tp + fn)


true_positive_rate = recall


def false_positive_rate(truth, pred, axis=None):
    fp = _count(~truth & pred, axis)
    tn = _count(~truth & ~pred, axis)
    return fp / (fp + tn)


def f1_score(truth, pred, axis=None):
    p = precision(truth, pred, axis)
    r = recall(truth, pred, axis)
    return 2 * p * r / (p + r)


def weighted_mean(field, weights, axis=None):
    w = torch.broadcast_to(torch.as_tensor(weights, device=field.device),
                           field.shape)
    return _reduce(torch.sum, field * w, axis) / _reduce(torch.sum, w, axis)


def weighted_average(field, weights, axis=None):
    """Weighted mean with NaN weights treated as zero."""
    w = torch.nan_to_num(torch.as_tensor(weights, device=field.device),
                         nan=0.0)
    return weighted_mean(field, w, axis=axis)


def local_time(hours_utc, lon_deg):
    """Fractional local solar hour-of-day from UTC hours and longitude:
    (hour + lon/15) mod 24."""
    return torch.remainder(torch.as_tensor(hours_utc)
                           + torch.as_tensor(lon_deg) / 15.0, 24.0)


def _bins(bins, field):
    return torch.as_tensor(bins, dtype=field.dtype,
                           device=field.device).contiguous()


def _bucket(bins, values, n):
    """Index of the bin of each value, clipped to [0, n - 1]."""
    return (torch.searchsorted(bins, values.contiguous(), right=True)
            - 1).clamp(0, n - 1)


def histogram(field, bins) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counts and bin edges; values outside [bins[0], bins[-1]] are not
    counted."""
    bins = _bins(bins, field)
    flat = field.reshape(-1)
    idx = _bucket(bins, flat, len(bins) - 1)
    inside = (flat >= bins[0]) & (flat <= bins[-1])
    counts = torch.zeros(len(bins) - 1, dtype=torch.int32,
                         device=field.device).scatter_add_(
        0, idx, inside.to(torch.int32))
    return counts, bins


def histogram2d(x, y, bins_x,
                bins_y) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Joint counts over two fields: ``(counts[nx, ny], bins_x, bins_y)``;
    a pair outside either range is not counted."""
    bins_x, bins_y = _bins(bins_x, x), _bins(bins_y, y)
    nx, ny = len(bins_x) - 1, len(bins_y) - 1
    xf, yf = x.reshape(-1), y.reshape(-1)
    ix, iy = _bucket(bins_x, xf, nx), _bucket(bins_y, yf, ny)
    inside = ((xf >= bins_x[0]) & (xf <= bins_x[-1])
              & (yf >= bins_y[0]) & (yf <= bins_y[-1]))
    counts = torch.zeros(nx * ny, dtype=torch.int32,
                         device=x.device).scatter_add_(
        0, ix * ny + iy, inside.to(torch.int32))
    return counts.reshape(nx, ny), bins_x, bins_y


class RegionOfInterest:
    """Area-weighted average over a lat/lon box.  Longitudes are
    normalized to [0, 360)."""

    def __init__(self, lat_bounds, lon_bounds):
        self.lat_bounds = tuple(lat_bounds)
        self.lon_bounds = tuple(lon_bounds)

    def mask(self, lat_deg, lon_deg):
        lat = torch.as_tensor(lat_deg)
        lon = torch.remainder(torch.as_tensor(lon_deg), 360.0)
        lo0, lo1 = (b % 360.0 for b in self.lon_bounds)
        in_lat = (lat > self.lat_bounds[0]) & (lat < self.lat_bounds[1])
        if lo0 <= lo1:
            in_lon = (lon > lo0) & (lon < lo1)
        else:  # box crossing the 0-meridian
            in_lon = (lon > lo0) | (lon < lo1)
        return in_lat & in_lon

    def average(self, field, lat_deg, lon_deg, area, axis=None):
        w = torch.as_tensor(area) * self.mask(lat_deg, lon_deg)
        return weighted_mean(field, w, axis=axis)


# approximate zonal/meridional averages (reference vcm/select.py:18-79)


def _bin_average(field, coord_deg, bins_deg, weights):
    """Average ``field`` within coordinate bins over the trailing axes
    that ``coord_deg`` spans: field (..., *spatial), coord and weights
    broadcastable to the spatial axes; returns (..., n_bins)."""
    coord = torch.as_tensor(coord_deg, dtype=field.dtype, device=field.device)
    bins = _bins(bins_deg, field)
    nb = len(bins) - 1
    idx = _bucket(bins, coord.reshape(-1), nb)
    inside = ((coord >= bins[0]) & (coord < bins[-1])).reshape(-1)
    w = torch.broadcast_to(torch.as_tensor(weights, dtype=field.dtype,
                                           device=field.device),
                           coord.shape).reshape(-1) * inside
    lead = field.shape[: field.ndim - coord.ndim]
    f = field.reshape(lead + (-1,))
    num = torch.zeros(lead + (nb,), dtype=f.dtype,
                      device=f.device).index_add_(-1, idx, f * w)
    den = torch.zeros(nb, dtype=f.dtype, device=f.device).index_add_(0, idx,
                                                                      w)
    return num / den


def zonal_average_approximate(
    field, lat_deg, area, bins_deg: Optional[np.ndarray] = None
):
    """Area-weighted average in latitude bins: field (..., tile, y, x),
    lat and area (tile, y, x).  Returns (..., n_bins) and the bin
    centers."""
    if bins_deg is None:
        bins_deg = np.arange(-90, 91, 2.0)
    out = _bin_average(field, lat_deg, bins_deg, area)
    centers = 0.5 * (np.asarray(bins_deg)[:-1] + np.asarray(bins_deg)[1:])
    return out, centers


def meridional_average_approximate(
    field, lon_deg, area, bins_deg: Optional[np.ndarray] = None
):
    """Area-weighted average in longitude bins."""
    if bins_deg is None:
        bins_deg = np.arange(0, 361, 2.0)
    lon = torch.remainder(torch.as_tensor(lon_deg), 360.0)
    out = _bin_average(field, lon, bins_deg, area)
    centers = 0.5 * (np.asarray(bins_deg)[:-1] + np.asarray(bins_deg)[1:])
    return out, centers


def mask_to_surface_type(field, land_sea_mask, surface_type: str):
    """NaN outside the requested surface type: 'land' (mask==1), 'sea'
    (mask==0), 'seaice' (mask==2) or 'global'."""
    if surface_type == "global":
        return field
    value = {"land": 1, "sea": 0, "seaice": 2}[surface_type]
    keep = torch.abs(land_sea_mask - value) < 0.5
    return torch.where(keep, field, torch.nan)
