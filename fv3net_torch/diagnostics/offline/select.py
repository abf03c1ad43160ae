"""Snapshot selection and meridional transects (port of
``fv3net_tpu/diagnostics/offline/select.py``; reference:
offline/_select.py): ``select_snapshot`` picks the nearest time;
``meridional_transect`` samples the cube along a constant-longitude
great-circle ring (vcm.select.meridional_ring +
vcm.interpolate_unstructured) for pressure-level cross-sections, on the
data's device through ``ops/regrid_latlon.interpolate_unstructured``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.diagnostics.transform import host, tensor
from fv3net_torch.ops.regrid_latlon import interpolate_unstructured


def select_snapshot(ds: Dataset, time: float) -> Dataset:
    """Nearest-time snapshot (reference _select.py:8-9); ``time`` in the
    run's time-coordinate units (hours)."""
    times = ds.coords.get("time")
    if times is None:
        idx = 0
    else:
        idx = int(np.argmin(np.abs(np.asarray(times, np.float64) - time)))
    out = ds.isel(time=idx)
    if times is not None:
        out.coords["time_snapshot"] = float(np.asarray(times)[idx])
        out.coords.pop("time", None)
    return out


def meridional_ring(lon: float = 0.0, n: int = 180) -> Dict[str, np.ndarray]:
    """Constant-longitude great-circle sample points (reference
    vcm/select.py meridional_ring)."""
    lat = np.linspace(-90.0, 90.0, n)
    return {"lat": lat, "lon": np.full(n, lon)}


def meridional_transect(
    ds: Dataset, grid: Dict[str, object], lon: float = 0.0, n: int = 180
) -> Dataset:
    """Sample every variable along the lon=const ring by nearest
    neighbor on the unit sphere (reference _select.py:12-14; the KDTree
    is the pairwise distances and an argmin,
    ``ops/regrid_latlon.interpolate_unstructured``, which picks the same
    cell on every device where cells tie), in float64."""
    ring = meridional_ring(lon, n)
    lat_g = np.deg2rad(np.asarray(host(grid["lat"]), np.float64))
    lon_g = np.deg2rad(np.asarray(host(grid["lon"]), np.float64))
    lat_t = np.deg2rad(ring["lat"])
    lon_t = np.deg2rad(ring["lon"])

    def _xyz(lat, lon):
        return (
            np.cos(lat) * np.cos(lon),
            np.cos(lat) * np.sin(lon),
            np.sin(lat),
        )

    src = _xyz(lat_g, lon_g)
    tgt = _xyz(lat_t, lon_t)

    out = {}
    for name, q in ds.items():
        if not {"tile", "y", "x"}.issubset(q.dims):
            continue
        arr = tensor(q.data, dtype=torch.float64)
        # move (tile, y, x) to the trailing axes in order
        order = [i for i, d in enumerate(q.dims)
                 if d not in ("tile", "y", "x")]
        order += [q.dims.index(d) for d in ("tile", "y", "x")]
        lead_dims = tuple(
            d for d in q.dims if d not in ("tile", "y", "x")
        )
        sampled = interpolate_unstructured(arr.permute(order), src, tgt)
        out[name] = Quantity(
            sampled, lead_dims + ("transect",), q.units, dict(q.attrs)
        )
    result = Dataset(out, dict(ds.coords), ds.attrs)
    result.coords["transect_lat"] = ring["lat"]
    result.coords["transect_lon"] = ring["lon"]
    return result
