"""Cube-shaped offline-ML diagnostics registry (port of
``fv3net_tpu/diagnostics/offline/compute_diagnostics.py``; reference:
workflows/diagnostics/fv3net/diagnostics/offline/
compute_diagnostics.py:55-566): a Registry of per-mask diagnostic
families over (prediction, target, grid, delp), each composed from the
shared input-transform chains (mask_area / mask_to_sfc_type /
select_2d_variables / select_3d_variables /
regrid_zdim_to_pressure_levels):

- ``mse_{2d,pressure_level,model_level}_{global,land,sea}``:
  area-weighted mean squared error, time-averaged;
- ``variance_{...}_{mask}``: target variance about its domain mean
  (the denominators for R2);
- ``bias_{2d,pressure_level}_{mask}``: area-weighted mean bias;
- ``bias_{2d,pressure_level}_zonal_avg_{mask}``: zonal-average bias
  (surface-type NaN-masked, like the reference);
- ``mse/variance_pressure_level_zonal_avg_{mask}``;
- ``diurnal_cycle_{mask}``: local-solar-hour composites of predict and
  target;
- ``time_domain_mean_{2d,pressure_level,model_level}_{mask}``: scalar
  domain means of both derivations;
- ``time_mean_global``: predict/target time-mean maps.

Data model: prediction/target are Datasets of [time, tile, (z,) y, x]
tensors on one device; grid is the dict {lat, lon, area, land_sea_mask}
of (tile, y, x) arrays; delp has the cube layout for the pressure-level
transforms.  Every family computes in float64 on the data's device (the
reference casts to float64); the local-solar-hour bins are decided on
the host from the time coordinate.  Outputs carry a trailing
``derivation`` axis (target, predict) where the reference concatenates
along its derivation dim.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.diagnostics import transform
from fv3net_torch.diagnostics.registry import Registry
from fv3net_torch.diagnostics.transform import host, tensor

DERIVATION_DIM = "derivation"
DERIVATION_COORDS = ("target", "predict")


@dataclasses.dataclass
class DiagArg:
    """(reference _shared/constants.py DiagArg for the offline stack)"""

    prediction: Dataset
    verification: Dataset
    grid: Dict[str, object]
    delp: Optional[object] = None


def merge_diagnostics(outputs):
    merged: Dict[str, Quantity] = {}
    for name, diags in outputs:
        for var, q in diags.items():
            merged[f"{var}_{name}"] = q
    return merged


diagnostics_registry = Registry(merge_diagnostics)


def compute_diagnostics(
    prediction: Dataset,
    target: Dataset,
    grid: Dict[str, object],
    delp=None,
) -> Dict[str, Quantity]:
    """(reference compute_diagnostics.py:58-66).  Failure-isolated per
    diagnostic (e.g. the pressure-level families skip when ``delp`` is
    absent) like the reference registry's error containment."""
    return diagnostics_registry.compute(
        DiagArg(prediction, target, grid, delp), allow_errors=True
    )


# ------------------------------------------------------------------ helpers
def _arr(q) -> torch.Tensor:
    return tensor(q.data, dtype=torch.float64)


def _area(arg: DiagArg) -> torch.Tensor:
    return tensor(arg.grid["area"], dtype=torch.float64)


def _haxes(q) -> Tuple[int, ...]:
    """Horizontal axes (tile, y, x): the trailing three for 2-D cube
    vars, trailing two + tile axis for 3-D [time, tile, z, y, x]."""
    if "z" in q.dims or "pressure" in q.dims:
        return (1, 3, 4)
    return (1, 2, 3)


def _wmean(arr, w, axes):
    num = torch.nansum(arr * w, dim=axes)
    den = torch.sum(torch.where(torch.isnan(arr), 0.0, w), dim=axes)
    return num / torch.clamp(den, min=1e-300)


def _bcast_weights(q, area):
    """area (tile, y, x) broadcast against the var's cube layout."""
    if "z" in q.dims or "pressure" in q.dims:
        return area[None, :, None, :, :]
    return area[None]


def _vdim(q) -> Optional[str]:
    for d in ("z", "pressure"):
        if d in q.dims:
            return d
    return None


def _time_mean(arr):
    return torch.nanmean(arr, dim=0)


def _pair(pred_val, tgt_val, dims, units="", attrs=None):
    """Stack (target, predict) along the trailing derivation axis."""
    data = torch.stack([tgt_val, pred_val], dim=-1)
    return Quantity(
        data, tuple(dims) + (DERIVATION_DIM,), units,
        attrs={**(attrs or {}), DERIVATION_DIM: list(DERIVATION_COORDS)},
    )


def _nanmean_bins(flat, idx, n_bins: int):
    """NaN-skipping mean of the last axis of ``flat`` within each bin of
    ``idx`` (in [0, n_bins], n_bins for a value in no bin): NaN where a
    bin holds no finite value.  Returns (..., n_bins)."""
    valid = ~torch.isnan(flat)
    lead = flat.shape[:-1]
    s = torch.zeros(lead + (n_bins + 1,), dtype=flat.dtype,
                    device=flat.device).index_add_(
        -1, idx, torch.where(valid, flat, 0.0))
    c = torch.zeros(lead + (n_bins + 1,), dtype=flat.dtype,
                    device=flat.device).index_add_(-1, idx, valid.to(
                        flat.dtype))
    return s[..., :n_bins] / c[..., :n_bins]


def _zonal_average(field, lat_deg, nbins: int = 45):
    """NaN-aware equal-width latitude binning (the offline analog of
    vcm.zonal_average_approximate; NaNs excluded per bin)."""
    edges = np.linspace(-90.0, 90.0, nbins + 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    lat = tensor(lat_deg, like=field, dtype=torch.float64)
    which = torch.clamp(torch.searchsorted(
        tensor(edges, like=lat), lat.reshape(-1).contiguous(),
        right=True) - 1, 0, nbins - 1)
    lead = field.shape[: field.ndim - lat.ndim]
    return _nanmean_bins(field.reshape(lead + (-1,)), which, nbins), centers


# --------------------------------------------------------------- mse family
def _register_mse(mask_type: str):
    @diagnostics_registry.register(f"mse_2d_{mask_type}")
    @transform.apply("select_2d_variables")
    @transform.apply("mask_area", mask_type)
    def mse_2d(arg: DiagArg):
        out = {}
        area = _area(arg)
        for var, q in arg.prediction.items():
            if var not in arg.verification:
                continue
            err = (_arr(q) - _arr(arg.verification[var])) ** 2
            m = _wmean(err, _bcast_weights(q, area), _haxes(q))
            out[var] = Quantity(
                _time_mean(m), (), f"({q.units})^2"
            )
        return out

    @diagnostics_registry.register(f"mse_pressure_level_{mask_type}")
    @transform.apply("select_3d_variables")
    @transform.apply("regrid_zdim_to_pressure_levels")
    @transform.apply("mask_area", mask_type)
    def mse_3d(arg: DiagArg):
        return _mse_levels(arg)

    @diagnostics_registry.register(f"mse_model_level_{mask_type}")
    @transform.apply("select_3d_variables")
    @transform.apply("mask_area", mask_type)
    def mse_3d_model(arg: DiagArg):
        return _mse_levels(arg)

    @diagnostics_registry.register(f"variance_2d_{mask_type}")
    @transform.apply("select_2d_variables")
    @transform.apply("mask_area", mask_type)
    def variance_2d(arg: DiagArg):
        out = {}
        area = _area(arg)
        for var, q in arg.verification.items():
            t = _arr(q)
            w = _bcast_weights(q, area)
            mean = _time_mean(_wmean(t, w, _haxes(q)))
            var_ = _time_mean(
                _wmean((t - mean) ** 2, w, _haxes(q))
            )
            out[var] = Quantity(var_, (), f"({q.units})^2")
        return out

    @diagnostics_registry.register(f"variance_pressure_level_{mask_type}")
    @transform.apply("select_3d_variables")
    @transform.apply("regrid_zdim_to_pressure_levels")
    @transform.apply("mask_area", mask_type)
    def variance_3d(arg: DiagArg):
        return _variance_levels(arg)

    @diagnostics_registry.register(f"variance_model_level_{mask_type}")
    @transform.apply("select_3d_variables")
    @transform.apply("mask_area", mask_type)
    def variance_3d_model(arg: DiagArg):
        return _variance_levels(arg)

    @diagnostics_registry.register(f"bias_2d_{mask_type}")
    @transform.apply("select_2d_variables")
    @transform.apply("mask_area", mask_type)
    def bias_2d(arg: DiagArg):
        out = {}
        area = _area(arg)
        for var, q in arg.prediction.items():
            if var not in arg.verification:
                continue
            diff = _arr(q) - _arr(arg.verification[var])
            m = _wmean(diff, _bcast_weights(q, area), _haxes(q))
            out[var] = Quantity(_time_mean(m), (), q.units)
        return out

    @diagnostics_registry.register(f"bias_pressure_level_{mask_type}")
    @transform.apply("select_3d_variables")
    @transform.apply("regrid_zdim_to_pressure_levels")
    @transform.apply("mask_area", mask_type)
    def bias_3d(arg: DiagArg):
        out = {}
        area = _area(arg)
        for var, q in arg.prediction.items():
            if var not in arg.verification:
                continue
            diff = _arr(q) - _arr(arg.verification[var])
            m = _wmean(diff, _bcast_weights(q, area), (1, 3, 4))
            out[var] = Quantity(
                _time_mean(m), (_vdim(q),), q.units
            )
        return out

    @diagnostics_registry.register(f"bias_2d_zonal_avg_{mask_type}")
    @transform.apply("select_2d_variables")
    @transform.apply("mask_to_sfc_type_if_not_global", mask_type)
    def bias_zonal_2d(arg: DiagArg):
        out = {}
        for var, q in arg.prediction.items():
            if var not in arg.verification:
                continue
            diff = _arr(q) - _arr(arg.verification[var])
            zm, centers = _zonal_average(diff, arg.grid["lat"])
            out[var] = Quantity(
                _time_mean(zm), ("latitude",), q.units,
                attrs={"latitude": centers.tolist()},
            )
        return out

    @diagnostics_registry.register(
        f"bias_pressure_level_zonal_avg_{mask_type}"
    )
    @transform.apply("select_3d_variables")
    @transform.apply("regrid_zdim_to_pressure_levels")
    @transform.apply("mask_to_sfc_type_if_not_global", mask_type)
    def bias_zonal_3d(arg: DiagArg):
        out = {}
        for var, q in arg.prediction.items():
            if var not in arg.verification:
                continue
            diff = _arr(q) - _arr(arg.verification[var])
            # [time, tile, p, y, x]: bin over (tile, y, x)
            diff = diff.movedim(2, 1)  # [time, p, tile, y, x]
            zm, centers = _zonal_average(diff, arg.grid["lat"])
            out[var] = Quantity(
                _time_mean(zm), (_vdim(q), "latitude"), q.units,
                attrs={"latitude": centers.tolist()},
            )
        return out

    @diagnostics_registry.register(
        f"mse_pressure_level_zonal_avg_{mask_type}"
    )
    @transform.apply("select_3d_variables")
    @transform.apply("regrid_zdim_to_pressure_levels")
    @transform.apply("mask_to_sfc_type_if_not_global", mask_type)
    def mse_zonal_3d(arg: DiagArg):
        out = {}
        for var, q in arg.prediction.items():
            if var not in arg.verification:
                continue
            err = (_arr(q) - _arr(arg.verification[var])) ** 2
            zm, centers = _zonal_average(err.movedim(2, 1), arg.grid["lat"])
            out[var] = Quantity(
                _time_mean(zm), (_vdim(q), "latitude"), f"({q.units})^2",
                attrs={"latitude": centers.tolist()},
            )
        return out

    @diagnostics_registry.register(
        f"variance_pressure_level_zonal_avg_{mask_type}"
    )
    @transform.apply("select_3d_variables")
    @transform.apply("regrid_zdim_to_pressure_levels")
    @transform.apply("mask_to_sfc_type_if_not_global", mask_type)
    def variance_zonal_3d(arg: DiagArg):
        # variance of the target about its zonal-time mean per (level,
        # latitude) bin: E[t^2] - E[t]^2 over (time, cells-in-bin)
        out = {}
        for var, q in arg.verification.items():
            t = _arr(q).movedim(2, 1)  # [time, p, tile, y, x]
            zm, centers = _zonal_average(t, arg.grid["lat"])
            zm2, _ = _zonal_average(t ** 2, arg.grid["lat"])
            vzm = _time_mean(zm2) - _time_mean(zm) ** 2
            out[var] = Quantity(
                torch.clamp(vzm, min=0.0), (_vdim(q), "latitude"),
                f"({q.units})^2",
                attrs={"latitude": centers.tolist()},
            )
        return out

    @diagnostics_registry.register(f"diurnal_cycle_{mask_type}")
    @transform.apply("mask_to_sfc_type_if_not_global", mask_type)
    @transform.apply("select_2d_variables")
    def diurnal_cycle(arg: DiagArg):
        """Local-solar-hour composites of predict AND target (reference
        compute_diagnostics.py:379-396 via _calc_ds_diurnal_cycle)."""
        out = {}
        times = arg.prediction.coords.get("time")
        if times is None:
            return out
        hours = np.asarray(times, np.float64)
        lon = np.asarray(host(arg.grid["lon"]), np.float64)
        local = (hours[:, None, None, None] + lon[None] / 15.0) % 24.0
        hour_bin = np.floor(local).astype(np.int64)
        hour_bin[(hour_bin < 0) | (hour_bin >= 24)] = 24
        for var, q in arg.prediction.items():
            if var not in arg.verification:
                continue
            comps = []
            for src in (arg.verification[var], q):
                a = _arr(src)
                comps.append(_nanmean_bins(
                    a.reshape(-1), tensor(hour_bin, like=a).reshape(-1),
                    24))
            out[var] = _pair(
                comps[1], comps[0], ("local_time",), q.units,
                attrs={"local_time": list(range(24))},
            )
        return out

    @diagnostics_registry.register(f"time_domain_mean_2d_{mask_type}")
    @transform.apply("select_2d_variables")
    @transform.apply("mask_area", mask_type)
    def time_domain_mean_2d(arg: DiagArg):
        return _domain_means(arg, levels=False)

    @diagnostics_registry.register(
        f"time_domain_mean_pressure_level_{mask_type}"
    )
    @transform.apply("select_3d_variables")
    @transform.apply("regrid_zdim_to_pressure_levels")
    @transform.apply("mask_area", mask_type)
    def time_domain_mean_pl(arg: DiagArg):
        return _domain_means(arg, levels=True)

    @diagnostics_registry.register(
        f"time_domain_mean_model_level_{mask_type}"
    )
    @transform.apply("select_3d_variables")
    @transform.apply("mask_area", mask_type)
    def time_domain_mean_ml(arg: DiagArg):
        return _domain_means(arg, levels=True)


def _mse_levels(arg: DiagArg):
    out = {}
    area = _area(arg)
    for var, q in arg.prediction.items():
        if var not in arg.verification:
            continue
        err = (_arr(q) - _arr(arg.verification[var])) ** 2
        m = _wmean(err, _bcast_weights(q, area), (1, 3, 4))
        out[var] = Quantity(
            _time_mean(m), (_vdim(q),), f"({q.units})^2"
        )
    return out


def _variance_levels(arg: DiagArg):
    out = {}
    area = _area(arg)
    for var, q in arg.verification.items():
        t = _arr(q)
        w = _bcast_weights(q, area)
        mean = _time_mean(_wmean(t, w, (1, 3, 4)))  # [z]
        var_ = _time_mean(
            _wmean((t - mean[None, None, :, None, None]) ** 2, w,
                   (1, 3, 4))
        )
        out[var] = Quantity(var_, (_vdim(q),), f"({q.units})^2")
    return out


def _domain_means(arg: DiagArg, levels: bool):
    out = {}
    area = _area(arg)
    axes = (1, 3, 4) if levels else None
    for var, q in arg.prediction.items():
        if var not in arg.verification:
            continue
        w = _bcast_weights(q, area)
        hx = axes or _haxes(q)
        p = _time_mean(_wmean(_arr(q), w, hx))
        t = _time_mean(
            _wmean(_arr(arg.verification[var]), w, hx)
        )
        dims = (_vdim(q),) if levels else ()
        out[var] = _pair(p, t, dims, q.units)
    return out


# surface-type masking that passes through for "global" (the reference
# only applies mask_to_sfc_type for land/sea; a small shim lets the same
# chain text work for all mask types)
@transform.add_to_input_transform_fns
def mask_to_sfc_type_if_not_global(mask_type: str, arg):
    if mask_type == "global":
        return arg
    return transform.mask_to_sfc_type(mask_type, arg)


for _mask in ("global", "land", "sea"):
    _register_mse(_mask)


@diagnostics_registry.register("time_mean_global")
def time_mean_global_maps(arg: DiagArg):
    """Predict/target time-mean maps (reference
    compute_diagnostics.py:511-523)."""
    out = {}
    for var, q in arg.prediction.items():
        if var not in arg.verification:
            continue
        p = _time_mean(_arr(q))
        t = _time_mean(_arr(arg.verification[var]))
        out[var] = _pair(p, t, q.dims[1:], q.units)
    return out
