"""Composable input transforms for diagnostics (port of
``fv3net_tpu/diagnostics/transform.py``; reference:
workflows/diagnostics/fv3net/diagnostics/_shared/transform.py:35-365).

Diagnostics are composed from reusable input transforms
(``@transform.apply("resample_time", 3.0)`` etc.) that adjust the
``DiagArg`` (prediction, verification, grid) before the diagnostic body
runs.  The data are tensors on the diagnostics' device; the time
coordinate is a host array of HOURS since the segment start, and the
time selections and windows are decided on it on the host.

- ``resample_time(freq_hours)``: downsample-only resampling onto
  right-labeled ``freq_hours`` windows, method "nearest" (last sample in
  each window) or "mean"; drops the final time by default (crashed-
  segment tolerance, reference ``time_slice=slice(None, -1)``).
- ``daily_mean(split_hours)``: times after ``start + split`` are
  averaged into daily (24 h) means, earlier times kept at full
  frequency (reference transform.py:152-176).
- ``subset_variables(names)``: keep listed variables only, silently
  skipping absent ones.
- ``select_2d_variables`` / ``select_3d_variables``: split by presence
  of the vertical dim.
- ``mask_to_sfc_type(type)``: NaN-mask data variables outside the
  surface type (land / sea / seaice), in float64.
- ``mask_area(region)``: zero the grid ``area`` outside the region so
  area-weighted reductions restrict to it.
- ``regrid_zdim_to_pressure_levels``: every 3-D variable onto the
  standard pressure levels, in float64.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset

SURFACE_TYPE_CODES = {"sea": (0, 2), "land": (1,), "seaice": (2,)}

_TRANSFORM_FNS: Dict[str, Callable] = {}


def add_to_input_transform_fns(func):
    _TRANSFORM_FNS[func.__name__] = func
    return func


class Deferred:
    """A transform argument resolved at diagnostic-call time (wraps a
    zero-arg callable), so that the registration-time transform chains
    can be reconfigured afterwards."""

    def __init__(self, fn: Callable[[], object]):
        self.fn = fn

    def resolve(self):
        return self.fn()


def _resolve(v):
    return v.resolve() if isinstance(v, Deferred) else v


def apply(transform, *transform_args, **transform_kwargs):
    """Decorator factory prepending an input transform to a diagnostic.
    ``transform`` is a registered transform name or the function itself;
    args may be ``Deferred`` to re-read configuration at call time."""
    fn = (
        _TRANSFORM_FNS[transform]
        if isinstance(transform, str)
        else transform
    )

    def _apply_to_diag_func(diag_func):
        def transformed(arg, *a, **kw):
            args = tuple(_resolve(x) for x in transform_args)
            kwargs = {k: _resolve(v) for k, v in transform_kwargs.items()}
            new_arg = fn(*args, arg, **kwargs)
            return diag_func(new_arg, *a, **kw)

        transformed.__name__ = getattr(diag_func, "__name__", "diagnostic")
        return transformed

    return _apply_to_diag_func


# ------------------------------------------------------------------ helpers
def _replace(arg, **changes):
    return dataclasses.replace(arg, **changes)


def tensor(x, like: Optional[torch.Tensor] = None, dtype=None,
           device=None) -> torch.Tensor:
    """``x`` (numpy, tensor or number) as a tensor on ``like``'s device
    (or ``device``), in ``dtype`` if given."""
    if like is not None:
        device = like.device
    return torch.as_tensor(x, dtype=dtype, device=device)


def host(x) -> np.ndarray:
    """``x`` (a tensor on any device, or an array) as a host array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def on_device(ds: Optional[Dataset], device) -> Optional[Dataset]:
    """The Dataset with every variable's data a tensor on ``device``
    (coords and attrs kept)."""
    if ds is None:
        return None
    return Dataset({k: q.with_data(tensor(q.data, device=device))
                    for k, q in ds.items()}, dict(ds.coords), ds.attrs)


def grid_on(grid: Dict[str, object], device) -> Dict[str, object]:
    """The grid dict with its lat, lon, area and land_sea_mask as
    tensors on ``device``; other entries kept."""
    return {k: (tensor(v, device=device)
                if k in ("lat", "lon", "area", "land_sea_mask") else v)
            for k, v in grid.items()}


def _times_of(ds: Optional[Dataset]) -> Optional[np.ndarray]:
    if ds is None:
        return None
    t = ds.coords.get("time")
    return None if t is None else np.asarray(t, np.float64)


def _isel_time(ds: Dataset, idx) -> Dataset:
    """Subset the time axis of every time-bearing variable AND the time
    coordinate (Dataset.isel alone leaves coords untouched)."""
    idx = np.asarray(idx)
    out = ds.isel(time=idx)
    times = _times_of(ds)
    if times is not None:
        out.coords["time"] = times[idx]
    return out


def _resample(ds: Dataset, freq_hours: float, method: str) -> Dataset:
    """Downsample-only right-labeled resampling of the time axis."""
    times = _times_of(ds)
    if times is None or times.size < 2:
        return ds
    dt = times[1] - times[0]
    if dt >= freq_hours:  # already at or below the target frequency
        return ds
    # right-labeled windows aligned to the global time origin: window w
    # covers ((w-1)*f, w*f], labeled w*f
    win = np.ceil(times / freq_hours - 1e-9).astype(int)
    uniq = np.unique(win)
    if method == "nearest":
        # last sample in each window (nearest to the right label)
        picks = np.asarray(
            [np.nonzero(win == w)[0][-1] for w in uniq]
        )
        return _isel_time(ds, picks)
    if method == "mean":
        out = {}
        for name, q in ds.items():
            if "time" not in q.dims:
                out[name] = q
                continue
            tax = q.dims.index("time")
            arr = tensor(q.data)
            means = torch.stack(
                [
                    torch.nanmean(
                        arr.index_select(tax, tensor(
                            np.nonzero(win == w)[0], like=arr)),
                        dim=tax,
                    )
                    for w in uniq
                ],
                dim=tax,
            )
            out[name] = dataclasses.replace(q, data=means)
        new = Dataset(out, dict(ds.coords), ds.attrs)
        new.coords["time"] = uniq * float(freq_hours)
        return new
    raise ValueError(f"Don't know how to resample with method={method}.")


# ---------------------------------------------------------------- transforms
@add_to_input_transform_fns
def resample_time(
    freq_hours: float,
    arg,
    time_slice=slice(None, -1),
    inner_join: bool = False,
    method: str = "nearest",
):
    """(reference transform.py:87-131)"""
    pred, verif = arg.prediction, arg.verification
    pred = _resample(pred, freq_hours, method)
    if verif is not None:
        verif = _resample(verif, freq_hours, method)
    times = _times_of(pred)
    if times is not None:
        pred = _isel_time(pred, np.arange(times.size)[time_slice])
    if inner_join and verif is not None:
        tp, tv = _times_of(pred), _times_of(verif)
        if tp is not None and tv is not None:
            common = np.intersect1d(tp, tv)
            pred = _isel_time(pred, np.nonzero(np.isin(tp, common))[0])
            verif = _isel_time(verif, np.nonzero(np.isin(tv, common))[0])
    return _replace(arg, prediction=pred, verification=verif)


@add_to_input_transform_fns
def daily_mean(split_hours: float, arg):
    """Daily means for all times after ``start + split_hours``
    (reference transform.py:152-176)."""

    def _split(ds):
        times = _times_of(ds)
        if times is None or times.size == 0:
            return ds
        split_t = times[0] + split_hours
        head_idx = np.nonzero(times <= split_t)[0]
        tail_idx = np.nonzero(times > split_t)[0]
        if tail_idx.size == 0:
            return ds
        head = _isel_time(ds, head_idx)
        tail = _resample(_isel_time(ds, tail_idx), 24.0, "mean")
        out = {}
        for name, q in ds.items():
            if "time" not in q.dims:
                out[name] = q
                continue
            tax = q.dims.index("time")
            out[name] = dataclasses.replace(
                q,
                data=torch.cat([tensor(head[name].data),
                                tensor(tail[name].data)], dim=tax),
            )
        new = Dataset(out, dict(ds.coords), ds.attrs)
        new.coords["time"] = np.concatenate(
            [np.atleast_1d(_times_of(head)),
             np.atleast_1d(_times_of(tail))]
        )
        return new

    pred = _split(arg.prediction)
    verif = None if arg.verification is None else _split(arg.verification)
    return _replace(arg, prediction=pred, verification=verif)


@add_to_input_transform_fns
def subset_variables(variables: Sequence[str], arg):
    """(reference transform.py:322-334) keep listed variables, skipping
    absent ones without failing."""

    def _subset(ds):
        if ds is None:
            return None
        keep = {k: ds[k] for k in variables if k in ds}
        return Dataset(keep, dict(ds.coords), ds.attrs)

    return _replace(
        arg,
        prediction=_subset(arg.prediction),
        verification=_subset(arg.verification),
    )


def _is_3d(q) -> bool:
    return "z" in q.dims


@add_to_input_transform_fns
def select_3d_variables(arg):
    keep = [k for k, q in arg.prediction.items() if _is_3d(q)]
    return subset_variables(keep, arg)


@add_to_input_transform_fns
def select_2d_variables(arg):
    keep = [k for k, q in arg.prediction.items() if not _is_3d(q)]
    return subset_variables(keep, arg)


def _surface_mask(grid, surface_type: str) -> torch.Tensor:
    if surface_type not in SURFACE_TYPE_CODES:
        raise ValueError(
            f"Masking for surface type {surface_type!r} is not defined."
        )
    lsm = torch.round(tensor(grid["land_sea_mask"])).to(torch.int64)
    mask = torch.zeros(lsm.shape, dtype=torch.bool, device=lsm.device)
    for code in SURFACE_TYPE_CODES[surface_type]:
        mask |= lsm == code
    return mask


@add_to_input_transform_fns
def mask_to_sfc_type(surface_type: str, arg):
    """NaN-mask data variables outside the surface type, in float64
    (reference transform.py:224-244); grid area untouched (use mask_area
    for weighted means)."""
    mask = _surface_mask(arg.grid, surface_type)

    def _mask_ds(ds):
        if ds is None:
            return None
        out = {}
        for name, q in ds.items():
            # spatial variables carry (tile, y, x); a vertical dim may
            # sit between tile and y ([time, tile, z, y, x] cube layout)
            if not {"tile", "y", "x"}.issubset(q.dims):
                out[name] = q
                continue
            arr = tensor(q.data, dtype=torch.float64)
            shape = [1] * arr.ndim
            for dim, msize in zip(("tile", "y", "x"), mask.shape):
                shape[q.dims.index(dim)] = msize
            m = mask.to(arr.device).reshape(shape)
            out[name] = dataclasses.replace(
                q, data=torch.where(m, arr, torch.nan))
        return Dataset(out, dict(ds.coords), ds.attrs)

    return _replace(
        arg,
        prediction=_mask_ds(arg.prediction),
        verification=_mask_ds(arg.verification),
    )


@add_to_input_transform_fns
def regrid_zdim_to_pressure_levels(arg, vertical_dim: str = "z"):
    """Interpolate every 3-D variable onto the standard pressure levels
    (vcm's PRESSURE_GRID) with the arg's ``delp``, in float64 (reference
    transform.py:365).  Requires the DiagArg to carry ``delp`` with the
    cube layout [..., z, y, x]; variables without the vertical dim pass
    through."""
    from fv3net_torch.ops.regridz import interpolate_to_pressure_levels

    delp = getattr(arg, "delp", None)
    if delp is None:
        raise ValueError(
            "regrid_zdim_to_pressure_levels requires DiagArg.delp"
        )

    def _regrid_ds(ds):
        if ds is None:
            return None
        out = {}
        for name, q in ds.items():
            if vertical_dim not in q.dims:
                out[name] = q
                continue
            zax = q.dims.index(vertical_dim)
            arr = tensor(q.data, dtype=torch.float64)
            dp = tensor(delp, like=arr)
            # z -> last for the column interpolation, then restore
            arr_zl = arr.movedim(zax, -1)
            if dp.ndim == arr.ndim:
                dp_zl = dp.movedim(zax, -1)
            else:
                dp_zl = dp.broadcast_to(arr_zl.shape)
            interp = interpolate_to_pressure_levels(
                arr_zl.contiguous(), dp_zl.to(torch.float64).contiguous())
            dims = tuple(
                "pressure" if d == vertical_dim else d for d in q.dims
            )
            out[name] = dataclasses.replace(
                q, data=interp.movedim(-1, zax), dims=dims
            )
        return Dataset(out, dict(ds.coords), ds.attrs)

    return _replace(
        arg,
        prediction=_regrid_ds(arg.prediction),
        verification=_regrid_ds(arg.verification),
    )


@add_to_input_transform_fns
def mask_area(region: str, arg):
    """Zero the grid area outside ``region`` so area-weighted
    reductions restrict to it (reference transform.py:247-276; regions
    global / land / sea / seaice / tropics / tropics15 / tropics20)."""
    grid = dict(arg.grid)
    area = tensor(grid["area"], dtype=torch.float64)
    lat = tensor(grid["lat"], like=area)
    if region == "global":
        keep = torch.ones(area.shape, dtype=torch.bool, device=area.device)
    elif region == "tropics":
        keep = torch.abs(lat) <= 10.0
    elif region == "tropics15":
        keep = torch.abs(lat) <= 15.0
    elif region == "tropics20":
        keep = torch.abs(lat) <= 20.0
    elif region in SURFACE_TYPE_CODES:
        keep = _surface_mask(grid, region).to(area.device)
    else:
        raise ValueError(
            f"Masking procedure for region {region!r} is not defined."
        )
    grid["area"] = torch.where(keep, area, 0.0)
    return _replace(arg, grid=grid)
