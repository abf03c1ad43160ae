"""Computed diagnostics of a prognostic run against an optional
verification (port of ``fv3net_tpu/diagnostics/prognostic/compute.py``;
reference: workflows/diagnostics/fv3net/diagnostics/prognostic_run/
compute.py:252-476): registries of 2-D and 3-D diagnostics (global RMS,
zonal and time means, zonal biases, masked spatial means, minima and
maxima, Hovmoller slices, histograms, diurnal cycles) merged into one
mapping, each diagnostic named ``{variable}_{diag_name}``.

Data model: a run is a Dataset of tensors with dims (time, tile, y, x[,
z]) plus a grid dict with lat (deg), lon (deg), area and land_sea_mask
of shape (tile, y, x).  :func:`compute_all` moves both to its ``device``
and every diagnostic computes there; the time coordinate (hours since
the segment start) stays on the host, and the local-solar-hour and
longitude bins of a diagnostic are decided there, as the reference
decides them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.diagnostics import transform
from fv3net_torch.diagnostics.registry import Registry
from fv3net_torch.diagnostics.transform import grid_on, host, on_device, tensor
from fv3net_torch.ops import statistics as stats

# Transform-chain configuration (reference compute.py:252-481 composes
# every time-series diagnostic from resample_time / daily_mean /
# subset_variables chains; the frequencies here are config-side and
# re-read at call time via transform.Deferred).  Times are HOURS since
# segment start.  ``daily_mean_split_hours``: after this long, the time
# series collapse to daily means (reference timedelta(days=10)).
# ``time_slice``: applied after resampling; the reference drops the
# final time (crashed-segment tolerance); the runtime only writes
# completed diagnostics windows, so the default keeps all times.
TRANSFORM_CHAIN = {
    "resample_freq_hours": 3.0,
    "daily_mean_split_hours": 240.0,
    "time_slice": slice(None),
}


def set_transform_chain(**kwargs) -> None:
    """Reconfigure the diagnostic input-transform chains (keys of
    TRANSFORM_CHAIN); takes effect on the next compute_all call."""
    for key, val in kwargs.items():
        if key not in TRANSFORM_CHAIN:
            raise KeyError(f"unknown transform-chain key {key!r}")
        TRANSFORM_CHAIN[key] = val


_FREQ = transform.Deferred(lambda: TRANSFORM_CHAIN["resample_freq_hours"])
_SPLIT = transform.Deferred(
    lambda: TRANSFORM_CHAIN["daily_mean_split_hours"]
)
_TSLICE = transform.Deferred(lambda: TRANSFORM_CHAIN["time_slice"])


@dataclasses.dataclass
class DiagArg:
    """(reference compute.py DiagArg): prognostic run output,
    verification data, grid."""

    prediction: Dataset
    verification: Optional[Dataset]
    grid: Dict[str, torch.Tensor]


def merge_diags(outputs: List[Tuple[str, Dict[str, Quantity]]]):
    merged: Dict[str, Quantity] = {}
    for name, diags in outputs:
        for var, q in diags.items():
            merged[f"{var}_{name}"] = q
    return merged


registry_2d = Registry(merge_diags)
registry_3d = Registry(merge_diags)


_HORIZ = {"tile", "y", "x"}  # spatial diagnostics need the cube dims


def _d(q) -> torch.Tensor:
    return tensor(q.data)


def _time_mean(arr, axis=0):
    return torch.nanmean(arr, dim=axis)


def _cube_2d(q) -> bool:
    return "z" not in q.dims and _HORIZ.issubset(q.dims)


def _paired(arg: DiagArg, var: str, q) -> bool:
    return _cube_2d(q) and var in arg.verification


@registry_2d.register("spatial_mean_global")
@transform.apply("resample_time", _FREQ, time_slice=_TSLICE)
@transform.apply("daily_mean", _SPLIT)
def spatial_mean_global(arg: DiagArg):
    out = {}
    area = arg.grid["area"]
    for var, q in arg.prediction.items():
        if not _cube_2d(q):
            continue
        out[var] = Quantity(
            stats.weighted_mean(_d(q), area, axis=tuple(range(1, q.ndim))),
            ("time",),
            q.units,
        )
    return out


def _register_masked(mask_type: str):
    @registry_2d.register(f"spatial_mean_{mask_type}")
    @transform.apply("resample_time", _FREQ, time_slice=_TSLICE)
    @transform.apply("daily_mean", _SPLIT)
    def spatial_mean_masked(arg: DiagArg, _mask=mask_type):
        out = {}
        area = arg.grid["area"]
        mask = arg.grid["land_sea_mask"]
        for var, q in arg.prediction.items():
            if not _cube_2d(q):
                continue
            field = stats.mask_to_surface_type(_d(q), mask, _mask)
            nan = torch.isnan(field)
            w = torch.where(nan, 0.0, area)
            f = torch.where(nan, 0.0, field)
            ax = tuple(range(1, q.ndim))
            out[var] = Quantity(torch.sum(f * w, dim=ax)
                                / torch.sum(w, dim=ax), ("time",), q.units)
        return out


for _mask_type in ("land", "sea"):
    _register_masked(_mask_type)


@registry_2d.register("time_mean_value")
def time_mean_maps(arg: DiagArg):
    out = {}
    for var, q in arg.prediction.items():
        if not _cube_2d(q):
            continue
        out[var] = Quantity(_time_mean(_d(q)), q.dims[1:], q.units)
    return out


def _zonal(field, arg: DiagArg, dims, units) -> Quantity:
    zm, centers = stats.zonal_average_approximate(
        field, arg.grid["lat"], arg.grid["area"])
    return Quantity(zm, dims, units, attrs={"latitude": centers.tolist()})


@registry_2d.register("zonal_and_time_mean")
def zonal_and_time_mean(arg: DiagArg):
    return {var: _zonal(_time_mean(_d(q)), arg, ("latitude",), q.units)
            for var, q in arg.prediction.items() if _cube_2d(q)}


@registry_2d.register("zonal_mean_value")
@transform.apply("resample_time", _FREQ, time_slice=_TSLICE)
@transform.apply("daily_mean", _SPLIT)
def zonal_mean_hovmoller(arg: DiagArg):
    return {var: _zonal(_d(q), arg, ("time", "latitude"), q.units)
            for var, q in arg.prediction.items() if _cube_2d(q)}


@registry_2d.register("rms_global")
@transform.apply("resample_time", _FREQ, time_slice=_TSLICE,
                 inner_join=True)
@transform.apply("daily_mean", _SPLIT)
def rms_global(arg: DiagArg):
    out = {}
    if arg.verification is None:
        return out
    area = arg.grid["area"]
    for var, q in arg.prediction.items():
        if not _paired(arg, var, q):
            continue
        truth = _d(arg.verification[var])
        rms = stats.root_mean_squared_error(
            truth, _d(q), axis=tuple(range(1, q.ndim)), weights=area
        )
        out[var] = Quantity(rms, ("time",), q.units)
    return out


@registry_2d.register("mean_bias_global")
@transform.apply("resample_time", _FREQ, time_slice=_TSLICE,
                 inner_join=True)
@transform.apply("daily_mean", _SPLIT)
def mean_bias_global(arg: DiagArg):
    out = {}
    if arg.verification is None:
        return out
    area = arg.grid["area"]
    for var, q in arg.prediction.items():
        if not _paired(arg, var, q):
            continue
        b = stats.bias(
            _d(arg.verification[var]), _d(q),
            axis=tuple(range(1, q.ndim)), weights=area,
        )
        out[var] = Quantity(b, ("time",), q.units)
    return out


@registry_3d.register("pressure_level_zonal_time_mean")
def zonal_means_3d(arg: DiagArg):
    out = {}
    for var, q in arg.prediction.items():
        if "z" not in q.dims or not _HORIZ.issubset(q.dims):
            continue
        # (time, tile, z, y, x) -> time mean -> (tile, z, y, x); z in
        # front of the spatial axes for binning
        out[var] = _zonal(_time_mean(_d(q)).movedim(1, 0), arg,
                          ("z", "latitude"), q.units)
    return out


# percentile-relevant variables get histograms (the reference computes
# precipitation histograms/percentiles, compute.py histogram diagnostics)
_HISTOGRAM_BINS = {
    "PRATEsfc": np.logspace(-10, -2, 51),  # kg/m^2/s
    "surface_precipitation_rate": np.logspace(-10, -2, 51),
    "total_precipitation_rate": np.logspace(-10, -2, 51),
}


def _frequencies(field, bins) -> Tuple[torch.Tensor, np.ndarray]:
    """Counts over ``bins`` (float64 edges: the field is binned in
    float64, as the reference's promotion bins it) as fractions of their
    total."""
    counts, _ = stats.histogram(field.to(torch.float64), bins)
    counts = counts.to(torch.float64)
    return counts / torch.clamp(counts.sum(), min=1), np.asarray(bins)


@registry_2d.register("histogram")
def histograms(arg: DiagArg):
    out = {}
    for var, q in arg.prediction.items():
        bins = _HISTOGRAM_BINS.get(var)
        if bins is None or "z" in q.dims:
            continue
        freq, edges = _frequencies(_d(q), bins)
        out[var] = Quantity(freq, ("bins",), "fraction",
                            attrs={"bin_edges": edges.tolist()})
    return out


@registry_2d.register("time_mean_bias_value")
def time_mean_bias_maps(arg: DiagArg):
    """Time-mean bias maps against the verification."""
    out = {}
    if arg.verification is None:
        return out
    for var, q in arg.prediction.items():
        if not _paired(arg, var, q):
            continue
        b = _time_mean(_d(q)) - _time_mean(_d(arg.verification[var]))
        out[var] = Quantity(b, q.dims[1:], q.units)
    return out


N_SOLAR_HOURS = 24


def _solar_hour_bins(arg: DiagArg) -> Optional[torch.Tensor]:
    """The local solar hour bin (0-23) of every (time, tile, y, x) cell,
    decided on the host from the time coordinate (hours) and the
    longitudes as the reference decides it (24 for a cell in no bin);
    None without times."""
    hours = arg.prediction.coords.get("time")
    if hours is None:
        return None
    hours = np.asarray(hours, np.float64)
    lon_deg = host(arg.grid["lon"])
    solar_hour = (hours[:, None, None, None] + lon_deg[None] / 15.0) % 24.0
    hb = np.floor(solar_hour).astype(np.int64)
    hb[(hb < 0) | (hb >= N_SOLAR_HOURS)] = N_SOLAR_HOURS
    return tensor(hb, device=arg.grid["area"].device)


def _binned_mean(field, weights, bins, n_bins: int, lead: int = 0):
    """sum(field * w) / max(sum(w), 1e-30) over the cells of each bin,
    the first ``lead`` axes kept: the weights broadcast against the
    field, the bin index (in [0, n_bins], n_bins for a cell in no bin)
    against its axes after the lead ones.  As in
    the reference's masked sums, a non-finite field value anywhere in a
    slice makes every bin of that slice NaN.  Returns (*lead, n_bins)."""
    shape = field.shape[:lead]
    w = torch.broadcast_to(weights, field.shape)
    f = (field * w).reshape(shape + (-1,))
    w = w.reshape(shape + (-1,))
    idx = torch.broadcast_to(bins, field.shape[lead:]).reshape(-1)
    num = torch.zeros(shape + (n_bins + 1,), dtype=f.dtype,
                      device=f.device).index_add_(-1, idx, f)
    den = torch.zeros(shape + (n_bins + 1,), dtype=w.dtype,
                      device=w.device).index_add_(-1, idx, w)
    poison = (field * 0).reshape(shape + (-1,)).sum(-1, keepdim=True)
    return (num[..., :n_bins] + poison) / torch.clamp(den[..., :n_bins],
                                                      min=1e-30)


def _diurnal(arr, weights, hb, units) -> Quantity:
    comp = _binned_mean(arr, weights, hb, N_SOLAR_HOURS)
    return Quantity(comp, ("solar_hour",), units,
                    attrs={"solar_hour": list(range(N_SOLAR_HOURS))})


@registry_2d.register("diurnal_cycle")
def diurnal_cycle(arg: DiagArg):
    """Composite by local solar hour (the reference's diurnal-cycle
    diagnostics of surface fields, diurnal_cycle.py): 24 one-hour bins
    of the time coordinate plus longitude / 15, area-weighted global
    mean per bin."""
    out = {}
    hb = _solar_hour_bins(arg)
    if hb is None:
        return out
    area = arg.grid["area"]
    for var, q in arg.prediction.items():
        if not _cube_2d(q):
            continue
        out[var] = _diurnal(_d(q), area, hb, q.units)
    return out


@registry_2d.register("zonal_and_time_mean_bias")
def zonal_and_time_mean_bias(arg: DiagArg):
    """(reference compute.py zonal_and_time_mean_biases_2d)"""
    out = {}
    if arg.verification is None:
        return out
    for var, q in arg.prediction.items():
        if not _paired(arg, var, q):
            continue
        diff = _time_mean(_d(q)) - _time_mean(_d(arg.verification[var]))
        out[var] = _zonal(diff, arg, ("latitude",), q.units)
    return out


@registry_2d.register("zonal_mean_bias_value")
@transform.apply("resample_time", _FREQ, time_slice=_TSLICE,
                 inner_join=True)
@transform.apply("daily_mean", _SPLIT)
def zonal_mean_bias_hovmoller(arg: DiagArg):
    """(reference compute.py zonal_mean_bias_hovmoller)"""
    out = {}
    if arg.verification is None:
        return out
    for var, q in arg.prediction.items():
        if not _paired(arg, var, q):
            continue
        diff = _d(q) - _d(arg.verification[var])
        out[var] = _zonal(diff, arg, ("time", "latitude"), q.units)
    return out


@registry_3d.register("pressure_level_zonal_bias")
def zonal_bias_3d(arg: DiagArg):
    """(reference compute.py zonal_bias_3d)"""
    out = {}
    if arg.verification is None:
        return out
    for var, q in arg.prediction.items():
        if "z" not in q.dims or var not in arg.verification:
            continue
        diff = _time_mean(_d(q)) - _time_mean(_d(arg.verification[var]))
        out[var] = _zonal(diff.movedim(1, 0), arg, ("z", "latitude"),
                          q.units)
    return out


_LONGITUDE_BINS = np.arange(0.0, 360.1, 5.0)


def _deep_tropical_hovmoller(field, grid):
    """Average over |lat| <= 10, binned by longitude -> (time, longitude)
    (reference compute.py deep_tropical_mean_hovmoller: the MJO/Kelvin
    wave view).  A cell's 5-degree bin is decided on the host; a cell in
    no bin (a longitude of 360 after the modulo) counts nowhere."""
    lat, lon = host(grid["lat"]), np.mod(host(grid["lon"]), 360.0)
    nb = len(_LONGITUDE_BINS) - 1
    idx = np.searchsorted(_LONGITUDE_BINS, lon, side="right") - 1
    area = grid["area"]
    w = area * tensor(np.abs(lat) <= 10.0, like=area)
    hm = _binned_mean(field, w, tensor(idx, like=area), nb, lead=1)
    return hm, 0.5 * (_LONGITUDE_BINS[:-1] + _LONGITUDE_BINS[1:])


@registry_2d.register("deep_tropical_mean_hovmoller_value")
@transform.apply("resample_time", _FREQ, time_slice=_TSLICE)
def deep_tropical_hovmoller_value(arg: DiagArg):
    out = {}
    for var, q in arg.prediction.items():
        if not _cube_2d(q):
            continue
        hm, centers = _deep_tropical_hovmoller(_d(q), arg.grid)
        out[var] = Quantity(hm, ("time", "longitude"), q.units,
                            attrs={"longitude": centers.tolist()})
    return out


@registry_2d.register("deep_tropical_mean_hovmoller_bias")
@transform.apply("resample_time", _FREQ, time_slice=_TSLICE,
                 inner_join=True)
def deep_tropical_hovmoller_bias(arg: DiagArg):
    out = {}
    if arg.verification is None:
        return out
    for var, q in arg.prediction.items():
        if not _paired(arg, var, q):
            continue
        hm, centers = _deep_tropical_hovmoller(
            _d(q) - _d(arg.verification[var]), arg.grid)
        out[var] = Quantity(hm, ("time", "longitude"), q.units,
                            attrs={"longitude": centers.tolist()})
    return out


def nanmin(x, dim):
    """``jnp.nanmin``: the least non-NaN value over ``dim``, NaN where
    every value is NaN."""
    nan = torch.isnan(x)
    m = torch.amin(torch.where(nan, torch.inf, x), dim=dim)
    return torch.where(torch.all(nan, dim=dim), torch.nan, m)


def nanmax(x, dim):
    """``jnp.nanmax``: the greatest non-NaN value over ``dim``, NaN
    where every value is NaN."""
    nan = torch.isnan(x)
    m = torch.amax(torch.where(nan, -torch.inf, x), dim=dim)
    return torch.where(torch.all(nan, dim=dim), torch.nan, m)


def _register_extrema(mask_type: str):
    """(reference compute.py _per_variable_masked spatial_min/max)"""

    def masked(arg, q):
        field = _d(q)
        if mask_type != "global":
            field = stats.mask_to_surface_type(
                field, arg.grid["land_sea_mask"], mask_type)
        return field

    def extremum(reduce):
        def diagnostic(arg: DiagArg):
            return {var: Quantity(reduce(masked(arg, q),
                                         tuple(range(1, q.ndim))),
                                  ("time",), q.units)
                    for var, q in arg.prediction.items() if _cube_2d(q)}

        return diagnostic

    for name, reduce in (("min", nanmin), ("max", nanmax)):
        registry_2d.register(f"spatial_{name}_{mask_type}")(
            transform.apply("resample_time", _FREQ, time_slice=_TSLICE)(
                transform.apply("daily_mean", _SPLIT)(extremum(reduce))))


for _mask_type in ("global", "land", "sea"):
    _register_extrema(_mask_type)


def _register_masked_bias(mask_type: str):
    """(reference compute.py global_biases_2d over mask types)"""

    @registry_2d.register(f"mean_bias_{mask_type}")
    @transform.apply("resample_time", _FREQ, time_slice=_TSLICE,
                     inner_join=True)
    @transform.apply("daily_mean", _SPLIT)
    def mean_bias_masked(arg: DiagArg):
        out = {}
        if arg.verification is None:
            return out
        area = arg.grid["area"]
        mask = arg.grid["land_sea_mask"]
        for var, q in arg.prediction.items():
            if not _paired(arg, var, q):
                continue
            diff = stats.mask_to_surface_type(
                _d(q) - _d(arg.verification[var]), mask, mask_type
            )
            nan = torch.isnan(diff)
            w = torch.where(nan, 0.0, area)
            d = torch.where(nan, 0.0, diff)
            ax = tuple(range(1, q.ndim))
            out[var] = Quantity(
                torch.sum(d * w, dim=ax)
                / torch.clamp(torch.sum(w, dim=ax), min=1e-30),
                ("time",), q.units,
            )
        return out


for _mask_type in ("land", "sea"):
    _register_masked_bias(_mask_type)


@registry_2d.register("histogram_bias")
def histogram_bias(arg: DiagArg):
    """Histogram frequency difference against the verification
    (reference compute.py compute_histogram_bias)."""
    out = {}
    if arg.verification is None:
        return out
    for var, q in arg.prediction.items():
        bins = _HISTOGRAM_BINS.get(var)
        if bins is None or "z" in q.dims or var not in arg.verification:
            continue
        fp, edges = _frequencies(_d(q), bins)
        fv, _ = _frequencies(_d(arg.verification[var]), bins)
        out[var] = Quantity(fp - fv, ("bins",), "fraction",
                            attrs={"bin_edges": edges.tolist()})
    return out


# joint 2-D histogram pairs: (x variable, y variable, x bins, y bins);
# the reference computes water-vapor-path against column moistening
# (compute.py _compute_wvp_vs_q2_histogram)
_HIST2D_PAIRS = [
    (
        "water_vapor_path",
        "column_integrated_dQ2",
        np.linspace(0.0, 80.0, 41),
        np.linspace(-2e-3, 2e-3, 41),
    ),
]


def _left_bucket(values, bins) -> torch.Tensor:
    """The reference's joint-histogram bin of each value: the left-side
    ``searchsorted`` less one, clipped to the bins (values outside the
    edges, NaN among them, land in the outer bins)."""
    edges = tensor(bins, like=values, dtype=torch.float64)
    i = torch.searchsorted(edges, values.to(torch.float64).contiguous())
    return torch.clamp(i - 1, 0, len(bins) - 2)


@registry_2d.register("hist_2d")
def hist2d(arg: DiagArg):
    out = {}
    for xname, yname, xbins, ybins in _HIST2D_PAIRS:
        if xname not in arg.prediction or yname not in arg.prediction:
            continue
        xi = _left_bucket(_d(arg.prediction[xname]).reshape(-1), xbins)
        yi = _left_bucket(_d(arg.prediction[yname]).reshape(-1), ybins)
        nx, ny = len(xbins) - 1, len(ybins) - 1
        counts = torch.bincount(xi * ny + yi, minlength=nx * ny).to(
            torch.float32).reshape(nx, ny)
        out[f"{xname}_vs_{yname}"] = Quantity(
            counts / torch.clamp(counts.sum(), min=1),
            (f"{xname}_bins", f"{yname}_bins"), "fraction",
            attrs={"x_edges": xbins.tolist(), "y_edges": ybins.tolist()},
        )
    return out


@registry_2d.register("hist_2d_bias")
def hist2d_bias(arg: DiagArg):
    out = {}
    if arg.verification is None:
        return out
    pred = hist2d(arg)
    ver = hist2d(
        DiagArg(prediction=arg.verification, verification=None,
                grid=arg.grid)
    )
    for key in pred:
        if key in ver:
            out[key] = Quantity(
                pred[key].data - ver[key].data,
                pred[key].dims, "fraction", attrs=pred[key].attrs,
            )
    return out


def _streamfunction(arg: DiagArg, q) -> Quantity:
    from fv3net_torch.ops import thermo

    delp_q = arg.prediction.data_vars.get(
        "pressure_thickness_of_atmospheric_layer")
    v = _time_mean(_d(q))  # (tile, z, y, x)
    if delp_q is not None:
        pmid = _time_mean(_d(delp_q))
        pressure = torch.cumsum(pmid.mean(dim=(0, 2, 3)), dim=0)  # [z]
    else:
        pressure = torch.linspace(1e4, 1e5, v.shape[1], dtype=v.dtype,
                                  device=v.device)
    vz, centers = stats.zonal_average_approximate(
        v.movedim(1, 0), arg.grid["lat"], arg.grid["area"]
    )  # (z, latitude)
    psi = thermo.mass_streamfunction(
        vz.movedim(0, -1), pressure, centers, axis=-1
    )
    return Quantity(
        psi.movedim(-1, 0), ("z", "latitude"), "Gkg/s",
        attrs={"latitude": centers.tolist()},
    )


@registry_3d.register("mass_streamfunction_value")
def mass_streamfunction_value(arg: DiagArg):
    """(reference compute.py time_dependent_mass_streamfunction)"""
    out = {}
    if "northward_wind" not in arg.prediction:
        return out
    q = arg.prediction["northward_wind"]
    # the reference's condition, kept: a 3-D wind (or one off the cube)
    if "z" in q.dims or not _HORIZ.issubset(q.dims):
        out["northward_wind"] = _streamfunction(arg, q)
    return out


@registry_3d.register("mass_streamfunction_bias")
def mass_streamfunction_bias(arg: DiagArg):
    out = {}
    if arg.verification is None:
        return out
    if (
        "northward_wind" not in arg.prediction
        or "northward_wind" not in arg.verification
    ):
        return out
    q = arg.prediction["northward_wind"]
    qv = arg.verification["northward_wind"]
    if "z" not in q.dims or not _HORIZ.issubset(q.dims):
        return out
    a = _streamfunction(arg, q)
    b = _streamfunction(
        DiagArg(prediction=arg.verification, verification=None,
                grid=arg.grid),
        qv,
    )
    out["northward_wind"] = Quantity(a.data - b.data, a.dims, a.units,
                                     attrs=a.attrs)
    return out


def _register_masked_diurnal(mask_type: str):
    """(reference diurnal cycles per mask type)"""

    @registry_2d.register(f"diurnal_cycle_{mask_type}")
    def diurnal_masked(arg: DiagArg):
        out = {}
        hb = _solar_hour_bins(arg)
        if hb is None:
            return out
        area = arg.grid["area"]
        mask = arg.grid["land_sea_mask"]
        for var, q in arg.prediction.items():
            if not _cube_2d(q):
                continue
            arr = stats.mask_to_surface_type(_d(q), mask, mask_type)
            nan = torch.isnan(arr)
            w = torch.where(nan, 0.0, area)
            out[var] = _diurnal(torch.where(nan, 0.0, arr), w, hb, q.units)
        return out


for _mask_type in ("land", "sea"):
    _register_masked_diurnal(_mask_type)


def compute_all(
    prediction: Dataset,
    grid: Dict[str, np.ndarray],
    verification: Optional[Dataset] = None,
    device="cuda",
) -> Dict[str, Quantity]:
    """Run both registries over the run output on ``device`` (the
    ``prognostic-run-diags compute`` core); the outputs are tensors
    there."""
    arg = DiagArg(prediction=on_device(prediction, device),
                  verification=on_device(verification, device),
                  grid=grid_on(grid, device))
    out = dict(registry_2d.compute(arg))
    out.update(registry_3d.compute(arg))
    return out
