"""Checkpoint and restart: model state <-> disk (port of
``fv3net_tpu/runtime/checkpoint.py``).

A restart is ``state.npz`` (the whole state, by the reference's keys)
with a ``restart.json`` of its time and its tracer and surface names,
the format of the reference package: each package reads the other's
restarts.  ``save_fortran_restarts`` also writes the reference's
per-category, per-tile classic-NetCDF layout (``fv_core.res.tileN.nc``
... and ``coupler.res``), and ``load_fortran_restarts`` starts a run
from such a directory.  A restart written from the card copies the
state to the host once (:func:`pull_state`).
"""
from __future__ import annotations

import datetime
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fv3net_torch.core.constants import TOA_PRESSURE
from fv3net_torch.dycore.state import DycoreState
from fv3net_torch.runtime import timing
from fv3net_torch.runtime.derived_state import ModelState

_STATE_FILE = "state.npz"
_META_FILE = "restart.json"


def _state_arrays(state: ModelState) -> Dict[str, torch.Tensor]:
    """The state's tensors by their ``state.npz`` keys."""
    d = state.dycore
    arrays = {"delp": d.delp, "pt": d.pt, "wind": d.wind, "phis": d.phis}
    if d.w is not None:
        arrays["w"] = d.w
        arrays["delz"] = d.delz
    for k, v in d.tracers.items():
        arrays[f"tracer_{k}"] = v
    for k, v in state.surface.items():
        arrays[f"surface_{k}"] = v
    return arrays


def _state_from_arrays(z, tracers, surface) -> ModelState:
    dycore = DycoreState(
        delp=z["delp"], pt=z["pt"], wind=z["wind"],
        tracers={k: z[f"tracer_{k}"] for k in tracers},
        phis=z["phis"], w=z.get("w"), delz=z.get("delz"),
    )
    return ModelState(dycore=dycore,
                      surface={k: z[f"surface_{k}"] for k in surface})


def pull_state(state: ModelState) -> ModelState:
    """The whole state as CPU tensors through ONE device->host copy per
    dtype (the state has one): the tensors are raveled and concatenated
    on their device first."""
    arrays = _state_arrays(state)
    host: Dict[str, torch.Tensor] = {}
    for dtype in {a.dtype for a in arrays.values()}:
        keys = [k for k, a in arrays.items() if a.dtype == dtype]
        flat = torch.cat([arrays[k].reshape(-1) for k in keys]).cpu()
        off = 0
        for k in keys:
            n = arrays[k].numel()
            host[k] = flat[off:off + n].reshape(arrays[k].shape)
            off += n
    return _state_from_arrays(host, state.dycore.tracers, state.surface)


def save_state(state: ModelState, time: datetime.datetime, path: str) -> None:
    """``state.npz`` + ``restart.json`` in ``path`` (a state on the card
    is pulled first)."""
    os.makedirs(path, exist_ok=True)
    arrays = {k: v.cpu().numpy()
              for k, v in _state_arrays(pull_state(state)).items()}
    timing.add_counter(
        "restart_bytes", float(sum(a.nbytes for a in arrays.values()))
    )
    np.savez(os.path.join(path, _STATE_FILE), **arrays)
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(
            {
                "time": time.isoformat(),
                "tracers": list(state.dycore.tracers),
                "surface": list(state.surface),
            },
            f,
        )


def restart_time(path: str) -> datetime.datetime:
    """The model time of the restart in ``path`` (its ``restart.json``)."""
    with open(os.path.join(path, _META_FILE)) as f:
        return datetime.datetime.fromisoformat(json.load(f)["time"])


def load_state(path: str) -> Tuple[ModelState, datetime.datetime]:
    """The restart in ``path`` as CPU tensors of the dtype it was saved
    in, and its time."""
    with open(os.path.join(path, _META_FILE)) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, _STATE_FILE)) as z:
        arrays = {k: torch.from_numpy(z[k]) for k in z.files}
    return (
        _state_from_arrays(arrays, meta["tracers"], meta["surface"]),
        datetime.datetime.fromisoformat(meta["time"]),
    )


# ---------------------------------------------------------------------------
# reference-layout Fortran restart files
# ---------------------------------------------------------------------------

# GFS tracer naming in fv_tracer.res files
_TRACER_NAMES = {"sphum": "sphum", "cloud_water": "liq_wat"}
_TRACER_NAMES_INV = {v: k for k, v in _TRACER_NAMES.items()}
# GFS sfc_data names of the surface fields
_SFC_NAMES = {"surface_temperature": "tsea", "land_sea_mask": "slmsk",
              "ice_thickness": "hice", "deep_soil_temperature": "tg3"}
_SFC_NAMES_INV = {v: k for k, v in _SFC_NAMES.items()}


def _pmid(delp: torch.Tensor) -> torch.Tensor:
    """Log-mean midlayer pressure of [6, nz, ny, nx] layers."""
    pe = torch.cat(
        [torch.full_like(delp[:, :1], TOA_PRESSURE),
         TOA_PRESSURE + torch.cumsum(delp, dim=1)],
        dim=1,
    )
    return delp / (torch.log(pe[:, 1:]) - torch.log(pe[:, :-1]))


def save_fortran_restarts(
    state: ModelState, time: datetime.datetime, path: str, grid
) -> None:
    """Write the state in the reference's per-category, per-tile
    classic-NetCDF restart layout (fv_core.res.tileN.nc,
    fv_tracer.res.tileN.nc, fv_srf_wnd.res.tileN.nc, sfc_data.tileN.nc
    and coupler.res), as the reference package writes it: winds as
    A-grid eastward/northward components, no phy_data category."""
    from fv3net_torch.core.dataset import Dataset
    from fv3net_torch.core.netcdfio import write_netcdf
    from fv3net_torch.core.quantity import Quantity
    from fv3net_torch.dycore.state import temperature_from_theta_v
    from fv3net_torch.physics.sea_ice import ice_fraction

    os.makedirs(path, exist_ok=True)
    state = pull_state(state)
    d = state.dycore
    T = temperature_from_theta_v(d.pt, _pmid(d.delp),
                                 d.tracers["sphum"]).numpy()
    east = np.moveaxis(grid.east, -1, 0)  # [3, 6, n, n]
    north = np.moveaxis(grid.north, -1, 0)
    wind = d.wind.numpy()  # [3, 6, nz, n, n]
    u = (wind * east[:, :, None]).sum(axis=0)
    v = (wind * north[:, :, None]).sum(axis=0)
    delp, phis = d.delp.numpy(), d.phis.numpy()
    # by sorted name, the order in which the reference's files hold them
    tracers = {k: d.tracers[k].numpy() for k in sorted(d.tracers)}
    surface = {k: state.surface[k].numpy() for k in sorted(state.surface)}
    fice = (ice_fraction(state.surface["ice_thickness"]).numpy()
            if "ice_thickness" in state.surface else None)

    dims3 = ("Time", "zaxis_1", "yaxis_1", "xaxis_1")
    dims2 = ("Time", "yaxis_1", "xaxis_1")
    dims_soil = ("Time", "zaxis_soil", "yaxis_1", "xaxis_1")

    def q3(a):
        return Quantity(np.asarray(a)[None], dims3)

    def q2(a):
        return Quantity(np.asarray(a)[None], dims2)

    def tile_file(category, t):
        return os.path.join(path, f"{category}.tile{t + 1}.nc")

    for t in range(6):
        core = {"T": q3(T[t]), "delp": q3(delp[t]), "ua": q3(u[t]),
                "va": q3(v[t]), "phis": q2(phis[t])}
        if d.w is not None:
            core["W"] = q3(d.w[t].numpy())
            core["DZ"] = q3(-d.delz[t].numpy())  # FV3 sign
        write_netcdf(Dataset(core), tile_file("fv_core.res", t))
        write_netcdf(
            Dataset({_TRACER_NAMES.get(k, k): q3(a[t])
                     for k, a in tracers.items()}),
            tile_file("fv_tracer.res", t))
        write_netcdf(
            Dataset({"u_srf": q2(u[t, -1]), "v_srf": q2(v[t, -1])}),
            tile_file("fv_srf_wnd.res", t))
        sfc_vars = {}
        for name, arr in surface.items():
            # the Noah fields by their GFS soil-layer names and units:
            # stc/smc carry a leading soil-level axis, sheleg is SWE in mm
            if name == "soil_temperature":
                sfc_vars["stc"] = Quantity(arr[:, t][None], dims_soil)
            elif name == "soil_moisture_layers":
                sfc_vars["smc"] = Quantity(arr[:, t][None], dims_soil)
            elif name == "snow_water_equivalent":
                sfc_vars["sheleg"] = q2(arr[t] * 1000.0)  # m -> mm
            else:
                sfc_vars[_SFC_NAMES.get(name, name)] = q2(arr[t])
        if fice is not None:
            sfc_vars["fice"] = q2(fice[t])
            if "slmsk" in sfc_vars:
                # the GFS 3-value convention: icy ocean -> 2
                land = np.asarray(sfc_vars["slmsk"].data)[0]
                sfc_vars["slmsk"] = q2(
                    np.where((land < 0.5) & (fice[t] > 0.15), 2.0, land)
                )
        if sfc_vars:
            write_netcdf(Dataset(sfc_vars), tile_file("sfc_data", t))
    # coupler.res: FMS calendar and current date (the file segmented
    # runs consult for the segment time)
    stamp = (f"  {time.year:6d}{time.month:6d}{time.day:6d}"
             f"{time.hour:6d}{time.minute:6d}{time.second:6d}")
    with open(os.path.join(path, "coupler.res"), "w") as f:
        f.write("     2        (Calendar: no_calendar=0, thirty_day_months=1, julian=2, gregorian=3, noleap=4)\n")
        f.write(f"{stamp}        Model start time\n")
        f.write(f"{stamp}        Current model time\n")


def dgrid_wind_to_cartesian(u_d, v_d, grid, dtype=torch.float32):
    """Rotate FV3 D-grid restart winds into Cartesian tangent vectors.

    FV3 ``fv_core.res`` u/v (without agrid_vel_rst) are grid-relative
    (covariant) components along the local i/j grid lines: average the
    staggered components to cell centers, then solve the 2x2 dual-basis
    system V.e1 = u, V.e2 = v with e1/e2 the local grid-direction unit
    vectors (non-orthogonal near tile corners).

    u_d: [6, nz, ny+1, nx] (on x-edges), v_d: [6, nz, ny, nx+1]
    (on y-edges); returns wind [3, 6, nz, ny, nx].
    """
    u_d, v_d = np.asarray(u_d), np.asarray(v_d)
    u_cov = 0.5 * (u_d[..., :-1, :] + u_d[..., 1:, :])  # along e1
    v_cov = 0.5 * (v_d[..., :-1] + v_d[..., 1:])  # along e2
    c = grid.corners_xyz

    def _unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    wmid = _unit(c[:, :-1, :-1] + c[:, 1:, :-1])  # west-face midpoints
    emid = _unit(c[:, :-1, 1:] + c[:, 1:, 1:])
    smid = _unit(c[:, :-1, :-1] + c[:, :-1, 1:])
    nmid = _unit(c[:, 1:, :-1] + c[:, 1:, 1:])
    khat = grid.centers_xyz

    def _tangent_unit(d):
        d = d - np.sum(d * khat, axis=-1, keepdims=True) * khat
        return _unit(d)

    e1 = _tangent_unit(emid - wmid)  # [6, ny, nx, 3] +i direction
    e2 = _tangent_unit(nmid - smid)  # +j direction
    cos12 = np.sum(e1 * e2, axis=-1)  # [6, ny, nx]
    det = 1.0 - cos12 ** 2
    # contravariant expansion coefficients: V = a*e1 + b*e2
    a = (u_cov - cos12[:, None] * v_cov) / det[:, None]
    b = (v_cov - cos12[:, None] * u_cov) / det[:, None]

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype)

    e1c = t(np.moveaxis(e1, -1, 0))
    e2c = t(np.moveaxis(e2, -1, 0))
    return e1c[:, :, None] * t(a)[None] + e2c[:, :, None] * t(b)[None]


def load_fortran_restarts(
    path: str, expected_shape=None
) -> Tuple[ModelState, Optional[datetime.datetime]]:
    """A state (CPU tensors of the files' dtype) and its time from a
    reference-layout restart directory: fv_core.res (T -> theta_v, A-grid
    ua/va or D-grid u/v -> Cartesian wind, W/DZ when present),
    fv_tracer.res (GFS tracer names), sfc_data (tsea/slmsk/hice/... ->
    surface fields) and coupler.res for the model time."""
    from fv3net_torch.core import netcdfio
    from fv3net_torch.dycore.state import theta_v_from_temperature
    from fv3net_torch.grid.geometry import make_grid

    cats = netcdfio.open_restarts(path)
    core = cats["fv_core.res"]

    def tile3(name, ds):
        # [tile, Time, z, y, x] -> [6, z, y, x]
        return torch.from_numpy(np.asarray(ds[name].values)[:, 0].copy())

    delp = tile3("delp", core)
    T = tile3("T", core)
    n = delp.shape[-1]
    if expected_shape is not None and tuple(delp.shape) != tuple(expected_shape):
        raise ValueError(
            f"restart shape {tuple(delp.shape)} != model shape "
            f"{tuple(expected_shape)}"
        )

    tracers = {}
    if "fv_tracer.res" in cats:
        tr = cats["fv_tracer.res"]
        for name in tr.keys():
            tracers[_TRACER_NAMES_INV.get(name, name)] = tile3(name, tr)
    tracers.setdefault("sphum", torch.zeros_like(delp))
    tracers.setdefault("cloud_water", torch.zeros_like(delp))
    pt = theta_v_from_temperature(T, _pmid(delp), tracers["sphum"])

    grid = make_grid(n)
    if "ua" in core:
        # A-grid winds (agrid_vel_rst=true) are true eastward/northward
        east = torch.tensor(np.moveaxis(grid.east, -1, 0), dtype=delp.dtype)
        north = torch.tensor(np.moveaxis(grid.north, -1, 0),
                             dtype=delp.dtype)
        wind = (east[:, :, None] * tile3("ua", core)[None]
                + north[:, :, None] * tile3("va", core)[None])
    else:
        wind = dgrid_wind_to_cartesian(
            np.asarray(core["u"].values)[:, 0],  # [6, z, y+1, x]
            np.asarray(core["v"].values)[:, 0],  # [6, z, y, x+1]
            grid, dtype=delp.dtype)

    phis = (torch.from_numpy(np.asarray(core["phis"].values)[:, 0].copy())
            if "phis" in core else torch.zeros_like(delp[:, 0]))
    w = delz = None
    if "W" in core and "DZ" in core:
        w = tile3("W", core)
        delz = -tile3("DZ", core)  # FV3 stores negative thickness

    dycore = DycoreState(delp=delp, pt=pt, wind=wind, tracers=tracers,
                         phis=phis, w=w, delz=delz)
    surface: Dict[str, torch.Tensor] = {}
    if "sfc_data" in cats:
        sfc = cats["sfc_data"]
        for name in sfc.keys():
            arr = torch.from_numpy(np.asarray(sfc[name].values)[:, 0].copy())
            if name in ("stc", "smc"):
                # GFS soil-layer fields [tile, lev, y, x] -> the internal
                # layer-leading layout [lev, tile, y, x]
                key = ("soil_temperature" if name == "stc"
                       else "soil_moisture_layers")
                surface[key] = arr.movedim(1, 0).contiguous()
            elif name == "sheleg":  # SWE mm -> m
                surface["snow_water_equivalent"] = arr / 1000.0
            else:
                surface[_SFC_NAMES_INV.get(name, name)] = arr
        if "land_sea_mask" in surface:
            # GFS slmsk takes {0 ocean, 1 land, 2 sea ice}; every consumer
            # takes mask > 0.5 for land, so land iff slmsk == 1.  Sea-ice
            # points stay ocean and carry their ice through ice_thickness
            # (from hice, or a nominal 1 m where the restart lacks it)
            slmsk = surface["land_sea_mask"]
            is_ice = (slmsk - 2.0).abs() < 0.5
            surface["land_sea_mask"] = ((slmsk - 1.0).abs() < 0.5).to(
                slmsk.dtype)
            hice = surface.get("ice_thickness")
            one, zero = torch.ones_like(slmsk), torch.zeros_like(slmsk)
            if hice is None:
                surface["ice_thickness"] = torch.where(is_ice, one, zero)
            else:
                surface["ice_thickness"] = torch.where(
                    is_ice & (hice <= 0.0), one,
                    torch.where(is_ice, hice, zero))

    time = _read_coupler_res(os.path.join(path, "coupler.res"))
    return ModelState(dycore=dycore, surface=surface), time


def _read_coupler_res(path: str) -> Optional[datetime.datetime]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    # the last date line is the current model time (FMS coupler.res)
    for ln in reversed(lines):
        nums = []
        for p in ln.split():
            try:
                nums.append(int(p))
            except ValueError:
                break
        if len(nums) >= 6:
            return datetime.datetime(*nums[:6])
    return None
