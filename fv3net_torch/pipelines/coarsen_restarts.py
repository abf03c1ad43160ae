"""Restart and model-state coarsening, C384 -> C48 and the like (port of
``fv3net_tpu/pipelines/coarsen_restarts.py``; reference:
external/vcm/vcm/cubedsphere/coarsen_restarts.py).

    python -m fv3net_torch.pipelines.coarsen_restarts SRC DST --factor 8 \
        [--method sigma|pressure|blended] [--device cpu]

The state is [tile, z, y, x] with Cartesian A-grid winds.  Every weighted
block average goes through
:func:`fv3net_torch.ops.coarsen.weighted_block_average`, the kernel K5 on
CUDA tensors (mass weights delp * area of the state's full shape, area
planes shared by the levels, and on pressure levels area weights masked
to 0 below the fine surface); the vertical regrid is
:mod:`fv3net_torch.ops.regridz`.
"""
from __future__ import annotations

from typing import Dict

import torch

from fv3net_torch.core.constants import TOA_PRESSURE
from fv3net_torch.dycore.state import DycoreState
from fv3net_torch.ops import coarsen as _c
from fv3net_torch.ops import regridz as _r
from fv3net_torch.ops import thermo
from fv3net_torch.pipelines import resolve_device


def coarsen_state_on_sigma(
    state: DycoreState, area: torch.Tensor, factor: int
) -> DycoreState:
    """Coarsen on sigma surfaces: mass (area*delp) weighted block averages
    for thermodynamic fields and winds, area-weighted delp."""
    area4 = area[:, None]  # broadcast over z
    delp_c = _c.weighted_block_average(state.delp, area4, factor)
    mass = state.delp * area4
    pt_c = _c.weighted_block_average(state.pt, mass, factor)
    tracers_c = {
        k: _c.weighted_block_average(v, mass, factor)
        for k, v in state.tracers.items()
    }
    wind_c = torch.stack(
        [
            _c.weighted_block_average(state.wind[c], mass, factor)
            for c in range(3)
        ]
    )
    phis_c = _c.weighted_block_average(state.phis, area, factor)
    return DycoreState(
        delp=delp_c, pt=pt_c, wind=wind_c, tracers=tracers_c, phis=phis_c
    )


def coarsen_state_on_pressure(
    state: DycoreState, area: torch.Tensor, factor: int,
    toa_pressure: float = TOA_PRESSURE,
) -> DycoreState:
    """Coarsen on pressure surfaces: regrid every 3-D field vertically to
    the coarse cell's pressure coordinate, with the area weights masked
    below the fine surface, then area-weighted block averages.  A coarse
    level whose block lies wholly below the fine surface has no weight,
    and its average is NaN (0 / 0), as in the reference."""
    def zlast(x):
        return x.movedim(1, -1)

    def zmid(x):
        return x.movedim(-1, 1)

    delp = zlast(state.delp)
    fields = {"pt": zlast(state.pt)}
    for k, v in state.tracers.items():
        fields[f"tracer_{k}"] = zlast(v)
    for c in range(3):
        fields[f"wind_{c}"] = zlast(state.wind[c])

    regridded, masked_w = _r.regrid_to_area_weighted_pressure(
        fields, delp, area, factor, toa_pressure=toa_pressure
    )
    # masked area-weighted block average on the coarse pressure coordinate
    w = zmid(masked_w).contiguous()  # [tile, z, y, x]

    def avg(name):
        return _c.weighted_block_average(zmid(regridded.pop(name)), w,
                                         factor)

    delp_c = _c.weighted_block_average(state.delp, area[:, None], factor)
    pt_c = avg("pt")
    tracers_c = {k: avg(f"tracer_{k}") for k in state.tracers}
    wind_c = torch.stack([avg(f"wind_{c}") for c in range(3)])
    phis_c = _c.weighted_block_average(state.phis, area, factor)
    return DycoreState(
        delp=delp_c, pt=pt_c, wind=wind_c, tracers=tracers_c, phis=phis_c
    )


def impose_hydrostatic_balance(T, q, delp, toa_pressure: float = TOA_PRESSURE):
    """Recompute layer thickness dz from T, q, delp hydrostatically; z-last
    tensors."""
    return thermo.hydrostatic_dz(T, q, delp, toa_pressure=toa_pressure)


def coarsen_surface_simple(fields: Dict[str, torch.Tensor], area,
                           factor: int):
    """Area-weighted coarsening of continuous surface fields."""
    return {
        k: _c.weighted_block_average(v, area, factor)
        for k, v in fields.items()
    }


def coarsen_surface_complex(
    continuous: Dict[str, torch.Tensor],
    categorical: Dict[str, torch.Tensor],
    area,
    factor: int,
):
    """Dominant-surface-type coarsening: categorical fields take the
    blockwise mode; continuous fields an area-weighted mean restricted to
    cells of the dominant category where a category field named 'slmsk'
    exists."""
    cat_c = {k: _c.block_mode(v, factor) for k, v in categorical.items()}
    if "slmsk" in categorical:
        dominant = _c.block_upsample(cat_c["slmsk"], factor)
        match = (categorical["slmsk"] == dominant).to(area.dtype)
        w = area * match
        cont_c = {
            k: _c.weighted_block_average(v, w, factor)
            for k, v in continuous.items()
        }
    else:
        cont_c = coarsen_surface_simple(continuous, area, factor)
    return {**cont_c, **cat_c}


# ---------------------------------------------------------------- blended
SIGMA_BLEND = 0.9


def compute_blending_weights(
    delp: torch.Tensor, area: torch.Tensor, factor: int,
    toa_pressure: float = TOA_PRESSURE,
) -> torch.Tensor:
    """Blending weights b per coarse cell and level (1: pressure-level
    coarsening, 0: model-level): 1 above the blending pressure (0.9 x the
    block's smallest fine surface pressure), tapering linearly in pressure
    to 0 at the coarse surface.  delp [tile, z, y, x]; returns
    [tile, z, yc, xc]."""
    delp_c = _c.weighted_block_average(delp, area[:, None], factor)
    pfull_c = thermo.pressure_at_midpoint_log(
        delp_c.movedim(1, -1), toa_pressure=toa_pressure
    ).movedim(-1, 1)
    ps = toa_pressure + delp.sum(dim=1)
    ps_c = toa_pressure + delp_c.sum(dim=1)
    p_blend = SIGMA_BLEND * _c.block_min(ps, factor)
    w = (ps_c[:, None] - pfull_c) / (ps_c[:, None] - p_blend[:, None])
    return torch.where(pfull_c > p_blend[:, None], w, 1.0)


def coarsen_state_blended(
    state: DycoreState, area: torch.Tensor, factor: int,
    toa_pressure: float = TOA_PRESSURE,
) -> DycoreState:
    """Blended pressure-level / model-level coarsening: the free
    atmosphere takes the pressure-level regrid, the levels near the
    surface the model-level averages, combined per level by
    :func:`compute_blending_weights`.  A NaN of the pressure-level path
    stays NaN in the blend, as in the reference."""
    on_p = coarsen_state_on_pressure(
        state, area, factor, toa_pressure=toa_pressure
    )
    on_m = coarsen_state_on_sigma(state, area, factor)
    b = compute_blending_weights(
        state.delp, area, factor, toa_pressure=toa_pressure
    )

    def blend(p, m):
        return b * p + (1.0 - b) * m

    return DycoreState(
        delp=on_m.delp,  # both methods area-average delp identically
        pt=blend(on_p.pt, on_m.pt),
        wind=torch.stack(
            [blend(on_p.wind[c], on_m.wind[c]) for c in range(3)]
        ),
        tracers={
            k: blend(on_p.tracers[k], on_m.tracers[k])
            for k in state.tracers
        },
        phis=on_m.phis,
    )


# --------------------------------------------------- complex sfc_data
FREEZING_TEMPERATURE = 273.16
SHDMIN_THRESHOLD = 0.011
STYPE_LAND_ICE = 16.0
VTYPE_LAND_ICE = 15.0

# per-field coarsening rule (reference SFC_DATA_COARSENING_METHOD,
# coarsen_restarts.py:1368-1402); slmsk/vtype/stype are precomputed
SFC_DATA_COARSENING_METHOD = {
    "tsea": "area", "alvsf": "area", "alvwf": "area", "alnsf": "area",
    "alnwf": "area", "facsf": "area", "facwf": "area", "f10m": "area",
    "t2m": "area", "q2m": "area", "uustar": "area", "ffmm": "area",
    "ffhh": "area", "tprcp": "area", "snwdph": "area",
    "tg3": "area_dominant", "vfrac": "area_dominant",
    "fice": "area_dominant", "sncovr": "area_dominant",
    "shdmin": "area_dominant", "shdmax": "area_dominant",
    "snoalb": "area_dominant",
    "canopy": "area_vfrac_dominant_vtype",
    "zorl": "area_vfrac_dominant_vtype",
    "smc": "area_dominant_stype", "slc": "area_dominant_stype",
    "stc": "area_dominant_stype",
    "srflag": "mode", "slope": "mode_dominant",
    "sheleg": "area_sncovr", "hice": "area_fice",
    "tisfc": "area_or_fice",
}


def _masked_avg(v, w, mask, factor):
    """Area-weighted block mean over masked cells; all-masked blocks
    yield NaN like the reference's .where() averages."""
    m = torch.broadcast_to(mask, v.shape).to(v.dtype)
    wb = torch.broadcast_to(w, v.shape) * m
    num = _c.block_sum(v * wb, factor)
    den = _c.block_sum(wb, factor)
    return num / den


def coarsen_sfc_data_complex(
    ds: Dict[str, torch.Tensor], area: torch.Tensor, factor: int
) -> Dict[str, torch.Tensor]:
    """The reference's 'complex' surface coarsening:

    - slmsk by blockwise mode; vtype/stype by mode over cells of the
      dominant surface type;
    - continuous fields by per-field rules (``SFC_DATA_COARSENING_METHOD``):
      plain area weighting, restriction to the dominant surface type
      (tg3/vfrac/fice/...), vegetation-fraction weighting over the
      dominant vtype (canopy/zorl, falling back to area weighting where
      the dominant patch has no vegetation), soil-type restriction for
      smc/slc/stc, snow-cover weighting for sheleg, ice-fraction
      weighting for hice, and the tisfc sea-ice/land-ocean partition;
    - the surface_chgres corrections (clip tsea/tg3 at freezing over
      land ice, force ice soil type, zero canopy on bare land, zero
      shdmin over land ice).

    ds: GFS-named fields [6, (z,) y, x].  Unknown fields fall back to
    area weighting.  Returns the coarsened dict.
    """
    slmsk = ds["slmsk"]
    slmsk_c = _c.block_mode(slmsk, factor)
    dom_sfc = torch.isclose(slmsk, _c.block_upsample(slmsk_c, factor))

    out: Dict[str, torch.Tensor] = {"slmsk": slmsk_c}
    have_veg = "vtype" in ds
    have_soil = "stype" in ds
    if have_veg:
        vtype_c = _c.block_mode(ds["vtype"], factor, where=dom_sfc)
        dom_v = torch.isclose(
            ds["vtype"], _c.block_upsample(vtype_c, factor)
        )
        out["vtype"] = vtype_c
    if have_soil:
        stype_c = _c.block_mode(ds["stype"], factor, where=dom_sfc)
        dom_s = torch.isclose(
            ds["stype"], _c.block_upsample(stype_c, factor)
        )
        out["stype"] = stype_c

    vfrac = ds.get("vfrac")
    sncovr = ds.get("sncovr")
    fice = ds.get("fice")

    for name, v in ds.items():
        if name in out:
            continue
        method = SFC_DATA_COARSENING_METHOD.get(name, "area")
        if v.ndim == 4:  # soil-level fields: broadcast masks over z
            mask = dom_sfc[:, None]
            w = area[:, None]
        else:
            mask = dom_sfc
            w = area
        if method == "area":
            out[name] = _c.weighted_block_average(v, w, factor)
        elif method == "area_dominant":
            out[name] = _masked_avg(v, w, mask, factor)
        elif method == "area_vfrac_dominant_vtype" and have_veg:
            m = dom_sfc & dom_v
            plain = _masked_avg(v, area, m, factor)
            weighted = _masked_avg(v, area * vfrac, m, factor)
            denom = _c.block_sum(
                torch.where(m, area * vfrac, 0.0), factor
            )
            out[name] = torch.where(denom > 0.0, weighted, plain)
        elif method == "area_dominant_stype" and have_soil:
            m = dom_sfc & dom_s
            out[name] = _masked_avg(
                v, w, m[:, None] if v.ndim == 4 else m, factor
            )
        elif method == "mode":
            out[name] = _c.block_mode(v, factor)
        elif method == "mode_dominant":
            out[name] = _c.block_mode(v, factor, where=dom_sfc)
        elif method == "area_sncovr" and sncovr is not None:
            out[name] = torch.nan_to_num(
                _c.weighted_block_average(v, area * sncovr, factor)
            )
        elif method == "area_fice" and fice is not None:
            out[name] = torch.nan_to_num(
                _c.weighted_block_average(v, area * fice, factor)
            )
        elif method == "area_or_fice" and fice is not None:
            sea_ice = _masked_avg(v, area * fice, dom_sfc, factor)
            other = _masked_avg(v, area, dom_sfc, factor)
            out[name] = torch.where(
                torch.isclose(slmsk_c, torch.full_like(slmsk_c, 2.0)),
                sea_ice, other
            )
        else:  # missing auxiliary input: fall back to area weighting
            out[name] = _c.weighted_block_average(v, w, factor)

    return _apply_surface_chgres_corrections(out)


def _apply_surface_chgres_corrections(
    ds: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """surface_chgres.F90 corrections (reference
    coarsen_restarts.py:1405-1470)."""
    out = dict(ds)
    if "vtype" in out:
        is_land_ice = torch.isclose(
            out["vtype"], torch.full_like(out["vtype"], VTYPE_LAND_ICE))
        for key in ("tsea", "tg3"):
            if key in out:
                out[key] = torch.where(
                    is_land_ice,
                    torch.clamp(out[key], max=FREEZING_TEMPERATURE),
                    out[key],
                )
        if "stype" in out:
            out["stype"] = torch.where(
                is_land_ice, STYPE_LAND_ICE, out["stype"]
            )
    if "shdmin" in out and "canopy" in out:
        out["canopy"] = torch.where(
            out["shdmin"] < SHDMIN_THRESHOLD, 0.0, out["canopy"]
        )
    if "vtype" in out and "shdmin" in out:
        out["shdmin"] = torch.where(
            torch.isclose(out["vtype"],
                          torch.full_like(out["vtype"], VTYPE_LAND_ICE)),
            0.0, out["shdmin"]
        )
    return out


def coarsen_restart_dir(src: str, dst: str, factor: int,
                        method: str = "sigma", device="cuda") -> int:
    """Coarsen a reference-layout restart directory ``src`` by ``factor``
    on ``device`` and write it to ``dst`` in the same layout; returns the
    coarse resolution."""
    import datetime as _dt

    from fv3net_torch.grid.geometry import make_grid
    from fv3net_torch.runtime.checkpoint import (
        load_fortran_restarts,
        save_fortran_restarts,
    )
    from fv3net_torch.runtime.derived_state import ModelState

    fn = {
        "sigma": coarsen_state_on_sigma,
        "pressure": coarsen_state_on_pressure,
        "blended": coarsen_state_blended,
    }[method]
    device = resolve_device(device)
    state, time = load_fortran_restarts(src)
    d = state.dycore
    dycore = DycoreState(
        delp=d.delp.to(device), pt=d.pt.to(device), wind=d.wind.to(device),
        tracers={k: v.to(device) for k, v in d.tracers.items()},
        phis=d.phis.to(device))
    n = dycore.delp.shape[-1]
    grid = make_grid(n)
    area = torch.as_tensor(grid.area, dtype=dycore.delp.dtype,
                           device=device)
    dycore_c = fn(dycore, area, factor)
    surface_c = {
        k: _c.weighted_block_average(v.to(device), area, factor)
        for k, v in state.surface.items()
    }
    grid_c = make_grid(n // factor)
    save_fortran_restarts(
        ModelState(dycore=dycore_c, surface=surface_c),
        time or _dt.datetime(2000, 1, 1),
        dst,
        grid_c,
    )
    return n // factor


def main(argv=None) -> int:
    """Coarsen a reference-layout restart directory to a lower resolution
    and write it back in the same layout (the reference's Beam job
    ``python -m fv3net.pipelines.coarsen_restarts``)."""
    import argparse
    import json

    p = argparse.ArgumentParser(prog="coarsen_restarts")
    p.add_argument("src", help="restart dir (fv_core.res.tileN.nc ...)")
    p.add_argument("dst", help="output restart dir")
    p.add_argument("--factor", type=int, required=True)
    p.add_argument(
        "--method", choices=("sigma", "pressure", "blended"),
        default="sigma",
    )
    p.add_argument("--device", default="cuda",
                   help="where the coarsening runs (default: the card)")
    args = p.parse_args(argv)
    resolution = coarsen_restart_dir(args.src, args.dst, args.factor,
                                     args.method, device=args.device)
    print(json.dumps({"src": args.src, "dst": args.dst,
                      "resolution": resolution}))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
