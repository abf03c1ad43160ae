"""Physics driver: radiation -> surface -> PBL -> convection ->
microphysics (port of ``fv3net_tpu/physics/driver.py``).

Operates on the dycore state ([6, nz, ny, nx]); internally moves z last
so every scheme is batched over all 6*ny*nx columns.  Diagnostics keep
the reference's names (PRATEsfc, LHTFLsfc, ...).

Ported: gray radiation (with the sea-ice albedo blend) or a
``radiation_fn`` override (the RRTMG band solvers reach the step that
way, built by ``runtime/fused.py``, and take the land mask and ice
fraction), stratospheric eddy damping, Monin-Obukhov or bulk surface
with the land fraction and evaporation factor of the surface models,
K-profile or ramp PBL, orographic gravity-wave drag (``sgh``),
Betts-Miller or mass-flux deep convection with the shallow mass-flux
stage, Zhao-Carr microphysics.  GFDL microphysics, the emulator hooks,
ozone and stratospheric water raise ``NotImplementedError``; the
reference's off-by-default switches (thermal top sponge, turning
convection off) are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from fv3net_torch.core.constants import (
    CP_AIR,
    GRAVITY,
    KAPPA,
    REFERENCE_SURFACE_PRESSURE,
)
from fv3net_torch.dycore.state import (
    DycoreState,
    temperature_from_theta_v,
    theta_v_from_temperature,
)
from fv3net_torch.ops import thermo
from fv3net_torch.physics import convection as conv
from fv3net_torch.physics import convection_mf as cmf
from fv3net_torch.physics import gravity_wave_drag as gwd_mod
from fv3net_torch.physics import microphysics as mp
from fv3net_torch.physics import pbl as pbl_mod
from fv3net_torch.physics import radiation_gray as rad
from fv3net_torch.physics import surface as sfc
from fv3net_torch.physics import surface_layer as sl_mod


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """The reference's defaults for the ported schemes; selecting an
    unported scheme raises in :func:`physics_step`."""

    ptop: float = 300.0
    # "gray" (computed here) or "rrtmg" (the band solvers of
    # physics/radiation/rrtmg, handed in as ``radiation_fn`` by
    # runtime/fused.py)
    radiation_scheme: str = "gray"
    radiation: rad.GrayRadiationParams = rad.GrayRadiationParams()
    surface: sfc.SurfaceParams = sfc.SurfaceParams()
    pbl: pbl_mod.PBLParams = pbl_mod.PBLParams()
    surface_scheme: str = "monin_obukhov"  # or "bulk"
    pbl_scheme: str = "kprofile"  # or "ramp"
    surface_layer: sl_mod.SurfaceLayerParams = sl_mod.SurfaceLayerParams()
    kprofile: pbl_mod.KProfileParams = pbl_mod.KProfileParams()
    microphysics: mp.MicrophysicsParams = mp.MicrophysicsParams()
    microphysics_scheme: str = "zhao_carr"  # "gfdl" is not ported yet
    convection: conv.ConvectionParams = conv.ConvectionParams()
    convection_scheme: str = "betts_miller"  # or "mass_flux"
    mass_flux: cmf.MassFluxParams = cmf.MassFluxParams()
    shallow: cmf.MassFluxParams = cmf.SHALLOW_PARAMS
    # orographic gravity-wave drag, active where the caller passes a
    # subgrid-orography field (physics_step's ``sgh``)
    gwd: gwd_mod.GWDParams = gwd_mod.GWDParams()
    use_gwd: bool = True
    stratospheric_h2o: bool = False  # True is not ported yet
    # stratospheric eddy damping toward the per-level global mean
    strat_eddy_damp_days: float = 1.0
    strat_eddy_damp_pa: float = 25000.0
    # bulk TOA calibration of the synthetic k-tables: the rrtmg solar
    # constant is 1368.22 * solcon_scale
    solcon_scale: float = 0.973


def _zlast(x):
    """[6, nz, ny, nx] -> [6, ny, nx, nz]."""
    return x.movedim(1, -1)


def _zmid(x):
    return x.movedim(-1, 1)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to fv3net_torch yet")


def physics_step(
    state: DycoreState,
    t_surface: torch.Tensor,  # [6, ny, nx]
    cos_zenith: torch.Tensor,  # [6, ny, nx]
    lat: torch.Tensor,  # [6, ny, nx] radians
    dt: float,
    cfg: PhysicsConfig = PhysicsConfig(),
    microphysics_emulator=None,
    gscond_emulator=None,
    radiation_fn=None,
    sgh=None,  # [6, ny, nx] subgrid-orography std (m) enables GWD
    evap_factor=None,  # [6, ny, nx] land evaporation efficiency
    land_frac=None,  # [6, ny, nx] land fraction
    ice_frac=None,  # [6, ny, nx] sea-ice fraction (albedo feedback)
) -> Tuple[DycoreState, Dict[str, torch.Tensor]]:
    """Apply one physics interval; returns (new_state, diagnostics).

    ``radiation_fn``: optional (T, delp, q, qc, t_surface, cos_zenith,
    lat, o3=, land=, ice=) -> (heating, diags) override of the gray
    scheme (the fused chunk passes its cached radiation this way).  The
    emulator hooks raise ``NotImplementedError``.
    """
    if cfg.microphysics_scheme != "zhao_carr":
        raise _not_ported(f"microphysics_scheme={cfg.microphysics_scheme!r}")
    if microphysics_emulator is not None or gscond_emulator is not None:
        raise _not_ported("the microphysics emulator hooks")
    if cfg.stratospheric_h2o:
        raise _not_ported("stratospheric_h2o (physics/h2ophys.py)")
    if "o3mr" in state.tracers:
        raise _not_ported("ozone photochemistry (physics/ozone.py)")
    if radiation_fn is None and cfg.radiation_scheme != "gray":
        raise ValueError(
            f"radiation_scheme={cfg.radiation_scheme!r} needs a radiation_fn "
            "(runtime/fused.py builds it)"
        )

    dtype = state.pt.dtype
    t_surface = t_surface.to(dtype)
    cos_zenith = cos_zenith.to(dtype)
    lat = lat.to(dtype)
    if sgh is not None:
        sgh = sgh.to(dtype)
    if evap_factor is not None:
        evap_factor = evap_factor.to(dtype)
    if land_frac is not None:
        land_frac = land_frac.to(dtype)
    if ice_frac is not None:
        ice_frac = ice_frac.to(dtype)

    delp = _zlast(state.delp)
    pt = _zlast(state.pt)
    q = _zlast(state.tracers["sphum"])
    qc = _zlast(state.tracers["cloud_water"])
    wind = torch.stack([_zlast(state.wind[c]) for c in range(3)])

    pe = thermo.pressure_at_interface(delp, toa_pressure=cfg.ptop)
    pmid = thermo.pressure_at_midpoint_log(delp, toa_pressure=cfg.ptop)
    T = temperature_from_theta_v(pt, pmid, q)
    T0, q0 = T, q

    # ---- radiation ------------------------------------------------------
    if radiation_fn is not None:
        heating, rad_diags = radiation_fn(
            T, delp, q, qc, t_surface, cos_zenith, lat, o3=None,
            land=land_frac, ice=ice_frac,
        )
    else:
        albedo = None
        if ice_frac is not None:
            # sea-ice albedo feedback: the broadband ice albedo blended
            # over the icy fraction
            albedo = (cfg.radiation.albedo
                      + ice_frac * (0.60 - cfg.radiation.albedo))
        heating, rad_diags = rad.gray_radiation(
            T, delp, t_surface, cos_zenith, lat, cfg.radiation,
            albedo=albedo,
        )
    T = T + dt * heating

    if cfg.strat_eddy_damp_days > 0:
        # relax toward the per-level global mean (mean-preserving eddy
        # damping of the stratosphere)
        w_ed = torch.clamp(
            (cfg.strat_eddy_damp_pa - pmid) / cfg.strat_eddy_damp_pa,
            0.0, 1.0,
        )
        t_bar = T.mean(dim=tuple(range(T.ndim - 1)))  # [nz]
        rate = w_ed * (dt / (cfg.strat_eddy_damp_days * 86400.0))
        T = T + rate * (t_bar - T)

    # ---- surface fluxes -------------------------------------------------
    wind_sfc = wind[..., -1]
    speed = torch.sqrt((wind_sfc ** 2).sum(dim=0))
    if cfg.surface_scheme == "monin_obukhov":
        fluxes = sl_mod.monin_obukhov_fluxes(
            T[..., -1], q[..., -1], pe[..., -1], delp[..., -1], speed,
            t_surface, cfg.surface_layer, land_frac=land_frac,
            evap_factor=evap_factor,
        )
    else:
        fluxes = sfc.bulk_surface_fluxes(
            T[..., -1], q[..., -1], pe[..., -1], delp[..., -1], speed,
            t_surface, cfg.surface, evap_factor=evap_factor,
        )
    mass_sfc = delp[..., -1] / GRAVITY
    T = T.clone()
    T[..., -1] += dt * fluxes["SHTFLsfc"] / (CP_AIR * mass_sfc)
    q = q.clone()
    q[..., -1] += dt * fluxes["evaporation"] / mass_sfc
    drag = torch.exp(-dt * fluxes["drag_factor"])
    wind = wind.clone()
    wind[..., -1] *= drag[None]

    # ---- PBL implicit diffusion ----------------------------------------
    dz = torch.abs(thermo.hydrostatic_dz(T, q, delp, toa_pressure=cfg.ptop))
    dz_if = 0.5 * (dz[..., :-1] + dz[..., 1:])
    dm = thermo.layer_mass(delp)
    theta_d = T * (REFERENCE_SURFACE_PRESSURE / pmid) ** KAPPA
    hpbl = None
    if cfg.pbl_scheme == "kprofile" and "ustar" in fluxes:
        thv = thermo.virtual_temperature(theta_d, q)
        spd_prof = torch.sqrt((wind ** 2).sum(dim=0))
        K_m, K_h, gamma, hpbl = pbl_mod.kprofile_diffusivity(
            thv, spd_prof, dz, fluxes["ustar"], fluxes["obukhov_inv"],
            fluxes["hpbl_flux"], cfg.kprofile,
        )
        # explicit countergradient (nonlocal) heat flux within the PBL
        rho_if = 0.5 * (dm[..., :-1] + dm[..., 1:]) / torch.clamp(
            dz_if, min=1e-3
        )
        F = rho_if * K_h * gamma
        zero = torch.zeros_like(F[..., :1])
        F_pad = torch.cat([zero, F, zero], dim=-1)
        theta_d = theta_d + dt * (F_pad[..., 1:] - F_pad[..., :-1]) / dm
    else:
        sigma_if = pe[..., 1:-1] / pe[..., -1:]
        K_m = K_h = pbl_mod.diffusivity_profile(sigma_if, cfg.pbl)
    theta_d = pbl_mod.implicit_diffusion(theta_d, K_h, dz_if, dm, dt)
    T = theta_d * (pmid / REFERENCE_SURFACE_PRESSURE) ** KAPPA
    q = pbl_mod.implicit_diffusion(q, K_h, dz_if, dm, dt)
    wind = torch.stack([
        pbl_mod.implicit_diffusion(wind[c], K_m, dz_if, dm, dt)
        for c in range(3)
    ])

    # ---- orographic gravity-wave drag -----------------------------------
    gwd_on = cfg.use_gwd and sgh is not None
    if gwd_on:
        dwind, tau_gwd = gwd_mod.orographic_gwd(
            wind, T, delp, pmid, sgh, dt, cfg.gwd
        )
        wind = wind + dt * dwind

    # ---- moist convection -----------------------------------------------
    if cfg.convection_scheme == "mass_flux":
        T, q, qc_det, conv_precip, dwind = cmf.mass_flux_convection(
            T, q, pmid, delp, dt, cfg.mass_flux, wind=wind
        )
        qc = qc + qc_det
        wind = wind + dwind
    else:
        T, q, conv_precip = conv.betts_miller(
            T, q, pmid, delp, dt, cfg.convection
        )
    # shallow stage: detrains condensate into qc
    T, q, qc_det_sh, p_sh, dwind_sh = cmf.mass_flux_convection(
        T, q, pmid, delp, dt, cfg.shallow, wind=wind
    )
    qc = qc + qc_det_sh
    conv_precip = conv_precip + p_sh
    wind = wind + dwind_sh

    # ---- microphysics ---------------------------------------------------
    T, q, qc, precip, snow = mp.microphysics_step(
        T, q, qc, pmid, delp, dt, cfg.microphysics
    )

    extra_tracers = {
        k: v for k, v in state.tracers.items()
        if k not in ("sphum", "cloud_water")
    }
    pt_new = theta_v_from_temperature(T, pmid, q)
    new_state = DycoreState(
        delp=state.delp,
        pt=_zmid(pt_new),
        wind=torch.stack([_zmid(wind[c]) for c in range(3)]),
        tracers={
            **extra_tracers,
            "sphum": _zmid(q),
            "cloud_water": _zmid(qc),
        },
        phis=state.phis,
    )

    diags = dict(rad_diags)
    if gwd_on:
        diags["taugwd"] = tau_gwd  # launched mountain-wave stress, N/m^2
    if hpbl is not None:
        diags["HPBLsfc"] = hpbl
    diags["PRATEsfc"] = precip + conv_precip
    diags["CPRATsfc"] = conv_precip
    diags["SNOWsfc"] = snow
    diags["LHTFLsfc"] = fluxes["LHTFLsfc"]
    diags["SHTFLsfc"] = fluxes["SHTFLsfc"]
    diags["evaporation"] = fluxes["evaporation"]
    diags["tendency_of_air_temperature_due_to_fv3_physics"] = _zmid(
        (T - T0) / dt
    )
    diags["tendency_of_specific_humidity_due_to_fv3_physics"] = _zmid(
        (q - q0) / dt
    )
    return new_state, diags
