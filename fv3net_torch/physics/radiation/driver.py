"""The synthetic band model's radiation driver (port of
``fv3net_tpu/physics/radiation/driver.py``; reference:
external/radiation/radiation/radiation_driver.py RadiationDriver --
radupdate's astronomy and gas updates and the column pre- and
post-processing around the LW and SW band solvers; output names follow
preprocessing.py RENAME_OUT).

One function of (state columns, time) -> fluxes and heating rates,
clear sky and total sky.  Columns are flattened to [ncol, nz]; z index
0 = model top.  It computes in float32 whatever the state's dtype, as
the reference's does.

McICA draws: :meth:`RadiationDriver.draw_mcica` gives the uniforms of a
call from a ``torch.Generator`` on the driver's device, seeded from
``(mcica_seed, fold)`` with ``fold`` a fold of the state
(:meth:`RadiationDriver.mcica_fold`; the reference keys its
``jax.random`` draws on one); they are not the reference's threefry
numbers, so a comparison replaces the two methods.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fv3net_torch.core.constants import GRAVITY
from fv3net_torch.ops import thermo, zenith
from fv3net_torch.physics.radiation import gases, lw, optics, spectra, sw
from fv3net_torch.physics.radiation import params as P


@dataclasses.dataclass
class DriverConfig:
    """Namelist-style options (iovr/isol/ico2/iaer keep the reference's
    meanings)."""

    iovr: int = 1       # 1 = maximum-random overlap (McICA)
    isol: int = 0       # 0 = fixed solar constant, 1 = +eccentricity cycle
    ico2: int = 0       # 0 = climatological CO2, 1 = linear secular trend
    iaer: int = 1       # 0 = no aerosol, 1 = climatological aerosol
    icld: int = 1       # 0 = clear sky only
    year: int = 2016
    mcica_seed: int = 42


def _planck_gpt(coefs, expand, T):
    """Per-g-point Planck emissive power [W/m^2] at temperatures T[...]:
    coefs [deg+1, nbands], a polynomial in T/T_REF; expand [ngpt,
    nbands], one-hot times the g-point weight."""
    x = T[..., None] / spectra.T_REF
    powers = x ** torch.arange(coefs.shape[0], dtype=T.dtype,
                               device=T.device)
    e_band = powers @ coefs  # [..., nbands]
    return e_band @ expand.T  # [..., ngpt]


def _bands_to_gpts(x, expand):
    """[ncol, nbands, nlay] -> [ncol, ngpt, nlay] through ``expand``
    [ngpt, nbands]."""
    return torch.einsum("lbz,gb->lgz", x, expand)


class RadiationDriver:
    """Builds the spectral data once, on ``device`` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, config: DriverConfig = DriverConfig(),
                 device="cuda"):
        self.config = config
        self.dtype = dtype = torch.float32
        self.device = torch.empty(0, device=device).device
        kd_lw, kd_sw = spectra.lw_kdist(), spectra.sw_kdist()
        self.go_lw = optics.build_gas_optics(kd_lw, P.NBANDS_LW, dtype,
                                             self.device)
        self.go_sw = optics.build_gas_optics(kd_sw, P.NBANDS_SW, dtype,
                                             self.device)

        def t(x):  # float32 values, as the reference stores them
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=self.device).to(dtype)

        self.planck_coefs = t(spectra.planck_band_coefs())
        ex_lw = np.zeros((P.NGPT_LW, P.NBANDS_LW), np.float32)
        ex_lw[np.arange(P.NGPT_LW), kd_lw.band_of_gpt] = 1.0
        self.expand_lw_1 = t(ex_lw)  # band value -> g-point copy
        self.expand_lw = t(ex_lw * kd_lw.gwt[:, None])
        ex_sw = np.zeros((P.NGPT_SW, P.NBANDS_SW), np.float32)
        ex_sw[np.arange(P.NGPT_SW), kd_sw.band_of_gpt] = 1.0
        self.expand_sw_1 = t(ex_sw)
        self.solar_gpt = t(spectra.solar_band_fraction()[kd_sw.band_of_gpt]
                           * kd_sw.gwt)  # sums to 1

    def solar_constant(self, days) -> float:
        """The solar constant; isol gates the orbital eccentricity
        modulation."""
        if self.config.isol == 0:
            return float(np.float32(P.S0))
        return P.S0 * zenith.solar_distance_factor(days)

    def mcica_fold(self, T: torch.Tensor) -> int:
        """The integer a call's McICA draws are keyed on, a fold of the
        columns' temperatures [ncol, nz] (their max, not their sum as the
        reference's: the max does not depend on the reduction order)."""
        return int(torch.fmod(T.abs().max() * 64.0, 1000003.0).item())

    def draw_mcica(self, fold: int, ncol: int,
                   nlay: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """McICA uniforms (u_lw [nlay, ncol, 140], u_sw [nlay, ncol,
        112]) in the compute dtype, from a generator on the driver's
        device seeded with ``(mcica_seed, fold)``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.mcica_seed * 1000003 + int(fold))
        kw = dict(generator=gen, dtype=self.dtype, device=self.device)
        return (torch.rand((nlay, ncol, P.NGPT_LW), **kw),
                torch.rand((nlay, ncol, P.NGPT_SW), **kw))

    def __call__(
        self,
        time: datetime.datetime,
        state: Dict[str, torch.Tensor],
        cosz: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """state: z-last columns -- air_temperature [..., nz],
        pressure_thickness_of_atmospheric_layer [..., nz],
        specific_humidity and cloud_water_mixing_ratio [..., nz]
        (optional), ozone_mixing_ratio (optional; the climatology
        otherwise), surface_temperature, latitude, longitude (radians),
        land_sea_mask and ice_fraction (optional).  ``cosz`` bypasses
        the astronomy.  Returns the RENAME_OUT-named fluxes and heating
        rates and the combined temperature tendency."""
        cfg = self.config
        dt, dev = self.dtype, self.device
        T_in = state["air_temperature"]
        lead, nz = tuple(T_in.shape[:-1]), T_in.shape[-1]
        ncol = int(np.prod(lead)) if lead else 1

        def cols(x):
            x = torch.as_tensor(x, dtype=dt, device=dev)
            return x.reshape((ncol,) + tuple(x.shape[len(lead):]))

        def zeros2d():
            return torch.zeros(lead, dtype=dt, device=dev)

        T = cols(T_in)
        dp = cols(state["pressure_thickness_of_atmospheric_layer"])
        q = (cols(state["specific_humidity"])
             if state.get("specific_humidity") is not None
             else torch.full((ncol, nz), 1e-6, dtype=dt, device=dev))
        qc = (cols(state["cloud_water_mixing_ratio"])
              if state.get("cloud_water_mixing_ratio") is not None
              else torch.zeros((ncol, nz), dtype=dt, device=dev))
        tsfc = cols(state["surface_temperature"])
        lat = cols(state["latitude"])
        lon = cols(state["longitude"])
        land = cols(state.get("land_sea_mask", zeros2d())).clamp(0.0, 1.0)
        ice = cols(state.get("ice_fraction", zeros2d())).clamp(0.0, 1.0)

        plev = thermo.pressure_at_interface(dp)
        play = 0.5 * (plev[..., :-1] + plev[..., 1:])
        tlev = torch.cat([
            T[..., :1] - 0.25 * (T[..., 1:2] - T[..., :1]),
            0.5 * (T[..., :-1] + T[..., 1:]),
            T[..., -1:] + 0.25 * (T[..., -1:] - T[..., -2:-1]),
        ], dim=-1)

        # a prognostic ozone tracer takes precedence over the climatology
        if "ozone_mixing_ratio" in state:
            o3 = cols(state["ozone_mixing_ratio"]).clamp(min=0.0)
        else:
            o3 = gases.ozone_profile(play, lat)
        mmr = {"h2o": q.clamp(min=1e-9), "o3": o3}
        mmr.update(gases.well_mixed(play, cfg.year, cfg.ico2))

        days = zenith.days_from_2000(time)
        if cosz is None:
            cosz = zenith.cos_zenith_angle(days, torch.rad2deg(lon),
                                           torch.rad2deg(lat))
        cosz = cols(cosz)
        s0 = self.solar_constant(days)

        # clouds: condensate -> paths, effective radii, fraction
        t_frac_ice = ((268.0 - T) / 15.0).clamp(0.0, 1.0)
        wpath = qc * dp * (1000.0 / GRAVITY)  # g/m^2 grid mean
        cldfrac = torch.where(qc > 1e-7, 1.0 - torch.exp(-qc / 3.0e-5), 0.0)
        if cfg.icld == 0:
            cldfrac = torch.zeros_like(cldfrac)
        incloud = wpath / cldfrac.clamp(min=0.05)
        lwp = incloud * (1.0 - t_frac_ice)
        iwp = incloud * t_frac_ice
        re_liq = (10.0 * land + 14.0 * (1.0 - land))[:, None].expand_as(lwp)
        re_ice = (326.3 + 12.42 * (T - 273.15)).clamp(20.0, 130.0)
        co = optics.cloud_optics(lwp, iwp, re_liq, re_ice, cldfrac)

        u_lw, u_sw = self.draw_mcica(self.mcica_fold(T), ncol, nz)
        mask_lw = optics.mcica_subcolumns(cldfrac, u_lw, iovr=cfg.iovr)
        mask_sw = optics.mcica_subcolumns(cldfrac, u_sw, iovr=cfg.iovr)

        # ---------------- longwave
        tau_lw = optics.gas_optical_depth(self.go_lw, play, T, dp, mmr)
        e_lev = _planck_gpt(self.planck_coefs, self.expand_lw,
                            tlev).movedim(-1, 1)  # [ncol, ngpt, nlev]
        e_sfc = _planck_gpt(self.planck_coefs, self.expand_lw, tsfc)
        emis = optics.surface_emissivity(land)
        clear_lw = lw.lw_transfer(tau_lw, e_lev, None, e_sfc, emis, dp)
        tau_cld_lw = _bands_to_gpts(co.tau_lw, self.expand_lw_1)
        total_lw = lw.lw_transfer(tau_lw + mask_lw * tau_cld_lw, e_lev,
                                  None, e_sfc, emis, dp)

        # ---------------- shortwave
        expand = self.expand_sw_1
        tau_g = optics.gas_optical_depth(self.go_sw, play, T, dp, mmr)
        tau_r = _bands_to_gpts(optics.rayleigh_tau(dp), expand)
        if cfg.iaer:
            ta, wa, ga = optics.aerosol_optics(play, dp, land)
            tau_a = _bands_to_gpts(ta, expand)
            wa_g = _bands_to_gpts(ta * wa, expand)
            ga_g = _bands_to_gpts(ta * wa * ga, expand)
        else:
            tau_a = wa_g = ga_g = torch.zeros_like(tau_r)

        def combine(extra_tau, extra_wtau, extra_gwtau):
            tau = tau_g + tau_r + tau_a + extra_tau
            wtau = tau_r + wa_g + extra_wtau
            gwtau = ga_g + extra_gwtau
            ssa = wtau / tau.clamp(min=1e-12)
            g = gwtau / wtau.clamp(min=1e-12)
            return tau, ssa.clamp(0.0, 1.0), g.clamp(0.0, 1.0)

        alb_dir_b, alb_dif_b = optics.surface_albedo(cosz, land,
                                                     ice_frac=ice)
        alb_dir = alb_dir_b @ expand.T
        alb_dif = alb_dif_b @ expand.T
        src = s0 * self.solar_gpt[None, :] * torch.ones(
            (ncol, 1), dtype=dt, device=dev)

        clear_sw = sw.sw_transfer(*combine(0.0, 0.0, 0.0), cosz, src,
                                  alb_dir, alb_dif, dp)
        tc = _bands_to_gpts(co.tau_sw, expand) * mask_sw
        wc = _bands_to_gpts(co.tau_sw * co.ssa_sw, expand) * mask_sw
        gc = _bands_to_gpts(co.tau_sw * co.ssa_sw * co.asy_sw,
                            expand) * mask_sw
        total_sw = sw.sw_transfer(*combine(tc, wc, gc), cosz, src, alb_dir,
                                  alb_dif, dp)

        def resh(x):
            return x.reshape(lead + tuple(x.shape[1:]))

        sfx = "_python"
        return {
            "total_sky_longwave_heating_rate" + sfx: resh(total_lw.htr),
            "clear_sky_longwave_heating_rate" + sfx: resh(clear_lw.htr),
            "total_sky_shortwave_heating_rate" + sfx: resh(total_sw.htr),
            "clear_sky_shortwave_heating_rate" + sfx: resh(clear_sw.htr),
            "total_sky_upward_longwave_flux_at_top_of_atmosphere" + sfx:
                resh(total_lw.up[..., 0]),
            "clear_sky_upward_longwave_flux_at_top_of_atmosphere" + sfx:
                resh(clear_lw.up[..., 0]),
            "total_sky_upward_shortwave_flux_at_top_of_atmosphere" + sfx:
                resh(total_sw.up[..., 0]),
            "clear_sky_upward_shortwave_flux_at_top_of_atmosphere" + sfx:
                resh(clear_sw.up[..., 0]),
            "total_sky_downward_shortwave_flux_at_top_of_atmosphere" + sfx:
                resh(total_sw.dn[..., 0]),
            "total_sky_upward_longwave_flux_at_surface" + sfx:
                resh(total_lw.up[..., -1]),
            "clear_sky_upward_longwave_flux_at_surface" + sfx:
                resh(clear_lw.up[..., -1]),
            "total_sky_downward_longwave_flux_at_surface" + sfx:
                resh(total_lw.dn[..., -1]),
            "clear_sky_downward_longwave_flux_at_surface" + sfx:
                resh(clear_lw.dn[..., -1]),
            "total_sky_upward_shortwave_flux_at_surface" + sfx:
                resh(total_sw.up[..., -1]),
            "clear_sky_upward_shortwave_flux_at_surface" + sfx:
                resh(clear_sw.up[..., -1]),
            "total_sky_downward_shortwave_flux_at_surface" + sfx:
                resh(total_sw.dn[..., -1]),
            "clear_sky_downward_shortwave_flux_at_surface" + sfx:
                resh(clear_sw.dn[..., -1]),
            "cos_zenith_angle": resh(cosz),
            "tendency_of_air_temperature_due_to_radiation": resh(
                total_lw.htr + total_sw.htr),
        }
