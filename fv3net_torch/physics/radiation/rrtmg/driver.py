"""GFS-driver adapter for the RRTMG band solvers (port of
``fv3net_tpu/physics/radiation/rrtmg/driver.py``).

One call maps (time, named state columns) to the reference's named
fluxes and heating rates.  K-tables default to the documented-shape
synthetic set made from a seed (:mod:`.tables`); pass ``lw_tables`` /
``sw_tables`` dicts (reference netCDF layout) to run with real data.

McICA draws: :meth:`RRTMGDriver.draw_mcica` gives the uniforms of one
call.  By default it draws them with a ``torch.Generator`` on the
driver's device, seeded from ``(mcica_seed, fold)`` where ``fold`` is
the state fold the reference keys its draws on; they are not the
reference's threefry numbers, so a comparison replaces the method.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fv3net_torch.core.constants import GRAVITY, RDGAS, TOA_PRESSURE
from fv3net_torch.ops import thermo, zenith
from fv3net_torch.physics.microphysics import (
    saturation_specific_humidity,
    sundqvist_cloud_fraction,
)
from fv3net_torch.physics.radiation import aerosols as aer_mod
from fv3net_torch.physics.radiation import gases, optics
from fv3net_torch.physics.radiation.rrtmg import lw as rlw
from fv3net_torch.physics.radiation.rrtmg import params as P
from fv3net_torch.physics.radiation.rrtmg import sw as rsw
from fv3net_torch.physics.radiation.rrtmg import tables as rtables

# representative halocarbon volume mixing ratios (reference
# radiation_gases.py defaults)
_CFC11 = 2.6e-10
_CFC12 = 5.3e-10
_CFC22 = 1.1e-10
_CCL4 = 9.0e-11

# band-centre wavenumbers (cm-1) of the published RRTMG band bounds
_SW_BAND_WVN = np.array([
    2925.0, 3625.0, 4325.0, 4900.0, 5650.0, 6925.0, 7875.0, 10450.0,
    14425.0, 19325.0, 25825.0, 33500.0, 44000.0, 1710.0,
])
_SW_LAM_UM = 1.0e4 / _SW_BAND_WVN
_LW_BAND_WVN = np.array([
    180.0, 425.0, 565.0, 665.0, 760.0, 900.0, 1030.0, 1130.0,
    1285.0, 1435.0, 1640.0, 1940.0, 2165.0, 2315.0, 2490.0, 2925.0,
])
_LW_LAM_UM = 1.0e4 / _LW_BAND_WVN


@dataclasses.dataclass
class RRTMGConfig:
    iovr: int = 1  # max-random overlap
    isol: int = 0
    ico2: int = 0
    iaer: int = 1
    icld: int = 1
    year: int = 2016
    mcica_seed: int = 42
    solcon: float = 1368.22
    # direct exponentials in the transfer (the reference package's
    # production default); False (the lookup tables) is not ported
    fast_exp: bool = True
    # column blocking is not ported: None or 0 runs every column at once
    column_block: Optional[int] = None
    # lower bound on layer pressures (mb) that bounds the upper-
    # atmosphere base rows (lw.nbase_hi_for); None = the model top
    min_pressure_mb: Optional[float] = None


class RRTMGDriver:
    """Builds the table data once on ``device`` (the card unless the
    caller asks for the CPU); ``__call__`` runs both solvers there and
    refuses state tensors that lie on another device.

    ``impl`` picks the k-table selections' version (None: the CUDA
    kernels on a CUDA device, the plain versions on the CPU);
    ``lw_taumol`` the route of the LW gas optics ("ktable": the k-table
    selections, "mega": the one-launch kernel K2, see ``lw.lwrad``)."""

    def __init__(self, config: RRTMGConfig = RRTMGConfig(),
                 lw_tables: Optional[Dict] = None,
                 sw_tables: Optional[Dict] = None,
                 dtype=torch.float32, device="cuda", impl: str = None,
                 lw_taumol: str = "ktable"):
        if lw_taumol not in ("ktable", "mega"):
            raise ValueError(
                f"lw_taumol must be 'ktable' or 'mega'; got {lw_taumol!r}")
        if not config.fast_exp:
            raise NotImplementedError(
                "RRTMGConfig.fast_exp=False (the lookup-table "
                "transmittances) is not ported to fv3net_torch yet"
            )
        if config.column_block:
            raise NotImplementedError(
                "RRTMGConfig.column_block > 0 (column blocking) is not "
                "ported to fv3net_torch yet"
            )
        self.config = config
        self.dtype = dtype
        # resolved ("cuda" -> "cuda:<current>") so that it compares equal
        # to the device of a tensor placed there
        self.device = torch.empty(0, device=device).device
        self.impl = impl
        self.lw_taumol = lw_taumol
        min_p = (config.min_pressure_mb if config.min_pressure_mb is not None
                 else TOA_PRESSURE / 100.0)
        nbase_hi = rlw.nbase_hi_for(min_p)
        self.Tlw = rlw.prep_lw_tables(
            lw_tables or rtables.make_lw_tables(), dtype, self.device,
            nbase_hi=nbase_hi,
        )
        self.Tsw = rsw.prep_sw_tables(
            sw_tables or rtables.make_sw_tables(), dtype, self.device,
            nbase_hi=nbase_hi,
        )
        self.Taer = aer_mod.make_aerosol_tables(_SW_LAM_UM, _LW_LAM_UM)

    def draw_mcica(self, fold: int, ncol: int,
                   nz: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """McICA uniforms (rand_lw [ncol, 140*nz], rand_sw
        [ncol, 112*nz]) in the compute dtype, from a generator on the
        driver's device seeded with ``(mcica_seed, fold)``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.mcica_seed * 1000003 + int(fold))
        kw = dict(generator=gen, dtype=self.dtype, device=self.device)
        return (torch.rand((ncol, P.NGPT_LW * nz), **kw),
                torch.rand((ncol, P.NGPT_SW * nz), **kw))

    def _aerosols(self, play_mb, dp_mb, land, nbands, lw_mode):
        """[C, L, nbands, 3] (tau, ssa, asy) of the compact iaer=2
        stand-in: boundary-layer aerosol with an Angstrom slope (SW) or a
        flat gray absorption (LW)."""
        aod550 = 0.12 * land + 0.06 * (1.0 - land)
        w = dp_mb * (play_mb > 700.0)
        w = w / w.sum(-1, keepdim=True).clamp(min=1.0)
        prof = aod550[:, None] * w
        if lw_mode:
            tau = prof[..., None] * 0.06 * torch.ones(
                nbands, dtype=self.dtype, device=self.device)
            ssa = torch.zeros_like(tau)
            asy = torch.zeros_like(tau)
        else:
            spectral = torch.as_tensor((_SW_LAM_UM / 0.55) ** -1.3,
                                       dtype=self.dtype, device=self.device)
            tau = prof[..., None] * spectral
            ssa = torch.full_like(tau, 0.95)
            asy = torch.full_like(tau, 0.70)
        return torch.stack([tau, ssa, asy], dim=-1)

    def __call__(self, time: datetime.datetime,
                 state: Dict[str, torch.Tensor],
                 cosz: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
        """state: z-last columns with z index 0 = model top (flipped
        internally to the solvers' surface-first order)."""
        cfg = self.config
        dt = self.dtype
        dev = self.device
        for name, x in list(state.items()) + [("cosz", cosz)]:
            if torch.is_tensor(x) and x.device != dev:
                raise ValueError(
                    f"RRTMGDriver on {dev} was given {name} on {x.device}; "
                    "build the driver on the state's device"
                )
        T_in = state["air_temperature"]
        lead, nz = tuple(T_in.shape[:-1]), T_in.shape[-1]
        ncol = int(np.prod(lead)) if lead else 1

        def cols(x, flip=True):
            x = torch.as_tensor(x, dtype=dt, device=dev)
            x = x.reshape((ncol,) + tuple(x.shape[len(lead):]))
            return x.flip(1) if (flip and x.ndim > 1) else x

        def zeros2d():
            return torch.zeros(lead, dtype=dt, device=dev)

        T = cols(T_in)  # [C, L] surface-first
        dp_pa = cols(state["pressure_thickness_of_atmospheric_layer"])
        q = (cols(state["specific_humidity"])
             if "specific_humidity" in state
             else torch.full((ncol, nz), 1e-6, dtype=dt, device=dev))
        qc = (cols(state["cloud_water_mixing_ratio"])
              if "cloud_water_mixing_ratio" in state
              else torch.zeros((ncol, nz), dtype=dt, device=dev))
        tsfc = cols(state["surface_temperature"], flip=False)
        lat = cols(state["latitude"], flip=False)
        lon = cols(state["longitude"], flip=False)
        land = cols(state.get("land_sea_mask", zeros2d()), False).clamp(0, 1)
        ice = cols(state.get("ice_fraction", zeros2d()), False).clamp(0, 1)

        # pressures in mb, surface-first levels
        dp_td = torch.as_tensor(
            state["pressure_thickness_of_atmospheric_layer"], dtype=dt,
            device=dev,
        ).reshape(ncol, nz)
        plev_td = thermo.pressure_at_interface(dp_td)  # [C, L+1] top-down
        plvl = plev_td.flip(1) * 0.01
        plyr = (0.5 * (plev_td[..., :-1] + plev_td[..., 1:])).flip(1) * 0.01
        delp = dp_pa * 0.01
        # interface temperatures, surface-first: level 0 extrapolates
        # below the lowest layer, level L above the top layer
        tlvl = torch.cat([
            T[:, :1] + 0.25 * (T[:, :1] - T[:, 1:2]),
            0.5 * (T[:, :-1] + T[:, 1:]),
            T[:, -1:] - 0.25 * (T[:, -2:-1] - T[:, -1:]),
        ], dim=-1)

        if "ozone_mixing_ratio" in state:
            o3 = cols(state["ozone_mixing_ratio"]).clamp(min=0.0)
        else:
            o3 = gases.ozone_profile(plyr * 100.0, lat)

        # well-mixed gas volume mixing ratios -> gasvmr slots
        ones = torch.ones_like(plyr)
        gasvmr = torch.stack([
            ones * gases.co2vmr(cfg.year, cfg.ico2),
            ones * gases.N2OVMR_DEF,
            ones * gases.CH4VMR_DEF,
            ones * gases.O2VMR_DEF,
            ones * 1.5e-7,  # co
            ones * _CFC11,
            ones * _CFC12,
            ones * _CFC22,
            ones * _CCL4,
            torch.zeros_like(plyr),
        ], dim=-1)

        # clouds: condensate -> in-cloud paths and radii; the fraction is
        # the max of the compact condensate form and the Sundqvist
        # diagnosis of the gscond closure
        t_frac_ice = ((268.0 - T) / 15.0).clamp(0.0, 1.0)
        wpath = qc * dp_pa * (1000.0 / GRAVITY)
        cldfrac = torch.maximum(
            torch.where(qc > 1e-7, 1.0 - torch.exp(-qc / 3.0e-5), 0.0),
            sundqvist_cloud_fraction(T, q, qc, plyr * 100.0),
        )
        if cfg.icld == 0:
            cldfrac = torch.zeros_like(cldfrac)
        incloud = wpath / cldfrac.clamp(min=0.05)
        lwp = incloud * (1.0 - t_frac_ice)
        iwp = incloud * t_frac_ice
        re_liq = (10.0 * land + 14.0 * (1.0 - land))[:, None].expand_as(lwp)
        re_ice = (326.3 + 12.42 * (T - 273.15)).clamp(20.0, 130.0)
        zeros = torch.zeros_like(cldfrac)
        clouds = torch.stack([cldfrac, lwp, re_liq, iwp, re_ice,
                              zeros, zeros, zeros, zeros], dim=-1)

        days = zenith.days_from_2000(time)
        if cosz is None:
            cosz = zenith.cos_zenith_angle(days, torch.rad2deg(lon),
                                           torch.rad2deg(lat))
        cosz = torch.as_tensor(cosz, dtype=dt, device=dev).reshape(ncol)

        # McICA uniforms keyed on a fold of the state (max, not sum: it
        # does not depend on the reduction order)
        fold = int(torch.fmod(T.abs().max() * 64.0, 1000003.0).item())
        rand_lw, rand_sw = self.draw_mcica(fold, ncol, nz)

        sfemis = optics.surface_emissivity(land)
        aerodp = None
        if cfg.iaer == 1:
            qsat = saturation_specific_humidity(T, plyr * 100.0)
            rh = (q / qsat.clamp(min=1e-10)).clamp(0.0, 1.0)
            tv = thermo.virtual_temperature(T, q)
            # hypsometric thickness (plvl is surface-first, so plvl[:, :-1]
            # is each layer's lower interface)
            delz_km = (RDGAS * tv / GRAVITY
                       * torch.log(plvl[:, :-1] / plvl[:, 1:].clamp(min=1e-6))
                       / 1000.0)
            month = time.month + (time.day - 1) / 30.5
            aer_sw, aer_lw, aerodp = aer_mod.setaer(
                plyr, delz_km, rh, land, lat, self.Taer, P.NBANDS_SW,
                month=month,
            )
        elif cfg.iaer:
            aer_lw = self._aerosols(plyr, delp, land, P.NBANDS_LW, True)
            aer_sw = self._aerosols(plyr, delp, land, P.NBANDS_SW, False)
        else:
            aer_lw = torch.zeros((ncol, nz, P.NBANDS_LW, 3), dtype=dt,
                                 device=dev)
            aer_sw = torch.zeros((ncol, nz, P.NBANDS_SW, 3), dtype=dt,
                                 device=dev)

        lw_out = rlw.lwrad(
            plyr, plvl, T, tlvl, q, o3, gasvmr, clouds, aer_lw, sfemis, tsfc,
            delp, rand_lw, self.Tlw, iovrlw=cfg.iovr, fast_exp=cfg.fast_exp,
            impl=self.impl, taumol=self.lw_taumol,
        )

        # broadband dir/dif albedo -> (nir-bm, nir-df, vis-bm, vis-df)
        alb_dir_b, alb_dif_b = optics.surface_albedo(cosz, land,
                                                     ice_frac=ice)
        vis = torch.as_tensor(_SW_LAM_UM < 0.7, dtype=dt, device=dev)
        wsum_v = vis.sum().clamp(min=1.0)
        wsum_n = (1.0 - vis).sum().clamp(min=1.0)
        if alb_dir_b.shape[-1] == P.NBANDS_SW:
            a_nir_bm = (alb_dir_b * (1.0 - vis)).sum(-1) / wsum_n
            a_nir_df = (alb_dif_b * (1.0 - vis)).sum(-1) / wsum_n
            a_vis_bm = (alb_dir_b * vis).sum(-1) / wsum_v
            a_vis_df = (alb_dif_b * vis).sum(-1) / wsum_v
        else:  # band means
            a_nir_bm = a_vis_bm = alb_dir_b.mean(-1)
            a_nir_df = a_vis_df = alb_dif_b.mean(-1)
        sfcalb = torch.stack([a_nir_bm, a_nir_df, a_vis_bm, a_vis_df],
                             dim=-1)

        s0 = cfg.solcon
        if cfg.isol:
            # orbit-modulated solar constant (Spencer (a/r)^2)
            s0 = cfg.solcon * zenith.solar_distance_factor(days)
        sw_out = rsw.swrad(
            plyr, plvl, T, tlvl, q, o3, gasvmr, clouds, aer_sw, sfcalb,
            delp, cosz, s0, rand_sw, self.Tsw, iovrsw=cfg.iovr,
            fast_exp=cfg.fast_exp, impl=self.impl,
        )

        def resh(x, flip=False):
            if flip:
                x = x.flip(1)
            return x.reshape(lead + tuple(x.shape[1:]))

        hlwc = lw_out["hlwc"]
        hswc = sw_out["hswc"]
        sfx = "_python"
        out = {
            "total_sky_longwave_heating_rate" + sfx: resh(hlwc, True),
            "clear_sky_longwave_heating_rate" + sfx: resh(lw_out["hlw0"],
                                                          True),
            "total_sky_shortwave_heating_rate" + sfx: resh(hswc, True),
            "clear_sky_shortwave_heating_rate" + sfx: resh(sw_out["hsw0"],
                                                           True),
            "cos_zenith_angle": resh(cosz),
            "tendency_of_air_temperature_due_to_radiation": resh(
                hlwc + hswc, True),
        }
        fluxes = {
            "total_sky_upward_longwave_flux_at_top_of_atmosphere":
                lw_out["upfxc_t"],
            "clear_sky_upward_longwave_flux_at_top_of_atmosphere":
                lw_out["upfx0_t"],
            "total_sky_upward_shortwave_flux_at_top_of_atmosphere":
                sw_out["ftoauc"],
            "clear_sky_upward_shortwave_flux_at_top_of_atmosphere":
                sw_out["ftoau0"],
            "total_sky_downward_shortwave_flux_at_top_of_atmosphere":
                sw_out["ftoadc"],
            "total_sky_upward_longwave_flux_at_surface": lw_out["upfxc_s"],
            "clear_sky_upward_longwave_flux_at_surface": lw_out["upfx0_s"],
            "total_sky_downward_longwave_flux_at_surface":
                lw_out["dnfxc_s"],
            "clear_sky_downward_longwave_flux_at_surface":
                lw_out["dnfx0_s"],
            "total_sky_upward_shortwave_flux_at_surface": sw_out["fsfcuc"],
            "clear_sky_upward_shortwave_flux_at_surface": sw_out["fsfcu0"],
            "total_sky_downward_shortwave_flux_at_surface":
                sw_out["fsfcdc"],
            "clear_sky_downward_shortwave_flux_at_surface":
                sw_out["fsfcd0"],
        }
        out.update({k + sfx: resh(v) for k, v in fluxes.items()})
        if aerodp is not None:
            # per-species 550 nm column AOD (reference setaer's aerodp)
            for i, nm in enumerate(aer_mod.SPECIES):
                out[f"aerosol_optical_depth_{nm}"] = resh(aerodp[:, i])
            out["aerosol_optical_depth_total"] = resh(aerodp[:, -1])
        return out
