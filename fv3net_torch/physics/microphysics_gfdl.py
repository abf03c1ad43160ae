"""GFDL-style six-category bulk cloud microphysics on tensors (port of
``fv3net_tpu/physics/microphysics_gfdl.py``): vapour, cloud liquid, cloud
ice, rain, snow and graupel, with the reference's process set (fast
saturation adjustment, warm rain, ice deposition and sublimation,
aggregation, riming, graupel formation, freezing and melting) and its
simplified collection kernels, constant latent heats (column moist
enthalpy closes to roundoff) and clipped transfers (total water with the
surface precipitation closes exactly).

Arrays are z-last ``[..., nz]`` with k=0 at the model top.  The
sedimentation is the time-implicit upstream fall, the reference's scan
over levels as a Python loop (:func:`_sediment`).  Selected by
``PhysicsConfig.microphysics_scheme = "gfdl"`` (the namelist's
``imp_physics: 11``); the state then carries the four
``GFDL_TRACER_NAMES`` beside sphum and cloud_water (the liquid).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from fv3net_torch.core.constants import CP_AIR, RDGAS, RVGAS
from fv3net_torch.ops import thermo

EPS = RDGAS / RVGAS

# constant latent heats (0 C reference values, GFDL bookkeeping)
LV0 = 2.5e6  # J/kg vapor <-> liquid
LF0 = 3.34e5  # J/kg liquid <-> ice
LS0 = LV0 + LF0  # vapor <-> ice

T_FREEZE = 273.16
T_HOMOG = 233.16  # homogeneous freezing of cloud liquid
RHO_REF = 1.2  # kg/m3 reference air density for fall speeds


@dataclasses.dataclass(frozen=True)
class GFDLMPParams:
    """Process rates / thresholds.

    The collection (accretion) kernels are simplified to
    ``c * donor * sqrt(collector)`` power laws — the full scheme's
    gamma-function integrals over assumed size distributions reduce to
    ~q^(7/8)-type laws; sqrt keeps the same qualitative saturation
    behavior with one cheap transcendental.
    """

    n_sub: int = 2  # process/sedimentation subcycles per call
    # fast saturation adjustment
    n_adjust: int = 2
    # warm rain
    ql0: float = 1.0e-3  # kg/kg liquid autoconversion threshold
    c_praut: float = 1.0e-3  # 1/s beyond threshold
    c_pracw: float = 0.8  # rain collecting cloud water
    c_prevp: float = 1.0e-3  # rain evaporation efficiency
    # ice / snow
    qi0: float = 1.0e-4  # kg/kg ice -> snow autoconversion threshold
    c_psaut: float = 1.0e-3  # 1/s beyond threshold (colder = faster)
    c_psaci: float = 0.6  # snow collecting cloud ice
    c_psacw: float = 0.6  # snow collecting (riming) cloud water
    tau_idep: float = 600.0  # s, vapor <-> ice relaxation timescale
    # graupel
    qs0: float = 6.0e-4  # kg/kg snow -> graupel threshold
    c_pgaut: float = 1.0e-3  # 1/s beyond threshold
    c_pgacw: float = 0.8  # graupel riming cloud water
    c_pgacr: float = 0.8  # graupel collecting (freezing) rain
    c_pgfr: float = 2.0e-4  # 1/(s K) rain freezing below -2 C
    # melting / sublimation
    c_smlt: float = 8.0e-3  # 1/(s K) snow melt above 0 C
    c_gmlt: float = 4.0e-3  # 1/(s K) graupel melt above 0 C
    c_ssub: float = 5.0e-4  # snow sublimation efficiency
    # sedimentation: vt = vfac * (rho*q*1e3)^vexp * sqrt(RHO_REF/rho),
    # clipped to vmax (magnitudes per the published fall-speed laws)
    vi_fac: float = 0.8
    vi_exp: float = 0.16
    vi_max: float = 1.0
    vr_fac: float = 8.0
    vr_exp: float = 0.1364
    vr_max: float = 12.0
    vs_fac: float = 1.5
    vs_exp: float = 0.0968
    vs_max: float = 2.5
    vg_fac: float = 4.0
    vg_exp: float = 0.125
    vg_max: float = 10.0


def _where_cold(cold, value: float, like):
    """``value`` where ``cold``, else 0, in ``like``'s dtype (a Python
    float kept at its precision)."""
    return cold.to(like.dtype) * value


def _qsat_water(T, p):
    es = thermo.saturation_pressure(T)
    es = torch.minimum(es, 0.9 * p)
    return EPS * es / (p - (1.0 - EPS) * es)


def _qsat_ice(T, p):
    """Saturation over ice: Magnus-type with the ice coefficients
    (lower than over water below freezing, driving the WBF transfer)."""
    tc = T - T_FREEZE
    es = 611.2 * torch.exp(22.587 * tc / (tc + 273.86))
    es = torch.minimum(es, 0.9 * p)
    return EPS * es / (p - (1.0 - EPS) * es)


def _sat_adjust(T, qv, ql, qi, p, n_iter: int):
    """Fast adjustment: condensation/evaporation w.r.t. liquid
    saturation, homogeneous freezing below T_HOMOG, cloud-ice melt
    above freezing.  All with the constant latent heats."""
    for _ in range(n_iter):
        qsw = _qsat_water(T, p)
        dqsdT = LV0 * qsw / (RVGAS * T * T)
        dq = (qv - qsw) / (1.0 + (LV0 / CP_AIR) * dqsdT)
        cond = dq.clamp(min=0.0)  # condense to liquid
        evap = torch.minimum((-dq).clamp(min=0.0), ql)  # evaporate liquid
        dql = cond - evap
        qv = qv - dql
        ql = ql + dql
        T = T + (LV0 / CP_AIR) * dql
    # homogeneous freezing (all liquid at T < T_HOMOG; ramp to -36 C)
    frz = ql * torch.clamp((T_HOMOG + 4.0 - T) / 4.0, 0.0, 1.0)
    ql = ql - frz
    qi = qi + frz
    T = T + (LF0 / CP_AIR) * frz
    # cloud-ice melt above freezing, limited by the available heat
    heat_room = (T - T_FREEZE).clamp(min=0.0) * CP_AIR / LF0
    melt = torch.minimum(qi, heat_room)
    qi = qi - melt
    ql = ql + melt
    T = T - (LF0 / CP_AIR) * melt
    return T, qv, ql, qi


def _terminal_velocity(rho, q, fac, expo, vmax):
    """vt = fac * (rho*q*1e3)^expo * sqrt(RHO_REF/rho), clipped."""
    x = (rho * q * 1.0e3).clamp(min=0.0)
    vt = fac * x**expo * torch.sqrt(RHO_REF / rho.clamp(min=0.1))
    return torch.clamp(torch.where(q > 1.0e-10, vt, 0.0), 0.0, vmax)


def _sediment(species, vts, dz, dm, dt):
    """Time-implicit upstream fall of several species at once.

    species/vts: tuples of [..., nz] mixing ratios and velocities
    (k=0 = top).  Returns (new_species tuple, surface fluxes tuple in
    kg/m^2/s).  Per layer: q_new = (q + in*dt/dm) / (1 + vt*dt/dz),
    out = q_new * vt * dm / dz -- mass-exact and stable for any vt.

    The reference's scan over levels is a Python loop over nz here, the
    species stacked so that each level is one set of launches.
    """
    q = torch.stack(species)  # [ns, ..., nz]
    vt = torch.stack(vts)
    nz = q.shape[-1]
    flux = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    out = []
    for k in range(nz):
        dz_k, dm_k, vt_k = dz[..., k], dm[..., k], vt[..., k]
        q_new = (q[..., k] + flux * dt / dm_k) / (1.0 + vt_k * dt / dz_k)
        flux = q_new * vt_k * dm_k / dz_k  # kg/m^2/s
        out.append(q_new)
    new = torch.stack(out, dim=-1)
    return tuple(new.unbind(0)), tuple(flux.unbind(0))


def gfdl_microphysics_step(
    T, qv, ql, qi, qr, qs, qg, p, delp, dt: float,
    params: GFDLMPParams = GFDLMPParams(),
) -> Tuple[torch.Tensor, ...]:
    """One microphysics call over z-last column arrays.

    Returns ``(T, qv, ql, qi, qr, qs, qg, rain_sfc, frozen_sfc)`` with
    the surface precipitation rates in kg/m^2/s (``frozen_sfc`` = snow +
    graupel + sedimented cloud ice reaching the surface).
    """
    dm = thermo.layer_mass(delp)
    tv = thermo.virtual_temperature(T, qv)
    rho = p / (RDGAS * tv)
    dz = dm / rho  # hydrostatic layer depth, m

    rain_sfc = torch.zeros(T.shape[:-1], dtype=T.dtype, device=T.device)
    snow_sfc = torch.zeros(T.shape[:-1], dtype=T.dtype, device=T.device)

    dts = dt / params.n_sub
    for _ in range(params.n_sub):
        # ---- fast adjustment --------------------------------------------
        T, qv, ql, qi = _sat_adjust(T, qv, ql, qi, p, params.n_adjust)

        cold = T < T_FREEZE
        warm_exc = (T - T_FREEZE).clamp(min=0.0)
        cold_exc = (T_FREEZE - T).clamp(min=0.0)

        def move(rate, donor):
            """Clipped transfer amount for this subcycle (kg/kg)."""
            return torch.minimum(rate.clamp(min=0.0) * dts, donor)

        # ---- warm rain ---------------------------------------------------
        praut = move(params.c_praut * (ql - params.ql0), ql)
        pracw = move(params.c_pracw * ql * torch.sqrt(qr), ql - praut)
        ql = ql - praut - pracw
        qr = qr + praut + pracw

        # rain evaporation in subsaturated air (rate in 1/s via c_prevp,
        # capped by the rain and by the saturation deficit)
        qsw = _qsat_water(T, p)
        deficit_w = (qsw - qv).clamp(min=0.0)
        prevp = torch.minimum(
            move(params.c_prevp * deficit_w * 1e3 * torch.sqrt(qr * 1e3), qr),
            deficit_w,
        )
        qr = qr - prevp
        qv = qv + prevp
        T = T - (LV0 / CP_AIR) * prevp

        # ---- ice phase -----------------------------------------------------
        # vapor deposition onto / sublimation off cloud ice+snow where cold
        qsi = _qsat_ice(T, p)
        dq_i = (qv - qsi) / (
            1.0 + (LS0 / CP_AIR) * LS0 * qsi / (RVGAS * T * T)
        )
        relax = dts / (params.tau_idep + dts)
        has_ice_sfcarea = (qi + qs) > 1.0e-8
        pidep = torch.where(
            cold & (has_ice_sfcarea | (dq_i > 5.0e-5)),
            dq_i * relax,
            0.0,
        )
        dep = pidep.clamp(min=0.0)
        sub = torch.minimum((-pidep).clamp(min=0.0), qi)
        qi = qi + dep - sub
        qv = qv - dep + sub
        T = T + (LS0 / CP_AIR) * (dep - sub)

        # snow sublimation in subsaturated (over-ice) air: only below
        # freezing (above, melting dominates), capped by the deficit so
        # it cannot push past ice saturation
        deficit_i = (qsi - qv).clamp(min=0.0)
        pssub = torch.minimum(
            move(
                _where_cold(cold, params.c_ssub, T)
                * deficit_i * 1e3 * torch.sqrt(qs * 1e3),
                qs,
            ),
            deficit_i,
        )
        qs = qs - pssub
        qv = qv + pssub
        T = T - (LS0 / CP_AIR) * pssub

        # ice -> snow autoconversion (faster when warmer ice, per the
        # scheme's exp(0.025 dT) aggregation factor)
        agg = torch.exp(0.025 * (T - T_FREEZE))
        psaut = move(params.c_psaut * agg * (qi - params.qi0), qi)
        # snow collecting cloud ice
        psaci = move(
            params.c_psaci * agg * qi * torch.sqrt(qs), qi - psaut
        )
        qi = qi - psaut - psaci
        qs = qs + psaut + psaci

        # riming: snow/graupel collecting cloud water.  Below freezing
        # the collected water freezes onto the collector (+Lf); above,
        # it sheds as rain (no phase change).
        psacw = move(params.c_psacw * ql * torch.sqrt(qs), ql)
        pgacw = move(params.c_pgacw * ql * torch.sqrt(qg), ql - psacw)
        ql = ql - psacw - pgacw
        qs = qs + torch.where(cold, psacw, 0.0)
        qg = qg + torch.where(cold, pgacw, 0.0)
        qr = qr + torch.where(cold, 0.0, psacw + pgacw)
        T = T + (LF0 / CP_AIR) * torch.where(cold, psacw + pgacw, 0.0)

        # snow -> graupel when rimed snow exceeds the threshold
        pgaut = move(params.c_pgaut * (qs - params.qs0), qs)
        qs = qs - pgaut
        qg = qg + pgaut

        # rain freezing: collected by graupel + heterogeneous freezing
        # below -2 C (both +Lf)
        pgacr = move(
            torch.where(cold, params.c_pgacr * qr * torch.sqrt(qg), 0.0), qr
        )
        pgfr = move(
            params.c_pgfr * (cold_exc - 2.0).clamp(min=0.0) * qr,
            qr - pgacr,
        )
        qr = qr - pgacr - pgfr
        qg = qg + pgacr + pgfr
        T = T + (LF0 / CP_AIR) * (pgacr + pgfr)

        # melting above freezing (-Lf), limited by the available heat
        heat_room = warm_exc * CP_AIR / LF0
        psmlt = torch.minimum(
            move(params.c_smlt * warm_exc * torch.sqrt(qs * 1e3), qs),
            heat_room,
        )
        pgmlt = torch.minimum(
            move(params.c_gmlt * warm_exc * torch.sqrt(qg * 1e3), qg),
            (heat_room - psmlt).clamp(min=0.0),
        )
        qs = qs - psmlt
        qg = qg - pgmlt
        qr = qr + psmlt + pgmlt
        T = T - (LF0 / CP_AIR) * (psmlt + pgmlt)

        # ---- sedimentation ----------------------------------------------
        vti = _terminal_velocity(
            rho, qi, params.vi_fac, params.vi_exp, params.vi_max
        )
        vtr = _terminal_velocity(
            rho, qr, params.vr_fac, params.vr_exp, params.vr_max
        )
        vts = _terminal_velocity(
            rho, qs, params.vs_fac, params.vs_exp, params.vs_max
        )
        vtg = _terminal_velocity(
            rho, qg, params.vg_fac, params.vg_exp, params.vg_max
        )
        (qi, qr, qs, qg), (f_i, f_r, f_s, f_g) = _sediment(
            (qi, qr, qs, qg), (vti, vtr, vts, vtg), dz, dm, dts
        )
        rain_sfc = rain_sfc + f_r * dts / dt
        snow_sfc = snow_sfc + (f_i + f_s + f_g) * dts / dt

        # closing adjustment: melt/evaporation cooling above can leave
        # transient supersaturation (the scheme ends its slow-process
        # block with a final adjustment)
        T, qv, ql, qi = _sat_adjust(T, qv, ql, qi, p, 1)

    return T, qv, ql, qi, qr, qs, qg, rain_sfc, snow_sfc


GFDL_TRACER_NAMES = ("ice_wat", "rainwat", "snowwat", "graupel")
