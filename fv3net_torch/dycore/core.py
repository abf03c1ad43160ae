"""Hydrostatic vertically-Lagrangian dynamics step (port of
``fv3net_tpu/dycore/core.py``).

A-grid finite volume on the gnomonic cubed sphere: Green-Gauss edge sums
with the grid's edge lengths and Cartesian edge normals, flux-form PPM
transport of mass, theta_v, tracers and the three Cartesian wind
components, the Simmons-Burridge hydrostatic pressure-gradient force,
del-2 and divergence damping, and a PPM remap back to the hybrid
coordinate every dynamics interval.

Ported: the hydrostatic core with ``advection_order=4`` (the flagship's).
Nonhydrostatic runs and advection orders 1 and 2 raise
``NotImplementedError``.  The substep loop is a Python loop.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fv3net_torch.core.constants import (
    CP_AIR,
    KAPPA,
    RDGAS,
    REFERENCE_SURFACE_PRESSURE,
    TOA_PRESSURE,
)
from fv3net_torch.dycore import vertical
from fv3net_torch.dycore.state import DycoreState
from fv3net_torch.grid.geometry import Grid
from fv3net_torch.ops import remap as _rm
from fv3net_torch.ops import zscan
from fv3net_torch.parallel.halo import halo_append, halo_append_numpy


@dataclasses.dataclass
class GridArrays:
    """Device-resident static geometry (tensors)."""

    area: torch.Tensor  # [6, n, n]
    edge_len_x: torch.Tensor  # [6, n+1, n]
    edge_len_y: torch.Tensor  # [6, n, n+1]
    normal_x: torch.Tensor  # [3, 6, n+1, n]
    normal_y: torch.Tensor  # [3, 6, n, n+1]
    khat: torch.Tensor  # [3, 6, n, n]
    f_coriolis: torch.Tensor  # [6, n, n]
    dist_x: torch.Tensor  # [6, n+1, n] center-to-center across x-edges
    dist_y: torch.Tensor  # [6, n, n+1] center-to-center across y-edges
    # distance-based interpolation weight of the LEFT cell at each edge
    # midpoint (0.5 in the uniform interior)
    wleft_x: torch.Tensor  # [6, n+1, n]
    wleft_y: torch.Tensor  # [6, n, n+1]
    # least-squares gradient coefficients over the W, E, S, N neighbours
    lsq_coeff: torch.Tensor  # [4, 3, 6, n, n]
    east: torch.Tensor  # [3, 6, n, n]
    north: torch.Tensor  # [3, 6, n, n]
    lat: torch.Tensor  # [6, n, n] radians
    lon: torch.Tensor  # [6, n, n] radians

    @classmethod
    def from_grid(cls, grid: Grid, dtype=torch.float32,
                  device=None) -> "GridArrays":
        # every table is computed in float64 numpy and cast LAST:
        # adjacent-center differences cancel catastrophically if the unit
        # vectors round through float32 first
        ext = halo_append_numpy(
            np.moveaxis(grid.centers_xyz, -1, 1).reshape(
                6, 3, grid.n, grid.n
            ).astype(np.float64),
            1,
        )  # [6, 3, n+2, n+2]

        def gc_dist(a, b):
            cross = np.linalg.norm(np.cross(a, b, axis=1), axis=1)
            dot = np.sum(a * b, axis=1)
            return np.arctan2(cross, dot) * grid.radius

        dist_y = gc_dist(ext[:, :, 1:-1, :-1], ext[:, :, 1:-1, 1:])
        dist_x = gc_dist(ext[:, :, :-1, 1:-1], ext[:, :, 1:, 1:-1])

        corners = np.moveaxis(grid.corners_xyz, -1, 1).astype(np.float64)
        mid_y = corners[:, :, :-1, :] + corners[:, :, 1:, :]
        mid_y = mid_y / np.linalg.norm(mid_y, axis=1, keepdims=True)
        mid_x = corners[:, :, :, :-1] + corners[:, :, :, 1:]
        mid_x = mid_x / np.linalg.norm(mid_x, axis=1, keepdims=True)

        dl_y = gc_dist(ext[:, :, 1:-1, :-1], mid_y)
        dr_y = gc_dist(mid_y, ext[:, :, 1:-1, 1:])
        wleft_y = dr_y / (dl_y + dr_y)
        dl_x = gc_dist(ext[:, :, :-1, 1:-1], mid_x)
        dr_x = gc_dist(mid_x, ext[:, :, 1:, 1:-1])
        wleft_x = dr_x / (dl_x + dr_x)

        ext_np = ext * grid.radius
        c = ext_np[:, :, 1:-1, 1:-1]
        disp = np.stack(
            [
                ext_np[:, :, 1:-1, :-2] - c,  # W
                ext_np[:, :, 1:-1, 2:] - c,  # E
                ext_np[:, :, :-2, 1:-1] - c,  # S
                ext_np[:, :, 2:, 1:-1] - c,  # N
            ]
        )  # [4, 6, 3, n, n]
        k_np = np.moveaxis(grid.centers_xyz, -1, 1)
        # normal equations with the radial direction regularized out
        M = np.einsum("ktaij,ktbij->tijab", disp, disp)
        M += grid.radius ** 2 * np.einsum("taij,tbij->tijab", k_np, k_np)
        Minv = np.linalg.inv(M)
        lsq = np.einsum("tijab,ktbij->katij", Minv, disp)  # [4,3,6,n,n]

        def t(x):
            return torch.tensor(np.asarray(x), dtype=dtype, device=device)

        return cls(
            area=t(grid.area),
            edge_len_x=t(grid.edge_len_x),
            edge_len_y=t(grid.edge_len_y),
            normal_x=t(np.moveaxis(grid.normal_x, -1, 0)),
            normal_y=t(np.moveaxis(grid.normal_y, -1, 0)),
            khat=t(np.moveaxis(grid.centers_xyz, -1, 0)),
            f_coriolis=t(grid.f_coriolis),
            dist_x=t(dist_x),
            dist_y=t(dist_y),
            wleft_x=t(wleft_x),
            wleft_y=t(wleft_y),
            lsq_coeff=t(lsq),
            east=t(np.moveaxis(grid.east, -1, 0)),
            north=t(np.moveaxis(grid.north, -1, 0)),
            lat=t(grid.lat),
            lon=t(grid.lon),
        )


@dataclasses.dataclass(frozen=True)
class DycoreConfig:
    """Static dynamics configuration; the same fields and defaults as the
    reference's."""

    dt: float = 900.0  # dynamics interval, s
    n_split: int = 2  # forward-backward substeps per interval
    kord: int = 9  # PPM reconstruction order for the vertical remap
    ptop: float = TOA_PRESSURE
    diff_coef: float = 0.015  # nondim del-2 damping (x dx^2 / dt_sub)
    divergence_damp_coef: float = 0.0  # nondim divergence damping
    remap: bool = True
    # remap total energy (cp Tv + phi + K) instead of theta_v and recover
    # Tv hydrostatically (FV3's te_map)
    remap_te: bool = False
    # 4 = PPM with CW84 monotonization and Courant-integrated face fluxes
    # (the only order ported); 1 and 2 raise NotImplementedError
    advection_order: int = 2
    hydrostatic: bool = True
    tau_rayleigh: float = 0.0  # days; 0 disables the Rayleigh sponge
    rf_cutoff: float = 750.0  # Pa
    # del-2 and divergence-damping boost in the top two layers
    d2_bg_k1: float = 0.0
    d2_bg_k2: float = 0.0


def _check_supported(cfg: DycoreConfig, state: DycoreState = None):
    if not cfg.hydrostatic or (
        state is not None and (state.w is not None or state.delz is not None)
    ):
        raise NotImplementedError(
            "the nonhydrostatic core (dycore/nonhydro.py) is not ported to "
            "fv3net_torch yet"
        )
    if cfg.advection_order != 4:
        raise NotImplementedError(
            f"advection_order={cfg.advection_order} is not ported to "
            "fv3net_torch yet; the flagship uses 4 (PPM)"
        )


def _edge_normal_wind(wind_ext, g: GridArrays):
    """Normal velocity at y-edges and x-edges from halo-extended Cartesian
    wind [3, 6, nz, n+2, n+2], with distance-based edge-midpoint
    weights."""
    wly = g.wleft_y[:, None]
    wy = wly * wind_ext[..., 1:-1, :-1] + (1.0 - wly) * wind_ext[..., 1:-1, 1:]
    vn_y = (wy * g.normal_y[:, :, None, :, :]).sum(dim=0)
    wlx = g.wleft_x[:, None]
    wx = wlx * wind_ext[..., :-1, 1:-1] + (1.0 - wlx) * wind_ext[..., 1:, 1:-1]
    vn_x = (wx * g.normal_x[:, :, None, :, :]).sum(dim=0)
    return vn_y, vn_x


def _divergence(fy, fx, area):
    return (
        fy[..., 1:] - fy[..., :-1] + fx[..., 1:, :] - fx[..., :-1, :]
    ) / area


def _lsq_gradient(s_ext, g: GridArrays):
    """Least-squares tangent-plane gradient of [6, nz, n+2, n+2]
    -> [3, 6, nz, n, n]."""
    s_c = s_ext[..., 1:-1, 1:-1]
    diffs = torch.stack(
        [
            s_ext[..., 1:-1, :-2] - s_c,
            s_ext[..., 1:-1, 2:] - s_c,
            s_ext[..., :-2, 1:-1] - s_c,
            s_ext[..., 2:, 1:-1] - s_c,
        ]
    )  # [4, 6, nz, n, n]
    coeff = g.lsq_coeff[:, :, :, None]  # [4, 3, 6, 1, n, n]
    return (coeff * diffs[:, None]).sum(dim=0)


def _del2(s_ext, g: GridArrays, nu):
    """Diffusive del-2 flux divergence of [6, nz, n+2, n+2] with viscosity
    nu [m^2/s]."""
    fy = (
        (s_ext[..., 1:-1, 1:] - s_ext[..., 1:-1, :-1])
        / g.dist_y[:, None]
        * g.edge_len_y[:, None]
    )
    fx = (
        (s_ext[..., 1:, 1:-1] - s_ext[..., :-1, 1:-1])
        / g.dist_x[:, None]
        * g.edge_len_x[:, None]
    )
    return nu * _divergence(fy, fx, g.area[:, None])


def _project_tangent(wind, khat):
    """Remove the radial component: wind [3, 6, nz, n, n]."""
    radial = (wind * khat[:, :, None]).sum(dim=0)
    return wind - radial[None] * khat[:, :, None]


def _cross(a, b):
    """Cross product over dim 0 (the numpy formula, broadcasting)."""
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def _ppm_edges_1d(q):
    """4th-order edge estimates + CW84 monotonized parabola coefficients
    along the LAST axis.  q: [..., m] -> (qL, qR, q6) for cells 2..m-3."""
    dqc = 0.5 * (q[..., 2:] - q[..., :-2])
    dlo = q[..., 1:-1] - q[..., :-2]
    dhi = q[..., 2:] - q[..., 1:-1]
    dm = torch.where(
        dlo * dhi > 0.0,
        torch.sign(dqc) * torch.minimum(
            torch.abs(dqc),
            2.0 * torch.minimum(torch.abs(dlo), torch.abs(dhi)),
        ),
        0.0,
    )
    qe = 0.5 * (q[..., 1:-2] + q[..., 2:-1]) - (
        dm[..., 1:] - dm[..., :-1]
    ) / 6.0
    qc = q[..., 2:-2]
    ql = qe[..., :-1]
    qr = qe[..., 1:]
    extremum = (qr - qc) * (qc - ql) <= 0.0
    dq = qr - ql
    q6_raw = 6.0 * (qc - 0.5 * (ql + qr))
    ql = torch.where(extremum, qc, torch.where(dq * q6_raw > dq * dq,
                                               3.0 * qc - 2.0 * qr, ql))
    qr = torch.where(extremum, qc, torch.where(-dq * dq > dq * q6_raw,
                                               3.0 * qc - 2.0 * ql, qr))
    q6 = 6.0 * (qc - 0.5 * (ql + qr))
    return ql, qr, q6


def _ppm_face_value_1d(q, c):
    """Courant-integrated PPM face values along the LAST axis: the mean
    of the upwind parabola over the region swept through each face.
    q: [..., n+6] cell means; c: [..., n+1] face Courant numbers."""
    ql, qr, q6 = _ppm_edges_1d(q)
    l_ql, l_qr, l_q6 = ql[..., :-1], qr[..., :-1], q6[..., :-1]
    r_ql, r_qr, r_q6 = ql[..., 1:], qr[..., 1:], q6[..., 1:]
    cp = torch.clamp(c, 0.0, 1.0)
    cm = torch.clamp(-c, 0.0, 1.0)
    from_left = l_qr - 0.5 * cp * (
        (l_qr - l_ql) - (1.0 - 2.0 * cp / 3.0) * l_q6
    )
    from_right = r_ql + 0.5 * cm * (
        (r_qr - r_ql) + (1.0 - 2.0 * cm / 3.0) * r_q6
    )
    return torch.where(c > 0, from_left, from_right)


def _face_values_ppm(q_ext3, cy, cx):
    """PPM face values from an h=3 extended array [6, nz, n+6, n+6]."""
    qy = _ppm_face_value_1d(q_ext3[..., 3:-3, :], cy)
    qx_t = _ppm_face_value_1d(
        q_ext3[..., 3:-3].transpose(-1, -2), cx.transpose(-1, -2)
    )
    return qy, qx_t.transpose(-1, -2)


def _level_coef(nz, base, k1, k2, like):
    """Per-level coefficient: ``base`` everywhere, boosted in the top two
    sponge layers (d2_bg_k1/k2)."""
    coef = torch.full((nz,), base, dtype=like.dtype, device=like.device)
    if k1 > 0.0:
        coef[0] = max(k1, base)
    if k2 > 0.0 and nz > 1:
        coef[1] = max(k2, base)
    return coef


def _substep(state: DycoreState, g: GridArrays, cfg: DycoreConfig,
             dt: float):
    delp, pt, wind, tracers = state.delp, state.pt, state.wind, state.tracers
    h = 3  # PPM stencil depth

    # ---- one batched halo exchange for every transported field ---------
    names = list(tracers)
    fields = [delp, pt] + [tracers[k] for k in names] + [
        wind[c] for c in range(3)
    ]
    ext_all = halo_append(torch.stack(fields, dim=1), h)
    delp_e = ext_all[:, 0]
    pt_e = ext_all[:, 1]
    tr_e = {k: ext_all[:, 2 + i] for i, k in enumerate(names)}
    iw = 2 + len(names)
    wind_e = ext_all[:, iw: iw + 3].movedim(1, 0)
    wind_e1 = wind_e[..., h - 1: wind_e.shape[-2] - (h - 1),
                     h - 1: wind_e.shape[-1] - (h - 1)]

    vn_y, vn_x = _edge_normal_wind(wind_e1, g)
    cy = vn_y * dt / g.dist_y[:, None]
    cx = vn_x * dt / g.dist_x[:, None]

    # ---- mass fluxes ----------------------------------------------------
    ly = g.edge_len_y[:, None]
    lx = g.edge_len_x[:, None]
    dply, dplx = _face_values_ppm(delp_e, cy, cx)
    fy_m = vn_y * ly * dply
    fx_m = vn_x * lx * dplx
    div_m = _divergence(fy_m, fx_m, g.area[:, None])
    delp_new = delp - dt * div_m

    # ---- consistent scalar transport -----------------------------------
    def transport(q_ext, q_c):
        qy, qx = _face_values_ppm(q_ext, cy, cx)
        div_q = _divergence(fy_m * qy, fx_m * qx, g.area[:, None])
        return (q_c * delp - dt * div_q) / delp_new

    pt_new = transport(pt_e, pt)
    tracers_new = {k: transport(tr_e[k], tracers[k]) for k in tracers}
    wind_adv = torch.stack([transport(wind_e[c], wind[c]) for c in range(3)])

    # ---- pressure-gradient force on the NEW mass field ------------------
    pe = torch.cat(
        [
            torch.full_like(delp_new[:, :1], cfg.ptop),
            cfg.ptop + zscan.cumsum(delp_new, axis=1),
        ],
        dim=1,
    )
    lnpe = torch.log(pe)
    dlnp = lnpe[:, 1:] - lnpe[:, :-1]
    pmid = delp_new / dlnp
    tv = pt_new * (pmid / REFERENCE_SURFACE_PRESSURE) ** KAPPA
    # geopotential: integrate hydrostatically from the surface upward
    dphi = RDGAS * tv * dlnp
    phi_below = zscan.suffix_sum_strict(dphi, axis=1) + state.phis[:, None]
    phi_mid = phi_below + RDGAS * tv * (lnpe[:, 1:] - torch.log(pmid))

    # ---- one batched halo for every PGF/damping stencil input -----------
    halo_fields = [phi_mid, torch.log(pmid)]
    div_damp_on = (
        cfg.divergence_damp_coef > 0.0
        or cfg.d2_bg_k1 > 0.0
        or cfg.d2_bg_k2 > 0.0
    )
    if div_damp_on:
        div = _divergence(
            vn_y * g.edge_len_y[:, None], vn_x * g.edge_len_x[:, None],
            g.area[:, None],
        )
        i_div = len(halo_fields)
        halo_fields.append(div)
    if cfg.diff_coef > 0.0:
        # damp virtual temperature, not theta_v (balance-neutral over
        # terrain); the hydrostatic-convention Tv keeps the inverse exact
        tv_damp = pt_new * (pmid / REFERENCE_SURFACE_PRESSURE) ** KAPPA
        i_tv = len(halo_fields)
        halo_fields.append(tv_damp)
    ext2 = halo_append(torch.stack(halo_fields, dim=1), 1)

    grad_phi = _lsq_gradient(ext2[:, 0], g)
    grad_lnp = _lsq_gradient(ext2[:, 1], g)
    pgf = -grad_phi - RDGAS * tv[None] * grad_lnp

    # ---- Coriolis -------------------------------------------------------
    kh = g.khat[:, :, None]
    cor = -g.f_coriolis[None, :, None] * _cross(kh, wind_adv)

    wind_new = wind_adv + dt * (pgf + cor)

    # ---- divergence damping ---------------------------------------------
    nz = delp.shape[1]
    if div_damp_on:
        coef = _level_coef(nz, cfg.divergence_damp_coef, cfg.d2_bg_k1,
                           cfg.d2_bg_k2, delp)
        nu_d = coef[None, None, :, None, None] * g.area.mean() / dt
        wind_new = wind_new + dt * nu_d * _lsq_gradient(ext2[:, i_div], g)

    # ---- del-2 damping --------------------------------------------------
    # (the d2_bg boost of this half applies only when diff_coef > 0, as
    # in the reference)
    if cfg.diff_coef > 0.0:
        dx2 = g.area.mean()
        dcoef = _level_coef(nz, cfg.diff_coef, cfg.d2_bg_k1, cfg.d2_bg_k2,
                            delp)
        nu = dcoef[None, :, None, None] * dx2 / dt
        wind_new = wind_new + dt * torch.stack(
            [_del2(wind_e1[c], g, nu) for c in range(3)]
        )
        dtv = _del2(ext2[:, i_tv], g, nu)
        pt_new = pt_new + dt * dtv * (
            REFERENCE_SURFACE_PRESSURE / pmid
        ) ** KAPPA

    wind_new = _project_tangent(wind_new, g.khat)
    return DycoreState(
        delp=delp_new, pt=pt_new, wind=wind_new, tracers=tracers_new,
        phis=state.phis,
    )


def _column_te(pe, tv, ke, phis):
    """Total energy per unit mass on layers (z-last): cp Tv + phi_mid + K,
    with phi integrated hydrostatically up from ``phis``."""
    lnpe = torch.log(pe)
    dlnp = lnpe[..., 1:] - lnpe[..., :-1]
    pmid = (pe[..., 1:] - pe[..., :-1]) / dlnp
    dphi = RDGAS * tv * dlnp
    phi_below = zscan.suffix_sum_strict(dphi, axis=-1) + phis[..., None]
    phi_mid = phi_below + 0.5 * RDGAS * tv * dlnp
    return CP_AIR * tv + phi_mid + ke, pmid


def _remap_total_energy(state, pe1, pe2, wind2, cfg, zlast, search,
                        impl=None):
    """FV3's energy-conserving temperature remap (hydrostatic te_map):
    remap column total energy, then recover Tv on the new layers by the
    upward sweep Tv_k = (te_k - K_k - phi_below_k) / (cp + R/2 dlnp_k).
    Returns theta_v on the target layers (z-last)."""
    delp1 = zlast(state.delp)
    lnpe1 = torch.log(pe1)
    dlnp1 = lnpe1[..., 1:] - lnpe1[..., :-1]
    pmid1 = delp1 / dlnp1
    tv1 = zlast(state.pt) * (pmid1 / REFERENCE_SURFACE_PRESSURE) ** KAPPA
    ke1 = 0.5 * sum(zlast(state.wind[c]) ** 2 for c in range(3))
    te1, _ = _column_te(pe1, tv1, ke1, state.phis)
    te2 = _rm.remap_apply(search, te1, iv=1, kord=cfg.kord, impl=impl)

    lnpe2 = torch.log(pe2)
    dlnp2 = lnpe2[..., 1:] - lnpe2[..., :-1]
    pmid2 = (pe2[..., 1:] - pe2[..., :-1]) / dlnp2
    ke2 = 0.5 * sum(w ** 2 for w in wind2)

    # upward sweep from the surface layer (z index 0 = top)
    nz = te2.shape[-1]
    tv2 = [None] * nz
    phi_below = state.phis
    for k in range(nz - 1, -1, -1):
        tv_k = (te2[..., k] - ke2[..., k] - phi_below) / (
            CP_AIR + 0.5 * RDGAS * dlnp2[..., k]
        )
        phi_below = phi_below + RDGAS * tv_k * dlnp2[..., k]
        tv2[k] = tv_k
    tv2 = torch.stack(tv2, dim=-1)
    return tv2 / (pmid2 / REFERENCE_SURFACE_PRESSURE) ** KAPPA


def _remap_to_hybrid(state: DycoreState, ak, bk, cfg: DycoreConfig,
                     impl=None):
    """PPM-remap the Lagrangian layers back to the hybrid coordinate."""
    ps = state.delp.sum(dim=1) + cfg.ptop

    def zlast(x):
        return x.movedim(1, -1)

    def zmid(x):
        return x.movedim(-1, 1)

    delp_z = zlast(state.delp)
    pe1 = torch.cat(
        [
            torch.full_like(delp_z[..., :1], cfg.ptop),
            cfg.ptop + zscan.cumsum(delp_z, axis=-1),
        ],
        dim=-1,
    )
    pe2 = ak + bk * ps[..., None]
    # ONE banded layer search feeds every remapped field
    search = _rm.banded_search(pe1, pe2, window=2)
    pt2, wind2, tracers2 = vertical.remap_column_fields(
        pe1,
        pe2,
        # remap_te recomputes theta from the energy remap
        None if cfg.remap_te else zlast(state.pt),
        tuple(zlast(state.wind[c]) for c in range(3)),
        {k: zlast(v) for k, v in state.tracers.items()},
        kord=cfg.kord,
        search=search,
        impl=impl,
    )
    if cfg.remap_te:
        pt2 = _remap_total_energy(state, pe1, pe2, wind2, cfg, zlast,
                                  search=search, impl=impl)
    return DycoreState(
        delp=zmid(pe2[..., 1:] - pe2[..., :-1]),
        pt=zmid(pt2),
        wind=torch.stack([zmid(w) for w in wind2]),
        # floor transient negative tracer values left by flux-form
        # transport (the reference relies on Fortran fillz similarly)
        tracers={k: torch.clamp(zmid(v), min=0.0)
                 for k, v in tracers2.items()},
        phis=state.phis,
    )


def _rayleigh_damp(state: DycoreState, cfg: DycoreConfig, dt: float):
    """Upper-level Rayleigh sponge: implicit wind damping above
    ``rf_cutoff`` with rate (dt/tau) sin^2(pi/2 * ln(rf_cutoff/p) /
    ln(rf_cutoff/ptop)); the removed kinetic energy returns as heat."""
    if cfg.rf_cutoff <= cfg.ptop:
        raise ValueError(
            f"Rayleigh sponge needs rf_cutoff > ptop; got rf_cutoff="
            f"{cfg.rf_cutoff} Pa <= ptop={cfg.ptop} Pa"
        )
    pe_below = cfg.ptop + zscan.cumsum(state.delp, axis=1)
    pmid = pe_below - 0.5 * state.delp
    arg = torch.clamp(
        torch.log(cfg.rf_cutoff / torch.clamp(pmid, min=1e-3))
        / float(np.log(cfg.rf_cutoff / cfg.ptop)),
        0.0,
        1.0,
    )
    rf = (dt / (cfg.tau_rayleigh * 86400.0)) * torch.sin(
        0.5 * np.pi * arg
    ) ** 2
    fac = 1.0 / (1.0 + rf)
    wind = state.wind * fac[None]
    dke = 0.5 * (1.0 - fac ** 2) * (state.wind ** 2).sum(dim=0)
    exner = (pmid / REFERENCE_SURFACE_PRESSURE) ** KAPPA
    pt = state.pt + dke / (CP_AIR * exner)
    return dataclasses.replace(state, wind=wind, pt=pt)


def validate_acoustic_cfl(g: GridArrays, cfg: DycoreConfig) -> None:
    """The acoustic CFL check matters only to the nonhydrostatic core,
    which is not ported."""
    _check_supported(cfg)


def dynamics_step(
    state: DycoreState, g: GridArrays, ak: torch.Tensor, bk: torch.Tensor,
    cfg: DycoreConfig, impl: str = None,
) -> DycoreState:
    """One full dynamics interval: n_split Lagrangian substeps + vertical
    remap.  ``impl`` selects the remap application (None: the CUDA kernel
    on CUDA tensors, the plain version on CPU tensors)."""
    _check_supported(cfg, state)
    dt_sub = cfg.dt / cfg.n_split
    for _ in range(cfg.n_split):
        state = _substep(state, g, cfg, dt_sub)
    if cfg.tau_rayleigh > 0.0:
        state = _rayleigh_damp(state, cfg, cfg.dt)
    if cfg.remap:
        state = _remap_to_hybrid(state, ak, bk, cfg, impl=impl)
    return state
