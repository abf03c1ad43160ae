"""Vertically-Lagrangian dynamics step (port of
``fv3net_tpu/dycore/core.py``).

A-grid finite volume on the gnomonic cubed sphere: Green-Gauss edge sums
with the grid's edge lengths and Cartesian edge normals, flux-form PPM
transport of mass, theta_v, tracers and the three Cartesian wind
components, the Simmons-Burridge hydrostatic pressure-gradient force,
del-2 and divergence damping, and a PPM remap back to the hybrid
coordinate every dynamics interval.

Ported: every advection order of the reference: 1 (first-order upwind),
2 (monotone van Leer / minmod MUSCL face values) and 4 (PPM, the
flagship's); the hydrostatic core and the nonhydrostatic one
(``hydrostatic=False``: prognostic w and delz transported with the
state, the full-pressure geopotential in the pressure-gradient force, a
vertical acoustic solve each substep, ``dycore/nonhydro.py``, and w and
delz through the remap).  The substep loop is a Python loop.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fv3net_torch.core.constants import (
    CP_AIR,
    GRAVITY,
    KAPPA,
    RDGAS,
    REFERENCE_SURFACE_PRESSURE,
    TOA_PRESSURE,
)
from fv3net_torch.dycore import nonhydro, vertical
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
    # the global mean cell area, set on a sharded block
    # (``parallel.sharded.shard_grid``); None: the mean of ``area``
    area_mean: torch.Tensor = None

    def mean_area(self) -> torch.Tensor:
        return self.area.mean() if self.area_mean is None else self.area_mean

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
    # 1 = first-order upwind, 2 = monotone 2nd-order (van Leer / minmod
    # MUSCL), 4 = PPM with CW84 monotonization and Courant-integrated
    # face fluxes
    advection_order: int = 2
    hydrostatic: bool = True
    tau_rayleigh: float = 0.0  # days; 0 disables the Rayleigh sponge
    rf_cutoff: float = 750.0  # Pa
    # del-2 and divergence-damping boost in the top two layers
    d2_bg_k1: float = 0.0
    d2_bg_k2: float = 0.0


def _check_supported(cfg: DycoreConfig):
    if cfg.advection_order not in (1, 2, 4):
        raise ValueError(f"advection_order must be 1, 2 or 4, got "
                         f"{cfg.advection_order}")


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


def _upwind(vn, left, right):
    return torch.where(vn > 0, left, right)


def _minmod(a, b):
    return torch.where(a * b > 0.0,
                       torch.where(torch.abs(a) < torch.abs(b), a, b), 0.0)


def _face_values_2nd(q_ext2, vn_y, vn_x):
    """Monotone 2nd-order (van Leer / minmod MUSCL) upwind face values
    from an h=2 extended array [6, nz, n+4, n+4]."""
    # y-edges (faces between (j, i-1) and (j, i)), i_edge = 0..n
    qm = q_ext2[..., 2:-2, 0:-3]
    ql = q_ext2[..., 2:-2, 1:-2]
    qr = q_ext2[..., 2:-2, 2:-1]
    qp = q_ext2[..., 2:-2, 3:]
    slope_l = _minmod(ql - qm, qr - ql)
    slope_r = _minmod(qr - ql, qp - qr)
    qy = torch.where(vn_y > 0, ql + 0.5 * slope_l, qr - 0.5 * slope_r)
    # x-edges
    qm = q_ext2[..., 0:-3, 2:-2]
    ql = q_ext2[..., 1:-2, 2:-2]
    qr = q_ext2[..., 2:-1, 2:-2]
    qp = q_ext2[..., 3:, 2:-2]
    slope_l = _minmod(ql - qm, qr - ql)
    slope_r = _minmod(qr - ql, qp - qr)
    qx = torch.where(vn_x > 0, ql + 0.5 * slope_l, qr - 0.5 * slope_r)
    return qy, qx


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
    order = cfg.advection_order
    h = {1: 1, 2: 2, 4: 3}[order]  # the face stencil's depth

    # ---- one batched halo exchange for every transported field ---------
    names = list(tracers)
    fields = [delp, pt] + [tracers[k] for k in names] + [
        wind[c] for c in range(3)
    ]
    if not cfg.hydrostatic:
        fields += [state.w, state.delz]
    ext_all = halo_append(torch.stack(fields, dim=1), h)
    delp_e = ext_all[:, 0]
    pt_e = ext_all[:, 1]
    tr_e = {k: ext_all[:, 2 + i] for i, k in enumerate(names)}
    iw = 2 + len(names)
    wind_e = ext_all[:, iw: iw + 3].movedim(1, 0)
    if not cfg.hydrostatic:
        w_e = ext_all[:, iw + 3]
        delz_e = ext_all[:, iw + 4]
    wind_e1 = wind_e[..., h - 1: wind_e.shape[-2] - (h - 1),
                     h - 1: wind_e.shape[-1] - (h - 1)]

    vn_y, vn_x = _edge_normal_wind(wind_e1, g)
    if order == 4:
        cy = vn_y * dt / g.dist_y[:, None]
        cx = vn_x * dt / g.dist_x[:, None]

    def faces(q_ext):
        if order == 4:
            return _face_values_ppm(q_ext, cy, cx)
        if order == 2:
            return _face_values_2nd(q_ext, vn_y, vn_x)
        return (_upwind(vn_y, q_ext[..., 1:-1, :-1], q_ext[..., 1:-1, 1:]),
                _upwind(vn_x, q_ext[..., :-1, 1:-1], q_ext[..., 1:, 1:-1]))

    # ---- mass fluxes ----------------------------------------------------
    ly = g.edge_len_y[:, None]
    lx = g.edge_len_x[:, None]
    dply, dplx = faces(delp_e)
    fy_m = vn_y * ly * dply
    fx_m = vn_x * lx * dplx
    div_m = _divergence(fy_m, fx_m, g.area[:, None])
    delp_new = delp - dt * div_m

    # ---- consistent scalar transport -----------------------------------
    def transport(q_ext, q_c):
        qy, qx = faces(q_ext)
        div_q = _divergence(fy_m * qy, fx_m * qx, g.area[:, None])
        return (q_c * delp - dt * div_q) / delp_new

    pt_new = transport(pt_e, pt)
    tracers_new = {k: transport(tr_e[k], tracers[k]) for k in tracers}
    wind_adv = torch.stack([transport(wind_e[c], wind[c]) for c in range(3)])
    if not cfg.hydrostatic:
        # w is mass-weighted; delz is advected in flux form with the
        # volume flux, so horizontal convergence compresses the layer
        w_adv = transport(w_e, state.w)
        dzy, dzx = faces(delz_e)
        delz_adv = state.delz - dt * _divergence(
            vn_y * ly * dzy, vn_x * lx * dzx, g.area[:, None]
        )

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
    if cfg.hydrostatic:
        tv = pt_new * (pmid / REFERENCE_SURFACE_PRESSURE) ** KAPPA
        # geopotential: integrate hydrostatically from the surface upward
        dphi = RDGAS * tv * dlnp
        phi_below = (zscan.suffix_sum_strict(dphi, axis=1)
                     + state.phis[:, None])
        phi_mid = phi_below + RDGAS * tv * (lnpe[:, 1:] - torch.log(pmid))
        p_for_pgf = pmid
    else:
        # full-pressure PGF along the Lagrangian layers: phi from the
        # geometric thicknesses, p from the equation of state, the
        # midpoint at the hydrostatic log-pressure fraction (so that a
        # resting atmosphere over terrain stays at rest)
        p_full = nonhydro.full_pressure(delp_new, pt_new, delz_adv)
        dphi = GRAVITY * delz_adv
        phi_below = (zscan.suffix_sum_strict(dphi, axis=1)
                     + state.phis[:, None])
        f_mid = (lnpe[:, 1:] - torch.log(pmid)) / dlnp
        phi_mid = phi_below + dphi * f_mid
        tv = p_full * GRAVITY * delz_adv / (delp_new * RDGAS)  # p/(rho R)
        p_for_pgf = p_full

    # ---- one batched halo for every PGF/damping stencil input -----------
    halo_fields = [phi_mid, torch.log(p_for_pgf)]
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
        nu_d = coef[None, None, :, None, None] * g.mean_area() / dt
        wind_new = wind_new + dt * nu_d * _lsq_gradient(ext2[:, i_div], g)

    # ---- del-2 damping --------------------------------------------------
    # (the d2_bg boost of this half applies only when diff_coef > 0, as
    # in the reference)
    if cfg.diff_coef > 0.0:
        dx2 = g.mean_area()
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

    # ---- vertical acoustic step (nonhydrostatic only) -------------------
    w_new = delz_new = None
    if not cfg.hydrostatic:
        if cfg.diff_coef > 0.0:
            w_e1 = w_e[..., h - 1: w_e.shape[-2] - (h - 1),
                       h - 1: w_e.shape[-1] - (h - 1)]
            w_adv = w_adv + dt * _del2(w_e1, g, nu)
        # material lower boundary over terrain: w_s = u . grad(z_s)
        grad_zs = _lsq_gradient(halo_append(state.phis[:, None], 1),
                                g)[:, :, 0] / GRAVITY
        w_surf = (wind_new[:, :, -1] * grad_zs).sum(dim=0)
        w_new, delz_new = nonhydro.vertical_solver(
            w_adv, delz_adv, delp_new, pt_new, dt, cfg.ptop, w_surf=w_surf
        )
    return DycoreState(
        delp=delp_new, pt=pt_new, wind=wind_new, tracers=tracers_new,
        phis=state.phis, w=w_new, delz=delz_new,
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
                        impl=None, delz2=None):
    """FV3's energy-conserving temperature remap (te_map): remap column
    total energy, then recover Tv on the new layers.  Hydrostatic: phi
    from R Tv dlnp and the upward sweep Tv_k = (te_k - K_k - phi_below_k)
    / (cp + R/2 dlnp_k).  Nonhydrostatic (``delz2`` given): phi is
    geometric (g dz), so Tv = (te - K - phi_mid) / cp directly.  ``wind2``
    holds w after the three winds when nonhydrostatic.  Returns theta_v
    on the target layers (z-last)."""
    delp1 = zlast(state.delp)
    lnpe1 = torch.log(pe1)
    dlnp1 = lnpe1[..., 1:] - lnpe1[..., :-1]
    pmid1 = delp1 / dlnp1
    tv1 = zlast(state.pt) * (pmid1 / REFERENCE_SURFACE_PRESSURE) ** KAPPA
    ke1 = 0.5 * sum(zlast(state.wind[c]) ** 2 for c in range(3))
    if state.w is not None:
        ke1 = ke1 + 0.5 * zlast(state.w) ** 2
    nonhydrostatic = state.delz is not None
    if nonhydrostatic:
        dphi1 = GRAVITY * zlast(state.delz)
        phi_below1 = (zscan.suffix_sum_strict(dphi1, axis=-1)
                      + state.phis[..., None])
        # the hydrostatic-fraction midpoint of the nonhydrostatic PGF
        f1 = (lnpe1[..., 1:] - torch.log(pmid1)) / dlnp1
        te1 = CP_AIR * tv1 + phi_below1 + dphi1 * f1 + ke1
    else:
        te1, _ = _column_te(pe1, tv1, ke1, state.phis)
    te2 = _rm.remap_apply(search, te1, iv=1, kord=cfg.kord, impl=impl)

    lnpe2 = torch.log(pe2)
    dlnp2 = lnpe2[..., 1:] - lnpe2[..., :-1]
    pmid2 = (pe2[..., 1:] - pe2[..., :-1]) / dlnp2
    ke2 = 0.5 * sum(w ** 2 for w in wind2)

    if nonhydrostatic:
        dphi2 = GRAVITY * delz2
        phi_below2 = (zscan.suffix_sum_strict(dphi2, axis=-1)
                      + state.phis[..., None])
        f2 = (lnpe2[..., 1:] - torch.log(pmid2)) / dlnp2
        tv2 = (te2 - ke2 - phi_below2 - dphi2 * f2) / CP_AIR
        return tv2 / (pmid2 / REFERENCE_SURFACE_PRESSURE) ** KAPPA

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
    # w remaps with the winds' profile (iv=-1), in the same call
    components = tuple(zlast(state.wind[c]) for c in range(3))
    if state.w is not None:
        components = components + (zlast(state.w),)
    pt2, comp2, tracers2 = vertical.remap_column_fields(
        pe1,
        pe2,
        # remap_te recomputes theta from the energy remap
        None if cfg.remap_te else zlast(state.pt),
        components,
        {k: zlast(v) for k, v in state.tracers.items()},
        kord=cfg.kord,
        search=search,
        impl=impl,
    )
    wind2 = comp2[:3]
    dz2 = None
    if state.w is not None:
        # delz remaps as mass-weighted specific volume (dz per unit dpi):
        # conserving its mass integral conserves the column height
        dp1 = pe1[..., 1:] - pe1[..., :-1]
        sv2 = _rm.remap_apply(search, zlast(state.delz) / dp1, iv=1,
                              kord=cfg.kord, impl=impl)
        dz2 = sv2 * (pe2[..., 1:] - pe2[..., :-1])
    if cfg.remap_te:
        # comp2 holds the remapped w when nonhydrostatic: its kinetic
        # energy counts on the target layers
        pt2 = _remap_total_energy(state, pe1, pe2, comp2, cfg, zlast,
                                  search=search, impl=impl, delz2=dz2)
    return DycoreState(
        delp=zmid(pe2[..., 1:] - pe2[..., :-1]),
        pt=zmid(pt2),
        wind=torch.stack([zmid(w) for w in wind2]),
        # floor transient negative tracer values left by flux-form
        # transport (the reference relies on Fortran fillz similarly)
        tracers={k: torch.clamp(zmid(v), min=0.0)
                 for k, v in tracers2.items()},
        phis=state.phis,
        w=None if state.w is None else zmid(comp2[3]),
        delz=None if dz2 is None else zmid(dz2),
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
    w = state.w
    if w is not None:
        dke = dke + 0.5 * (1.0 - fac ** 2) * w ** 2
        w = w * fac
    exner = (pmid / REFERENCE_SURFACE_PRESSURE) ** KAPPA
    pt = state.pt + dke / (CP_AIR * exner)
    return dataclasses.replace(state, wind=wind, pt=pt, w=w)


def validate_acoustic_cfl(g: GridArrays, cfg: DycoreConfig) -> None:
    """Nonhydrostatic runs carry horizontal sound waves explicitly, so the
    substep must satisfy c_s * dt_sub <= 0.75 dx_min (the vertical is
    implicit).  Raises ValueError naming the smallest stable ``n_split``,
    as the reference does."""
    _check_supported(cfg)
    if cfg.hydrostatic:
        return
    from fv3net_torch.parallel.sharded import global_min

    c_s = 350.0  # sound speed bound, m/s
    dx_min = float(global_min(torch.minimum(g.dist_x.min(), g.dist_y.min())))
    dt_sub = cfg.dt / cfg.n_split
    if c_s * dt_sub > 0.75 * dx_min:
        need = int(np.ceil(c_s * cfg.dt / (0.75 * dx_min)))
        raise ValueError(
            f"nonhydrostatic acoustic CFL violated: c_s*dt/n_split = "
            f"{c_s * dt_sub:.0f} m > 0.75*dx_min = {0.75 * dx_min:.0f} m; "
            f"use n_split >= {need} (got {cfg.n_split})"
        )


def dynamics_step(
    state: DycoreState, g: GridArrays, ak: torch.Tensor, bk: torch.Tensor,
    cfg: DycoreConfig, impl: str = None,
) -> DycoreState:
    """One full dynamics interval: n_split Lagrangian substeps + vertical
    remap.  ``impl`` selects the remap application (None: the CUDA kernel
    on CUDA tensors, the plain version on CPU tensors)."""
    _check_supported(cfg)
    if not cfg.hydrostatic and state.w is None:
        raise ValueError("a nonhydrostatic step needs w and delz in the "
                         "state (dycore.add_nonhydrostatic_fields)")
    dt_sub = cfg.dt / cfg.n_split
    for _ in range(cfg.n_split):
        state = _substep(state, g, cfg, dt_sub)
    if cfg.tau_rayleigh > 0.0:
        state = _rayleigh_damp(state, cfg, cfg.dt)
    if cfg.remap:
        state = _remap_to_hybrid(state, ak, bk, cfg, impl=impl)
    return state
