"""Fine-resolution Q1/Q2 apparent-source budgets (port of
``fv3net_tpu/pipelines/fine_res_budget.py``; reference:
workflows/fine_res_budget/budget/budgets.py).

Apparent sources (Yanai): the coarsened storage minus the coarsened
physics tendencies, on the coarse pressure coordinate; the training
targets of the fine-resolution ML models.  Fields are z-last
(..., y, x, nz); every area-weighted block average is
:func:`fv3net_torch.ops.coarsen.weighted_block_average` (K5 on CUDA
tensors), and the vertical regrid the kord-1 PPM remap.
"""
from __future__ import annotations

from typing import Dict

import torch

from fv3net_torch.core.constants import TOA_PRESSURE
from fv3net_torch.ops import coarsen as _c
from fv3net_torch.ops import remap as _remap
from fv3net_torch.ops import thermo


def storage(begin: torch.Tensor, end: torch.Tensor, time_step: float):
    """(field_end - field_begin) / dt."""
    return (end - begin) / time_step


def _upsample_zlast(x, factor: int):
    return _c.block_upsample(x.movedim(-1, -3), factor).movedim(-3, -1)


def pressure_level_average(
    field, delp_fine, delp_coarse, area, factor: int,
    toa_pressure: float = TOA_PRESSURE,
):
    """Coarsen a z-last (..., y, x, nz) field on surfaces of constant
    pressure: PPM-regrid each fine column to the (upsampled) coarse
    pressure coordinate, then area-weighted block average."""
    pi_fine = thermo.pressure_at_interface(delp_fine, toa_pressure)
    pi_coarse = thermo.pressure_at_interface(delp_coarse, toa_pressure)
    pi_up = _upsample_zlast(pi_coarse, factor)
    regridded = _remap.remap_ppm(pi_fine, field, pi_up, iv=1, kord=1)
    out = _c.weighted_block_average(regridded.movedim(-1, -3),
                                    area.unsqueeze(-3), factor)
    return out.movedim(-3, -1)


def exposed_area(delp_fine, delp_coarse, area, factor: int,
                 toa_pressure: float = TOA_PRESSURE):
    """Area where the coarse pressure midpoint lies above the fine
    surface."""
    p_c = thermo.pressure_at_midpoint_log(delp_coarse, toa_pressure)
    p_up = _upsample_zlast(p_c, factor)
    ps = thermo.surface_pressure_from_delp(delp_fine, toa_pressure)
    ok = p_up <= ps[..., None]
    w = torch.where(ok, area[..., None], 0.0)
    return _c.block_sum(w.movedim(-1, -3), factor).movedim(-3, -1)


def compute_budget(
    T_begin, T_end, q_begin, q_end,
    physics_T_tendency, physics_q_tendency,
    delp_fine, area, factor: int, time_step: float,
    toa_pressure: float = TOA_PRESSURE,
) -> Dict[str, torch.Tensor]:
    """Coarsened apparent sources Q1 [K/s] and Q2 [kg/kg/s].

    All fields z-last (..., y, x, nz) on the fine grid; returns fields on
    the coarse grid with the coarse pressure coordinate.
    """
    delp_coarse = _c.weighted_block_average(
        delp_fine.movedim(-1, -3), area.unsqueeze(-3), factor
    ).movedim(-3, -1)

    def coarse(f):
        return pressure_level_average(
            f, delp_fine, delp_coarse, area, factor, toa_pressure
        )

    dT_storage = storage(T_begin, T_end, time_step)
    dq_storage = storage(q_begin, q_end, time_step)
    out = {
        "delp": delp_coarse,
        "exposed_area": exposed_area(delp_fine, delp_coarse, area, factor,
                                     toa_pressure),
        "T_storage": coarse(dT_storage),
        "sphum_storage": coarse(dq_storage),
        "pQ1": coarse(physics_T_tendency),
        "pQ2": coarse(physics_q_tendency),
    }
    # apparent sources: what the coarse model must add beyond its physics
    out["Q1"] = out["T_storage"]
    out["Q2"] = out["sphum_storage"]
    out["dQ1"] = out["Q1"] - out["pQ1"]
    out["dQ2"] = out["Q2"] - out["pQ2"]
    return out
