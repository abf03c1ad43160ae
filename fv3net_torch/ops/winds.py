"""Wind staggering and rotation helpers for ingesting reference data
(port of ``fv3net_tpu/ops/winds.py``; reference:
external/vcm/vcm/cubedsphere/rotate.py ``center_and_rotate_xy_winds``).

The model's own winds are Cartesian on the A-grid; these helpers turn
D-grid (edge-staggered) x/y winds into cell-centred eastward/northward
winds with precomputed rotation coefficients.
"""
from __future__ import annotations

from typing import Tuple

import torch


def center_d_grid_winds(x_wind, y_wind) -> Tuple[torch.Tensor, torch.Tensor]:
    """Average D-grid edge winds to cell centers.

    x_wind lives on south/north cell edges [..., ny+1, nx]; y_wind on
    west/east edges [..., ny, nx+1].  Returns centered ([..., ny, nx]) x.
    """
    xc = 0.5 * (x_wind[..., :-1, :] + x_wind[..., 1:, :])
    yc = 0.5 * (y_wind[..., :, :-1] + y_wind[..., :, 1:])
    return xc, yc


def rotate_xy_winds(
    x_wind_center,
    y_wind_center,
    eastward_wind_u_coeff,
    eastward_wind_v_coeff,
    northward_wind_u_coeff,
    northward_wind_v_coeff,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate centered grid-relative winds to eastward/northward with the
    reference's rotation-coefficient convention."""
    east = (
        eastward_wind_u_coeff * x_wind_center
        + eastward_wind_v_coeff * y_wind_center
    )
    north = (
        northward_wind_u_coeff * x_wind_center
        + northward_wind_v_coeff * y_wind_center
    )
    return east, north


def center_and_rotate_xy_winds(
    wind_rotation: dict, x_wind, y_wind
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Staggered x/y winds and a coefficient dict -> centered
    eastward/northward winds."""
    xc, yc = center_d_grid_winds(x_wind, y_wind)
    return rotate_xy_winds(
        xc,
        yc,
        wind_rotation["eastward_wind_u_coeff"],
        wind_rotation["eastward_wind_v_coeff"],
        wind_rotation["northward_wind_u_coeff"],
        wind_rotation["northward_wind_v_coeff"],
    )


def cartesian_to_local(wind_xyz, east, north) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Project [3, ...] Cartesian tangent winds onto unit east/north bases
    [3, ...]."""
    u = (wind_xyz * east).sum(dim=0)
    v = (wind_xyz * north).sum(dim=0)
    return u, v


def local_to_cartesian(u, v, east, north) -> torch.Tensor:
    """Inverse of cartesian_to_local."""
    return u[None] * east + v[None] * north
