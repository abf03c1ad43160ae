"""Cubed-sphere map plotting with matplotlib.

reference: external/fv3viz/fv3viz/_plot_cube.py:54 plot_cube, :261
pcolormesh_cube — per-tile pcolormesh in lat-lon space with antimeridian
handling (tiles whose cells straddle the dateline are masked there
rather than drawn wrapped).

Host copy of ``fv3net_tpu/viz/plot_cube.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _split_antimeridian(lon_corners: np.ndarray) -> np.ndarray:
    """Mask cells whose corner longitudes straddle the antimeridian."""
    lon = np.mod(lon_corners, 360.0)
    cell_min = np.minimum.reduce(
        [lon[:-1, :-1], lon[1:, :-1], lon[:-1, 1:], lon[1:, 1:]]
    )
    cell_max = np.maximum.reduce(
        [lon[:-1, :-1], lon[1:, :-1], lon[:-1, 1:], lon[1:, 1:]]
    )
    return (cell_max - cell_min) > 180.0


def pcolormesh_cube(
    lat_corners_deg: np.ndarray,
    lon_corners_deg: np.ndarray,
    field: np.ndarray,
    ax=None,
    **kwargs,
):
    """Draw a [6, ny, nx] field given corner coords [6, ny+1, nx+1]
    (reference _plot_cube.py:261).  Returns the last QuadMesh."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(10, 5))
    vmin = kwargs.pop("vmin", float(np.nanmin(field)))
    vmax = kwargs.pop("vmax", float(np.nanmax(field)))
    mesh = None
    for t in range(field.shape[0]):
        lon = np.mod(lon_corners_deg[t], 360.0)
        masked = np.ma.masked_where(
            _split_antimeridian(lon_corners_deg[t]), field[t]
        )
        mesh = ax.pcolormesh(
            lon, lat_corners_deg[t], masked, vmin=vmin, vmax=vmax, **kwargs
        )
    ax.set_xlabel("longitude [deg]")
    ax.set_ylabel("latitude [deg]")
    ax.set_xlim(0, 360)
    ax.set_ylim(-90, 90)
    return mesh


def plot_cube(
    grid,
    field: np.ndarray,
    title: Optional[str] = None,
    colorbar: bool = True,
    ax=None,
    robust: bool = False,
    **kwargs,
) -> Tuple:
    """High-level map of a [6, ny, nx] field on a Grid
    (reference _plot_cube.py:54).  Returns (fig, ax, mesh).  vmin/vmax/
    cmap are inferred like the reference (diverging map for
    sign-spanning fields; ``robust`` clips to percentiles)."""
    import matplotlib.pyplot as plt

    from fv3net_torch.viz.helpers import infer_cmap_params

    if ax is None:
        fig, ax = plt.subplots(figsize=(10, 5))
    else:
        fig = ax.figure
    vmin, vmax, cmap = infer_cmap_params(
        np.asarray(field), kwargs.pop("vmin", None),
        kwargs.pop("vmax", None), kwargs.pop("cmap", None), robust,
    )
    mesh = pcolormesh_cube(
        np.rad2deg(grid.lat_corners), np.rad2deg(grid.lon_corners), field,
        ax=ax, vmin=vmin, vmax=vmax, cmap=cmap, **kwargs,
    )
    if colorbar:
        fig.colorbar(mesh, ax=ax, shrink=0.8)
    if title:
        ax.set_title(title)
    return fig, ax, mesh


def plot_cube_faceted(
    grid,
    fields: np.ndarray,
    labels=None,
    ncols: int = 2,
    robust: bool = False,
    **kwargs,
):
    """Faceted maps of a [n, 6, ny, nx] stack (the reference
    plot_cube's col/row faceting over e.g. time or dataset).  Shares one
    inferred color scale across panels.  Returns (fig, axes)."""
    import matplotlib.pyplot as plt

    from fv3net_torch.viz.helpers import infer_cmap_params

    n = fields.shape[0]
    nrows = -(-n // ncols)
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(6 * ncols, 3.2 * nrows), squeeze=False
    )
    vmin, vmax, cmap = infer_cmap_params(
        np.asarray(fields), kwargs.pop("vmin", None),
        kwargs.pop("vmax", None), kwargs.pop("cmap", None), robust,
    )
    mesh = None
    for i in range(nrows * ncols):
        ax = axes[i // ncols][i % ncols]
        if i >= n:
            ax.axis("off")
            continue
        mesh = pcolormesh_cube(
            np.rad2deg(grid.lat_corners), np.rad2deg(grid.lon_corners),
            fields[i], ax=ax, vmin=vmin, vmax=vmax, cmap=cmap, **kwargs,
        )
        if labels is not None:
            ax.set_title(labels[i])
    fig.colorbar(mesh, ax=axes, shrink=0.8)
    return fig, axes
