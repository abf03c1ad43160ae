"""Animated maps of run output.

reference: workflows/diagnostics/fv3net/diagnostics/prognostic_run/
movies.py — mp4 movies of 2-D fields via plot_cube frames.  This
environment has no ffmpeg; matplotlib's Pillow writer produces GIFs with
the same per-frame plotting path (fv3net_torch.viz.plot_cube).

Host copy of ``fv3net_tpu/diagnostics/movies.py``.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def create_movie(
    field: np.ndarray,  # [time, 6, ny, nx]
    grid,
    output_path: str,
    title: str = "",
    fps: int = 4,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    from fv3net_torch.viz import pcolormesh_cube

    field = np.asarray(field)
    vmin = float(np.nanmin(field)) if vmin is None else vmin
    vmax = float(np.nanmax(field)) if vmax is None else vmax
    fig, ax = plt.subplots(figsize=(8, 4))

    lat_c = np.rad2deg(grid.lat_corners)
    lon_c = np.rad2deg(grid.lon_corners)

    def draw(t):
        ax.clear()
        mesh = pcolormesh_cube(
            lat_c, lon_c, field[t], ax=ax, vmin=vmin, vmax=vmax
        )
        ax.set_title(f"{title} [t={t}]")
        return [mesh]

    anim = animation.FuncAnimation(
        fig, draw, frames=field.shape[0], blit=False
    )
    if not output_path.endswith(".gif"):
        output_path = output_path + ".gif"
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    anim.save(output_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return output_path


def create_movies_for_dataset(ds, grid, output_dir: str,
                              names: Optional[Sequence[str]] = None):
    """One movie per [time, tile, y, x] variable (the movies CLI core)."""
    written = []
    for name in names or list(ds):
        q = ds[name]
        if q.dims != ("time", "tile", "y", "x"):
            continue
        path = os.path.join(output_dir, f"{name}.gif")
        written.append(create_movie(q.values, grid, path, title=name))
    return written
