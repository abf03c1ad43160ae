"""Offline-diagnostics HTML report.

Reference: offline/views/create_report.py + views/plot.py — sections
for scalar metrics, column-level (pressure) skill profiles, zonal-mean
cross sections, diurnal cycles, time-mean/snapshot maps, transects and
input-sensitivity Jacobians, written as one static HTML file.

Host copy of ``fv3net_tpu/diagnostics/offline/views.py``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _tile_mosaic(ax, field: np.ndarray, cmap="viridis", vmin=None,
                 vmax=None):
    """[6, ny, nx] cube field as a 2x3 tile mosaic image."""
    f = np.asarray(field, np.float64)
    ny, nx = f.shape[-2:]
    canvas = np.full((2 * ny, 3 * nx), np.nan)
    for t in range(6):
        r, c = divmod(t, 3)
        canvas[r * ny : (r + 1) * ny, c * nx : (c + 1) * nx] = f[t]
    im = ax.imshow(canvas, origin="lower", cmap=cmap, vmin=vmin,
                   vmax=vmax)
    ax.set_xticks([])
    ax.set_yticks([])
    return im


def create_offline_report(
    result: Dict,
    output_dir: str,
    title: str = "Offline ML diagnostics",
    sensitivities: Optional[Dict[str, np.ndarray]] = None,
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from fv3net_torch.report import ImagePlot, create_report

    diags = result["diagnostics"]
    sections: Dict[str, list] = {
        "Column-level skill": [],
        "Zonal-mean cross sections": [],
        "Diurnal cycles": [],
        "Time-mean maps": [],
        "Snapshots": [],
        "Transects": [],
    }

    # ---- pressure/model-level skill profiles -------------------------
    for name, q in sorted(diags.items()):
        if q.ndim != 1:
            continue
        if "_r2_" in name or "_rmse_" in name or "_bias_" in name:
            if q.dims and q.dims[0] in ("z", "pressure"):
                fig, ax = plt.subplots(figsize=(3.6, 4))
                arr = np.asarray(q.data)
                ax.plot(arr, np.arange(len(arr)))
                ax.invert_yaxis()
                ax.set_ylabel(f"{q.dims[0]} index (0 = top)")
                ax.set_title(name, fontsize=8)
                if "_r2_" in name:
                    ax.set_xlim(-0.5, 1.0)
                sections["Column-level skill"].append(
                    ImagePlot(fig, caption=name)
                )
                plt.close(fig)

    # ---- zonal-mean cross sections ----------------------------------
    for name, q in sorted(diags.items()):
        if q.ndim == 2 and "latitude" in q.dims:
            fig, ax = plt.subplots(figsize=(4.4, 3.2))
            arr = np.asarray(q.data, np.float64)
            lat = np.asarray(q.attrs.get("latitude",
                                         range(arr.shape[-1])))
            vmax = np.nanmax(np.abs(arr)) or 1.0
            cmap = "RdBu_r" if "_bias_" in name else "viridis"
            vmin = -vmax if "_bias_" in name else None
            im = ax.pcolormesh(lat, np.arange(arr.shape[0]), arr,
                               cmap=cmap, vmin=vmin,
                               vmax=vmax if "_bias_" in name else None)
            ax.invert_yaxis()
            fig.colorbar(im, ax=ax)
            ax.set_xlabel("latitude [deg]")
            ax.set_ylabel("level (0 = top)")
            ax.set_title(name, fontsize=8)
            sections["Zonal-mean cross sections"].append(
                ImagePlot(fig, caption=name)
            )
            plt.close(fig)

    # ---- diurnal cycles (predict vs target) --------------------------
    for name, q in sorted(diags.items()):
        if "diurnal_cycle" in name and q.ndim == 2:
            fig, ax = plt.subplots(figsize=(4, 3))
            arr = np.asarray(q.data, np.float64)  # [24, derivation]
            hours = np.arange(arr.shape[0])
            ax.plot(hours, arr[:, 0], label="target")
            ax.plot(hours, arr[:, 1], label="predict")
            ax.set_xlabel("local solar hour")
            ax.set_ylabel(q.units)
            ax.set_title(name, fontsize=8)
            ax.legend(fontsize=7)
            sections["Diurnal cycles"].append(
                ImagePlot(fig, caption=name)
            )
            plt.close(fig)

    # ---- time-mean maps (predict/target/difference) ------------------
    for name, q in sorted(diags.items()):
        if not name.endswith("_time_mean_global"):
            continue
        arr = np.asarray(q.data, np.float64)
        if arr.ndim == 4 and arr.shape[0] == 6:  # [tile, y, x, deriv]
            tgt, prd = arr[..., 0], arr[..., 1]
            fig, axes = plt.subplots(1, 3, figsize=(10, 2.6))
            lo = np.nanpercentile([tgt, prd], 2)
            hi = np.nanpercentile([tgt, prd], 98)
            for ax, f, lbl in zip(
                axes[:2], (tgt, prd), ("target", "predict")
            ):
                im = _tile_mosaic(ax, f, vmin=lo, vmax=hi)
                ax.set_title(lbl, fontsize=8)
                fig.colorbar(im, ax=ax, shrink=0.8)
            diff = prd - tgt
            vmax = np.nanmax(np.abs(diff)) or 1.0
            im = _tile_mosaic(axes[2], diff, cmap="RdBu_r",
                              vmin=-vmax, vmax=vmax)
            axes[2].set_title("predict - target", fontsize=8)
            fig.colorbar(im, ax=axes[2], shrink=0.8)
            fig.suptitle(name, fontsize=9)
            sections["Time-mean maps"].append(
                ImagePlot(fig, caption=name)
            )
            plt.close(fig)

    # ---- snapshots ---------------------------------------------------
    snap = result.get("snapshot") or {}
    for name, q in sorted(snap.items()):
        arr = np.asarray(q.data, np.float64)
        if arr.ndim == 3 and arr.shape[0] == 6:
            fig, ax = plt.subplots(figsize=(4, 2.6))
            im = _tile_mosaic(ax, arr)
            fig.colorbar(im, ax=ax, shrink=0.8)
            ax.set_title(name, fontsize=8)
            sections["Snapshots"].append(ImagePlot(fig, caption=name))
            plt.close(fig)

    # ---- transects ---------------------------------------------------
    transect = result.get("transect")
    if transect is not None:
        lat = np.asarray(
            transect.coords.get("transect_lat", np.arange(1))
        )
        for name in sorted(transect.keys()):
            q = transect[name]
            arr = np.asarray(q.data, np.float64)
            if arr.ndim != 2:
                continue
            fig, ax = plt.subplots(figsize=(4.4, 3))
            im = ax.pcolormesh(
                lat, np.arange(arr.shape[0]), arr, cmap="viridis"
            )
            ax.invert_yaxis()
            fig.colorbar(im, ax=ax)
            ax.set_xlabel("latitude [deg]")
            ax.set_ylabel("pressure level (0 = top)")
            ax.set_title(name, fontsize=8)
            sections["Transects"].append(
                ImagePlot(fig, caption=name)
            )
            plt.close(fig)

    # ---- input sensitivities ----------------------------------------
    if sensitivities:
        sections["Input sensitivity (Jacobians)"] = []
        for name, mat in sorted(sensitivities.items()):
            fig, ax = plt.subplots(figsize=(3.6, 3.6))
            vmax = np.abs(mat).max() or 1.0
            im = ax.pcolormesh(np.atleast_2d(mat), cmap="RdBu_r",
                               vmin=-vmax, vmax=vmax)
            fig.colorbar(im, ax=ax)
            ax.set_title(name, fontsize=8)
            sections["Input sensitivity (Jacobians)"].append(
                ImagePlot(fig, caption=name)
            )
            plt.close(fig)

    metrics = {
        k: f"{v:.4g}"
        for k, v in sorted(result.get("scalar_metrics", {}).items())
    }
    sections = {k: v for k, v in sections.items() if v}
    return create_report(
        sections, title, output_dir, metrics=metrics
    )
