"""Plot helpers, styles and diagnostic panels.

reference: external/fv3viz/fv3viz/_plot_helpers.py (infer_cmap_params —
robust limits, diverging-vs-sequential colormap choice),
_styles.py (Wong colorblind-friendly palette),
_plot_diagnostics.py (plot_diurnal_cycle:27, plot_time_series:80),
_timestep_histograms.py (plot_daily_and_hourly_hist:10).

Host copy of ``fv3net_tpu/viz/helpers.py``.
"""
from __future__ import annotations

import datetime
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# Wong (2011) colorblind-friendly palette (reference _styles.py)
WONG_PALETTE = [
    "#000000", "#e69f00", "#56b4e9", "#009e73",
    "#f0e442", "#0072b2", "#d55e00", "#cc79a7",
]


def use_colorblind_friendly_style() -> None:
    """Set matplotlib's default color cycle to the Wong palette."""
    import matplotlib as mpl

    mpl.rcParams["axes.prop_cycle"] = mpl.cycler(color=WONG_PALETTE)


def _min_max_from_percentiles(
    x: np.ndarray, min_percentile: float = 2.0, max_percentile: float = 98.0
) -> Tuple[float, float]:
    return (
        float(np.nanpercentile(x, min_percentile)),
        float(np.nanpercentile(x, max_percentile)),
    )


def infer_cmap_params(
    data: np.ndarray,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    cmap: Optional[str] = None,
    robust: bool = False,
) -> Tuple[float, float, str]:
    """Colorbar limits + colormap for the data (reference
    _plot_helpers.py:148): sign-spanning fields get a symmetric range
    and a diverging map, one-signed fields a sequential map; ``robust``
    clips to the 2nd/98th percentiles."""
    if robust:
        xmin, xmax = _min_max_from_percentiles(data)
    else:
        xmin, xmax = float(np.nanmin(data)), float(np.nanmax(data))
    diverging = xmin < 0.0 < xmax
    if vmin is None and vmax is None:
        if diverging:
            bound = max(abs(xmin), abs(xmax))
            vmin, vmax = -bound, bound
        else:
            vmin, vmax = xmin, xmax
    elif vmin is None:
        vmin = -vmax if diverging else xmin
    elif vmax is None:
        vmax = -vmin if diverging else xmax
    if cmap is None:
        cmap = "RdBu_r" if vmin < 0.0 < vmax else "viridis"
    return vmin, vmax, cmap


def get_var_label(attrs: Dict, var_name: str, max_line_length: int = 30):
    """Axis label from long_name/units attrs (reference
    _plot_helpers.py:123), wrapped to plot-friendly lines."""
    name = attrs.get("long_name", var_name)
    units = attrs.get("units")
    label = f"{name} [{units}]" if units else str(name)
    if len(label) <= max_line_length:
        return label
    words, lines, cur = label.split(), [], ""
    for w in words:
        if cur and len(cur) + 1 + len(w) > max_line_length:
            lines.append(cur)
            cur = w
        else:
            cur = f"{cur} {w}".strip()
    lines.append(cur)
    return "\n".join(lines)


# ------------------------------------------------------- diagnostics
def plot_diurnal_cycle(
    solar_hour: np.ndarray,
    values: Dict[str, np.ndarray],
    ax=None,
    ylabel: str = "",
    title: str = "",
):
    """Composite-by-local-solar-hour lines per labeled run (reference
    _plot_diagnostics.py:27)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    for i, (label, v) in enumerate(values.items()):
        ax.plot(
            solar_hour, v, label=label,
            color=WONG_PALETTE[i % len(WONG_PALETTE)],
        )
    ax.set_xlabel("local solar hour")
    ax.set_xticks(range(0, 25, 6))
    if ylabel:
        ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    ax.legend()
    ax.grid(alpha=0.3)
    return ax


def plot_time_series(
    times: Sequence,
    values: Dict[str, np.ndarray],
    ax=None,
    ylabel: str = "",
    title: str = "",
):
    """Labeled time-series panel (reference _plot_diagnostics.py:80)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(7, 3))
    for i, (label, v) in enumerate(values.items()):
        ax.plot(
            times, v, label=label,
            color=WONG_PALETTE[i % len(WONG_PALETTE)],
        )
    ax.set_xlabel("time")
    if ylabel:
        ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    ax.legend()
    ax.grid(alpha=0.3)
    return ax


def plot_daily_and_hourly_hist(times: Sequence[datetime.datetime]):
    """Histograms of timestep coverage by day and by hour (reference
    _timestep_histograms.py:10) — the training-data sampling check."""
    import matplotlib.pyplot as plt

    fig, (ax_d, ax_h) = plt.subplots(1, 2, figsize=(9, 3))
    days = sorted({t.date() for t in times})
    day_counts = [sum(1 for t in times if t.date() == d) for d in days]
    ax_d.bar(range(len(days)), day_counts)
    ax_d.set_xticks(range(len(days)))
    ax_d.set_xticklabels(
        [d.strftime("%m-%d") for d in days], rotation=45, fontsize=7
    )
    ax_d.set_title(f"{len(times)} timesteps by day")
    hours = [t.hour for t in times]
    ax_h.hist(hours, bins=np.arange(25) - 0.5)
    ax_h.set_xticks(range(0, 25, 6))
    ax_h.set_title("by hour")
    fig.tight_layout()
    return fig, (ax_d, ax_h)


def plot_daily_hist(ax, times: Sequence[datetime.datetime]):
    """Bar chart of timestep counts per day onto an existing axis
    (reference _timestep_histograms.py plot_daily_hist)."""
    days = sorted({t.date() for t in times})
    counts = [sum(1 for t in times if t.date() == d) for d in days]
    ax.bar(range(len(days)), counts)
    ax.set_xticks(range(len(days)))
    ax.set_xticklabels([d.strftime("%m-%d") for d in days], rotation=45,
                       fontsize=7)
    ax.set_ylabel("count of timesteps")
    return ax


def plot_hourly_hist(ax, times: Sequence[datetime.datetime]):
    """Histogram of timestep hours-of-day onto an existing axis
    (reference _timestep_histograms.py plot_hourly_hist)."""
    ax.hist([t.hour for t in times], bins=np.arange(25) - 0.5)
    ax.set_xticks(range(0, 25, 6))
    ax.set_xlabel("hour of day")
    ax.set_ylabel("count of timesteps")
    return ax


#: lowercase alias matching the reference export name (fv3viz.wong_palette)
wong_palette = WONG_PALETTE
