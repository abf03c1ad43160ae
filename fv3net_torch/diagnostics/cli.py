"""``prognostic-run-diags-torch`` CLI: compute / metrics / report and the
run-browsing subcommands (port of ``fv3net_tpu/diagnostics/cli.py``;
reference: workflows/diagnostics/fv3net/diagnostics/prognostic_run/
cli.py:16-47).

``compute`` and ``metrics`` run on ``--device`` (default ``cuda``; without
a card that raises: pass ``--device cpu``).  ``report``, ``movies`` and
``plot`` draw with matplotlib, imported where the reference imports it:
where it is not installed they raise its ``ImportError``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

import numpy as np


def _load_run(url: str):
    """Concatenate diagnostics zarrs across run segments in time (host
    arrays)."""
    from fv3net_torch.core import zarrio
    from fv3net_torch.core.dataset import Dataset
    from fv3net_torch.core.quantity import Quantity

    artifacts = os.path.join(url, "artifacts")
    datasets = []
    if os.path.isdir(artifacts):
        for seg in sorted(os.listdir(artifacts)):
            p = os.path.join(artifacts, seg, "diags.zarr")
            if os.path.isdir(p):
                datasets.append(zarrio.open_zarr(p))
    elif url.endswith(".zarr"):
        datasets.append(zarrio.open_zarr(url))
    if not datasets:
        raise FileNotFoundError(f"no diagnostics zarrs found under {url}")
    if len(datasets) == 1:
        return datasets[0]
    merged = {}
    for name in datasets[0]:
        arrs = [np.asarray(d[name].data) for d in datasets if name in d]
        merged[name] = Quantity(
            np.concatenate(arrs, axis=0), datasets[0][name].dims,
            datasets[0][name].units,
        )
    return Dataset(merged)


def _grid_for(ds) -> Dict[str, np.ndarray]:
    """The run's C{n} grid; every cell sea (an all-zero land-sea mask),
    as the reference has it."""
    from fv3net_torch.grid.geometry import make_grid

    n = next(iter(ds.values())).shape[-1]
    grid = make_grid(n)
    return {
        "lat": np.rad2deg(grid.lat),
        "lon": np.rad2deg(grid.lon),
        "area": grid.area,
        "land_sea_mask": np.zeros_like(grid.area),
        "_grid": grid,
    }


def compute_cmd(url: str, output: str, verification: Optional[str] = None,
                device="cuda") -> None:
    """Every diagnostic of both registries on ``device``, written to the
    zarr ``output`` (and the scalar ones to ``output``.scalars.json)."""
    from fv3net_torch.core import zarrio
    from fv3net_torch.core.dataset import Dataset
    from fv3net_torch.diagnostics.prognostic.compute import compute_all
    from fv3net_torch.pipelines import resolve_device

    device = resolve_device(device)
    run = _load_run(url)
    grid = _grid_for(run)
    verif = _load_run(verification) if verification else None
    diags = compute_all(run, grid, verif, device=device)
    out = Dataset({k: v for k, v in diags.items() if v.ndim > 0})
    zarrio.to_zarr(out, output)
    scalars = {k: float(v.values) for k, v in diags.items() if v.ndim == 0}
    if scalars:
        with open(output + ".scalars.json", "w") as f:
            json.dump(scalars, f)


def metrics_cmd(diags_path: str, output: str, device="cuda") -> None:
    """The scalar metrics of a computed diagnostics zarr, reduced on
    ``device``, written as JSON."""
    from fv3net_torch.core import zarrio
    from fv3net_torch.diagnostics.transform import on_device
    from fv3net_torch.diagnostics.prognostic.metrics import (
        compute_metrics,
        dump_metrics,
    )
    from fv3net_torch.pipelines import resolve_device

    device = resolve_device(device)
    diags = on_device(zarrio.open_zarr(diags_path), device)
    metrics = compute_metrics({k: diags[k] for k in diags})
    dump_metrics(metrics, output)


def report_cmd(diags_path: str, output_dir: str, title: str = "Prognostic run report") -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from fv3net_torch.core import zarrio
    from fv3net_torch.diagnostics.prognostic.metrics import compute_metrics
    from fv3net_torch.report import ImagePlot, create_report

    diags = zarrio.open_zarr(diags_path)
    sections = {"Time series": [], "Zonal means": [], "Maps": []}
    for name in sorted(diags):
        q = diags[name]
        arr = np.asarray(q.data)
        if name.endswith("_spatial_mean_global") or name.endswith("_rms_global"):
            fig, ax = plt.subplots(figsize=(6, 3))
            ax.plot(arr)
            ax.set_title(name)
            ax.set_xlabel("output time index")
            sections["Time series"].append(ImagePlot(fig, caption=name))
            plt.close(fig)
        elif name.endswith("_zonal_and_time_mean"):
            fig, ax = plt.subplots(figsize=(6, 3))
            lat = np.asarray(q.attrs.get("latitude", range(arr.shape[-1])))
            ax.plot(lat, arr)
            ax.set_title(name)
            ax.set_xlabel("latitude [deg]")
            sections["Zonal means"].append(ImagePlot(fig, caption=name))
            plt.close(fig)
        elif name.endswith("_time_mean_value") and arr.ndim == 3:
            from fv3net_torch.grid.geometry import make_grid
            from fv3net_torch.viz import plot_cube

            grid = make_grid(arr.shape[-1])
            fig, ax, _ = plot_cube(grid, arr, title=name)
            sections["Maps"].append(ImagePlot(fig, caption=name))
            plt.close(fig)
    metrics = {
        k: f"{v['value']:.4g} {v['units']}"
        for k, v in compute_metrics({k: diags[k] for k in diags}).items()
    }
    path = create_report(sections, title, output_dir, metrics=metrics)
    print(path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("prognostic-run-diags-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("compute")
    p.add_argument("url")
    p.add_argument("output")
    p.add_argument("--verification", default=None)
    p.add_argument("--device", default="cuda",
                   help="device of the computation (default cuda)")

    p = sub.add_parser("metrics")
    p.add_argument("diags")
    p.add_argument("output")
    p.add_argument("--device", default="cuda",
                   help="device of the reductions (default cuda)")

    p = sub.add_parser("report")
    p.add_argument("diags")
    p.add_argument("output_dir")

    p = sub.add_parser("movies", help="animated cube maps per variable")
    p.add_argument("url", help="run dir or zarr with [time,tile,y,x] vars")
    p.add_argument("output_dir")
    p.add_argument("--names", nargs="*", default=None)

    p = sub.add_parser(
        "shell", help="interactive shell with the run data loaded as `ds`"
    )
    p.add_argument("url")

    p = sub.add_parser(
        "log-viewer", help="summarize a run's JSON statistics stream"
    )
    p.add_argument("logfile")

    p = sub.add_parser(
        "log-viewer-web",
        help="streamlit webapp plotting the statistics series of a "
        "(segmented) run (reference apps/log_viewer.py)",
    )
    p.add_argument("url")

    p = sub.add_parser(
        "plot",
        help="render one variable's cube map inline in the terminal "
        "(iTerm2/WezTerm inline-image protocol; falls back to a PNG "
        "file)",
    )
    p.add_argument("url")
    p.add_argument("variable")
    p.add_argument("--time", type=int, default=-1, help="time index")

    args = parser.parse_args(argv)
    if args.command == "compute":
        compute_cmd(args.url, args.output, args.verification, args.device)
    elif args.command == "metrics":
        metrics_cmd(args.diags, args.output, args.device)
    elif args.command == "report":
        from fv3net_torch.diagnostics.computed import detect_folders

        if os.path.isdir(args.diags) and detect_folders(args.diags):
            comparison_report_cmd(args.diags, args.output_dir)
        else:
            report_cmd(args.diags, args.output_dir)
    elif args.command == "movies":
        movies_cmd(args.url, args.output_dir, args.names)
    elif args.command == "shell":
        shell_cmd(args.url)
    elif args.command == "log-viewer":
        log_viewer_cmd(args.logfile)
    elif args.command == "log-viewer-web":
        from fv3net_torch.diagnostics.prognostic.apps.log_viewer import (
            run_app,
        )

        run_app(args.url)
    elif args.command == "plot":
        plot_cmd(args.url, args.variable, args.time)
    return 0


def plot_cmd(url: str, variable: str, time_index: int = -1) -> None:
    """Cube-map plot of one variable, rendered inline when the terminal
    supports the iTerm2 image protocol (reference iterm.py role)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from fv3net_torch.core.zarrio import open_zarr
    from fv3net_torch.diagnostics.prognostic.iterm import imgcat
    from fv3net_torch.grid.geometry import make_grid
    from fv3net_torch.viz import plot_cube

    ds = open_zarr(_find_state_zarr(url))
    q = ds[variable]
    data = np.asarray(q.data)
    dims = list(q.dims)
    if "time" in dims:
        data = np.take(data, time_index, axis=dims.index("time"))
        dims.remove("time")
    if "z" in dims:  # surface level (z is ordered top-down)
        data = np.take(data, -1, axis=dims.index("z"))
        dims.remove("z")
    n = data.shape[-1]
    fig, _ax, _mesh = plot_cube(make_grid(n), data, title=variable)
    print(imgcat(fig, filename=f"{variable}.png"))
    plt.close(fig)


def movies_cmd(url: str, output_dir: str, names=None) -> None:
    """(reference diagnostics/prognostic_run/cli.py movies subcommand)"""
    from fv3net_torch.core.zarrio import open_zarr
    from fv3net_torch.diagnostics.movies import create_movies_for_dataset
    from fv3net_torch.grid.geometry import make_grid

    ds = open_zarr(_find_state_zarr(url))
    n = next(iter(ds.values())).shape[-1]
    os.makedirs(output_dir, exist_ok=True)
    written = create_movies_for_dataset(ds, make_grid(n), output_dir, names)
    for path in written:
        print(path)


def shell_cmd(url: str) -> None:
    """(reference diagnostics/prognostic_run/shell.py: drop into an
    interactive session with the run data opened)"""
    import code

    from fv3net_torch.core.zarrio import open_zarr

    ds = open_zarr(_find_state_zarr(url))
    banner = (
        f"run data from {url} loaded as `ds` "
        f"({len(list(ds.keys()))} variables)"
    )
    code.interact(banner=banner, local={"ds": ds})


def _find_state_zarr(url: str) -> str:
    if os.path.exists(os.path.join(url, ".zgroup")):
        return url
    for cand in ("state_after_timestep.zarr", "diags.zarr"):
        p = os.path.join(url, cand)
        if os.path.exists(p):
            return p
    # segmented-run layout: artifacts/<seg>/<name>.zarr
    art = os.path.join(url, "artifacts")
    if os.path.isdir(art):
        for seg in sorted(os.listdir(art)):
            for entry in sorted(os.listdir(os.path.join(art, seg))):
                if entry.endswith(".zarr"):
                    return os.path.join(art, seg, entry)
    raise FileNotFoundError(f"no zarr store found under {url}")


def log_viewer_cmd(logfile: str) -> None:
    """Print a table of the per-step statistics stream (the reference's
    log-viewer subcommand, cli.py:16-33)."""
    from fv3net_torch.runtime.logs import loads

    with open(logfile) as f:
        log = loads(f.read())
    if not log.times:
        print("no statistics records found")
        return
    names = sorted(log.scalars)
    print(f"{len(log.times)} steps, {log.times[0]} .. {log.times[-1]}")
    for name in names:
        vals = np.asarray(log.scalars[name])
        finite = vals[np.isfinite(vals)]
        if len(finite):
            print(
                f"  {name}: first={finite[0]:.4g} last={finite[-1]:.4g} "
                f"min={finite.min():.4g} max={finite.max():.4g}"
            )


def comparison_report_cmd(bucket: str, output_dir: str) -> None:
    """Multi-run comparison report: a bucket of <run>/diags.zarr folders
    becomes one HTML with per-run-overlaid time series / zonal means and
    a metrics table (reference computed_diagnostics.py +
    views/static_report.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from fv3net_torch.diagnostics.computed import load_diagnostics, load_metrics
    from fv3net_torch.report import ImagePlot, create_report

    diags = load_diagnostics(bucket)
    metrics = load_metrics(bucket)
    sections = {"Time series": [], "Zonal means": []}
    for varfilter, section, xlabel in (
        ("_spatial_mean_global", "Time series", "output time index"),
        ("_rms_global", "Time series", "output time index"),
        ("_zonal_and_time_mean", "Zonal means", "latitude [deg]"),
    ):
        for name in sorted(diags.matching_variables(varfilter)):
            fig, ax = plt.subplots(figsize=(6, 3))
            for run in diags.runs:
                q = diags.get_variable(run, name)
                arr = np.asarray(q.data)
                if varfilter == "_zonal_and_time_mean":
                    x = np.asarray(q.attrs.get("latitude", range(arr.shape[-1])))
                    ax.plot(x, arr, label=run)
                else:
                    ax.plot(arr, label=run)
            ax.set_title(name)
            ax.set_xlabel(xlabel)
            ax.legend(fontsize=7)
            sections[section].append(ImagePlot(fig, caption=name))
            plt.close(fig)
    table = {}
    for mtype in sorted(metrics.types):
        for var in sorted(metrics.get_metric_variables(mtype)):
            key = metrics.metric_name(mtype, var)
            table[key] = " | ".join(
                f"{run}: {metrics.get_metric_value(mtype, var, run):.4g} "
                f"{metrics.get_metric_units(mtype, var, run)}"
                for run in metrics.runs
            )
    path = create_report(
        sections,
        f"comparison of {len(diags.runs)} runs",
        output_dir,
        metrics=table or None,
    )
    print(path)


if __name__ == "__main__":
    sys.exit(main())
