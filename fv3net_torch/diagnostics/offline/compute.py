"""Offline evaluation CLI over cube-shaped test data (port of
``fv3net_tpu/diagnostics/offline/compute.py``; console script
``offline-diags-torch``).

Reference: workflows/diagnostics/fv3net/diagnostics/offline/compute.py
:61-426 -- ``python -m fv3net.diagnostics.offline.compute model data.yaml
out``: run the model over held-out data, insert the prediction next to
the target under a ``derivation`` dimension, compute the masked/zonal/
diurnal/pressure-level diagnostics registry + derived R2/RMSE, save a
snapshot and a meridional transect, write ``offline_diagnostics.nc``-
equivalent zarr, ``scalar_metrics.json``, ``metadata.json``, and the
HTML report.  The model predicts, and every diagnostic computes, on
``--device`` (default ``cuda``; without a card that raises: pass
``--device cpu``).  Where matplotlib is not installed the files are
written without the HTML report.

Data config (YAML): ``{path: <zarr>, variables: [...], timesteps: [...],
grid: c48}``; the zarr holds [time, tile, (z,) y, x] variables (the
run-output layout); grid geometry resolves through the catalog
(grid/cN + landseamask/cN).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.diagnostics.offline import _sample
from fv3net_torch.diagnostics.offline.compute_diagnostics import (
    DiagArg,
    compute_diagnostics,
)
from fv3net_torch.diagnostics.offline.derived import (
    derived_registry,
    insert_r2,
    insert_rmse,
)
from fv3net_torch.diagnostics.offline.select import (
    meridional_transect,
    select_snapshot,
)
from fv3net_torch.diagnostics.transform import tensor

DELP = "pressure_thickness_of_atmospheric_layer"
DIAGS_ZARR_NAME = "offline_diagnostics.zarr"
TRANSECT_ZARR_NAME = "transect_lon0.zarr"
METRICS_JSON_NAME = "scalar_metrics.json"
METADATA_JSON_NAME = "metadata.json"


def _stack_cube_var(q) -> torch.Tensor:
    arr = tensor(q.data)
    if "z" in q.dims:
        arr = arr.movedim(q.dims.index("z"), -1)
        return arr.reshape(-1, arr.shape[-1])
    return arr.reshape(-1)


def predict_on_cube(model, ds: Dataset) -> Dataset:
    """Apply a stacked-sample Predictor to cube-shaped data: flatten
    (time, tile, y, x) to samples with z last, predict, restore the
    cube layout for the predicted variables."""
    stacked = {}
    cube_shape = None
    for name in model.input_variables:
        q = ds[name]
        stacked[name] = Quantity(
            _stack_cube_var(q),
            ("sample", "z") if "z" in q.dims else ("sample",),
        )
        if cube_shape is None:
            cube_shape = tuple(q.shape[q.dims.index(k)]
                               for k in ("time", "tile", "y", "x"))
    with torch.no_grad():
        pred = model.predict(Dataset(stacked))
    out = {}
    nt, ntile, ny, nx = cube_shape
    for name in pred:
        arr = tensor(pred[name].data)
        if arr.ndim == 2:
            nz = arr.shape[-1]
            cube = arr.reshape(nt, ntile, ny, nx, nz).movedim(-1, 2)
            dims = ("time", "tile", "z", "y", "x")
        else:
            cube = arr.reshape(nt, ntile, ny, nx)
            dims = ("time", "tile", "y", "x")
        units = ds[name].units if name in ds else ""
        out[name] = Quantity(cube, dims, units)
    return Dataset(out, dict(ds.coords), ds.attrs)


def insert_column_integrated_vars(ds: Dataset, delp) -> Dataset:
    """Add mass-weighted column integrals ``column_integrated_{var}``
    for every 3-D variable, in float64 (reference _helpers.py:237-252
    insert_column_integrated_vars)."""
    from fv3net_torch.core.constants import GRAVITY

    out = dict(ds.items())
    for name, q in ds.items():
        if "z" not in q.dims:
            continue
        arr = tensor(q.data, dtype=torch.float64)
        zax = q.dims.index("z")
        dp = tensor(delp, like=arr, dtype=torch.float64).broadcast_to(
            arr.shape)
        ci = (arr * dp).sum(dim=zax) / GRAVITY
        dims = tuple(d for d in q.dims if d != "z")
        out[f"column_integrated_{name}"] = Quantity(
            ci, dims, f"{q.units} kg/m^2" if q.units else "kg/m^2"
        )
    return Dataset(out, dict(ds.coords), ds.attrs)


def evaluate_cube(
    model,
    data: Dataset,
    grid: Dict[str, np.ndarray],
    snapshot_time: Optional[float] = None,
    transect_lon: float = 0.0,
) -> Dict[str, object]:
    """The _compute_diagnostics core (reference compute.py:143-178) on
    the device of ``data``'s tensors: returns dict with diags, scalar
    metrics, snapshot and transect."""
    prediction_full = predict_on_cube(model, data)
    prediction = Dataset(
        {
            v: prediction_full[v]
            for v in model.output_variables
            if v in prediction_full
        },
        dict(data.coords),
    )
    target = Dataset(
        {v: data[v] for v in model.output_variables if v in data},
        dict(data.coords),
    )
    delp = tensor(data[DELP].data) if DELP in data else None
    if delp is not None:
        prediction = insert_column_integrated_vars(prediction, delp)
        target = insert_column_integrated_vars(target, delp)
    diags = compute_diagnostics(prediction, target, grid, delp)
    diags = insert_r2(diags)
    diags = insert_rmse(diags)
    derived = derived_registry.compute(diags, allow_errors=True)
    diags.update(derived)

    scalar_metrics = {}
    for name, q in diags.items():
        if getattr(q, "ndim", None) == 0:
            value = float(q.values)
            if np.isfinite(value):
                scalar_metrics[name] = value

    # snapshot: nearest-time maps of predict + target for 3-D outputs
    # (reference compute.py:368-396)
    times = data.coords.get("time")
    t0 = (
        snapshot_time
        if snapshot_time is not None
        else (float(np.asarray(times)[0]) if times is not None else 0.0)
    )
    snap_pred = select_snapshot(prediction, t0)
    snap_tgt = select_snapshot(target, t0)
    snapshot = {}
    for v in snap_pred:
        snapshot[f"{v}_predict_snapshot"] = snap_pred[v]
        if v in snap_tgt:
            snapshot[f"{v}_target_snapshot"] = snap_tgt[v]

    # meridional transect of the snapshot's 3-D fields on pressure
    # levels (reference _get_transect, compute.py:190-210)
    transect = None
    if delp is not None:
        from fv3net_torch.diagnostics import transform as tfm

        snap_delp = delp[
            min(
                int(
                    np.argmin(
                        np.abs(np.asarray(times, np.float64) - t0)
                    )
                )
                if times is not None
                else 0,
                delp.shape[0] - 1,
            )
        ]
        vert_vars = [v for v in snap_pred if "z" in snap_pred[v].dims]
        if vert_vars:
            arg = DiagArg(
                Dataset({v: snap_pred[v] for v in vert_vars}),
                Dataset({v: snap_tgt[v] for v in vert_vars}),
                grid,
                delp=snap_delp,
            )
            on_p = tfm.regrid_zdim_to_pressure_levels(arg)
            tds = Dataset({})
            for v in vert_vars:
                tds[f"{v}_predict"] = on_p.prediction[v]
                tds[f"{v}_target"] = on_p.verification[v]
            transect = meridional_transect(tds, grid, lon=transect_lon)

    return {
        "diagnostics": diags,
        "scalar_metrics": scalar_metrics,
        "snapshot": snapshot,
        "transect": transect,
        "prediction": prediction,
        "target": target,
    }


def _load_cube_from_config(config: dict) -> Dataset:
    from fv3net_torch.core import zarrio

    ds = zarrio.open_zarr(config["path"])
    variables = config.get("variables")
    if variables:
        keep = [v for v in variables if v in ds]
        ds = Dataset(
            {v: ds[v] for v in keep}, dict(ds.coords), ds.attrs
        )
    timesteps = config.get("timesteps")
    if timesteps:
        ds = ds.isel(time=np.asarray(timesteps, int))
        t = ds.coords.get("time")
        if t is not None:
            ds.coords["time"] = np.asarray(t)[
                np.asarray(timesteps, int)
            ]
    return ds


def _grid_dict(res: str) -> Dict[str, np.ndarray]:
    from fv3net_torch import catalog

    g = catalog.get(f"grid/{res}")
    lsm = catalog.get(f"landseamask/{res}")
    return {
        "lat": np.asarray(g["lat"].data),
        "lon": np.asarray(g["lon"].data),
        "area": np.asarray(g["area"].data),
        "land_sea_mask": np.asarray(lsm["land_sea_mask"].data),
    }


def _on_host(result: Dict[str, object]) -> Dict[str, object]:
    """The evaluation's quantities as host arrays (for the report)."""

    def host(q):
        return Quantity(q.values, q.dims, q.units, dict(q.attrs))

    out = dict(result)
    for key in ("diagnostics", "snapshot"):
        out[key] = {k: host(q) for k, q in result[key].items()}
    if result["transect"] is not None:
        out["transect"] = result["transect"].map(host)
    return out


def main(argv=None) -> int:
    import yaml

    from fv3net_torch.core import zarrio
    from fv3net_torch.diagnostics.transform import grid_on, on_device
    from fv3net_torch.fit import io as fit_io
    from fv3net_torch.pipelines import resolve_device

    parser = argparse.ArgumentParser(
        "offline-diags-torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("model_path")
    parser.add_argument("data_yaml")
    parser.add_argument("output_path")
    parser.add_argument(
        "--snapshot-time", type=float, default=None,
        help="time (hours) of the snapshot; nearest time is used",
    )
    parser.add_argument(
        "--evaluation-grid", type=str, default=None,
        help="grid resolution (e.g. c48); inferred from data if omitted",
    )
    parser.add_argument("--transect-lon", type=float, default=0.0)
    parser.add_argument("--device", default="cuda",
                        help="device of the prediction and the "
                             "diagnostics (default cuda)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    with open(args.data_yaml) as f:
        data_config = yaml.safe_load(f)

    data = on_device(_load_cube_from_config(data_config), device)
    res = (
        args.evaluation_grid
        or data_config.get("grid")
        or f"c{data[list(data.keys())[0]].shape[-1]}"
    )
    grid = grid_on(_grid_dict(res), device)
    model = fit_io.load(args.model_path)
    model = _sample.model_on(model, device, _sample.data_dtype(model, data))

    result = evaluate_cube(
        model,
        data,
        grid,
        snapshot_time=args.snapshot_time,
        transect_lon=args.transect_lon,
    )

    os.makedirs(args.output_path, exist_ok=True)
    # offline_diagnostics store (diags + snapshot maps), reference
    # DIAGS_NC_NAME
    store = {k: v for k, v in result["diagnostics"].items()
             if getattr(v, "ndim", 0) > 0}
    store.update(result["snapshot"])
    zarrio.to_zarr(
        Dataset(store),
        os.path.join(args.output_path, DIAGS_ZARR_NAME),
    )
    if result["transect"] is not None:
        zarrio.to_zarr(
            result["transect"],
            os.path.join(args.output_path, TRANSECT_ZARR_NAME),
        )
    with open(
        os.path.join(args.output_path, METRICS_JSON_NAME), "w"
    ) as f:
        json.dump(result["scalar_metrics"], f, indent=4)
    metadata = {
        "model_path": args.model_path,
        "data_config": data_config,
    }
    with open(
        os.path.join(args.output_path, METADATA_JSON_NAME), "w"
    ) as f:
        json.dump(metadata, f, indent=4)

    if _sample.matplotlib_missing():
        return 0
    # input-sensitivity figure (reference plot_input_sensitivity)
    stacked = {
        n: Quantity(
            _stack_cube_var(data[n]),
            ("sample", "z") if "z" in data[n].dims else ("sample",),
        )
        for n in model.input_variables
        if n in data
    }
    sens = _sample.input_sensitivity(model, Dataset(stacked))

    from fv3net_torch.diagnostics.offline.views import create_offline_report

    create_offline_report(
        _on_host(result), args.output_path, sensitivities=sens
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
