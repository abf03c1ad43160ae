"""Offline ML model evaluation on stacked samples (port of
``fv3net_tpu/diagnostics/offline/_sample.py``; reference:
workflows/diagnostics/fv3net/diagnostics/offline/compute.py, ``python -m
fv3net.diagnostics.offline.compute``): a trained predictor evaluated
against held-out batches, R2 / RMSE / bias per variable (column-resolved
and column-integrated), on the batches' device, plus an HTML report
(offline/views/).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.diagnostics.transform import tensor
from fv3net_torch.ops import statistics as stats

logger = logging.getLogger(__name__)


def _cat(datasets, var) -> torch.Tensor:
    return torch.cat([tensor(d[var].data) for d in datasets], dim=0)


def _density(t, p, n: int = 40):
    """Predicted-against-target joint counts over ``n`` equal bins
    spanning both (the reference's left-side ``searchsorted`` less one,
    clipped), as fractions; None where the span is empty."""
    lo = float(torch.minimum(t.min(), p.min()))
    hi = float(torch.maximum(t.max(), p.max()))
    if not hi > lo:
        return None
    # the reference's (jnp.linspace's) edges: lo (1 - s) + hi s
    step = np.arange(n, dtype=np.float64) / n
    edges = tensor(np.append(lo * (1.0 - step) + hi * step, hi), like=t)

    def bucket(x):
        i = torch.searchsorted(edges, x.reshape(-1).to(
            torch.float64).contiguous())
        return torch.clamp(i - 1, 0, n - 1)

    dens = torch.bincount(bucket(t) * n + bucket(p),
                          minlength=n * n).to(torch.float32).reshape(n, n)
    return Quantity(dens / torch.clamp(dens.sum(), min=1),
                    ("target_bins", "predicted_bins"), "fraction",
                    attrs={"edges": edges.cpu().numpy().tolist()})


def compute_offline_diags(
    model, batches: List[Dataset]
) -> Dict[str, Quantity]:
    """Per-output-variable verification diagnostics over test batches
    (tensors on one device, the model's)."""
    preds = []
    truths = []
    for batch in batches:
        pred = model.predict(batch)
        preds.append(pred)
        truths.append(batch)

    delp = None
    if "pressure_thickness_of_atmospheric_layer" in truths[0]:
        delp = _cat(truths, "pressure_thickness_of_atmospheric_layer")

    out: Dict[str, Quantity] = {}
    n_samples = 0
    for var in model.output_variables:
        if var not in truths[0]:
            continue
        p = _cat(preds, var)
        t = _cat(truths, var)
        n_samples = int(p.shape[0])
        out[f"{var}_r2"] = Quantity(stats.r2_score(t, p), ())
        out[f"{var}_rmse"] = Quantity(stats.root_mean_squared_error(t, p), ())
        out[f"{var}_bias"] = Quantity(stats.bias(t, p), ())
        if p.ndim == 2:  # [sample, z] -> per-level profiles
            out[f"{var}_r2_profile"] = Quantity(
                stats.r2_score(t, p, axis=0), ("z",)
            )
            out[f"{var}_rmse_profile"] = Quantity(
                stats.root_mean_squared_error(t, p, axis=0), ("z",)
            )
            out[f"{var}_bias_profile"] = Quantity(stats.bias(t, p, axis=0),
                                                  ("z",))
            # predicted-vs-target joint density (the reference's
            # offline/views scatter/density panels)
            density = _density(t, p)
            if density is not None:
                out[f"{var}_density"] = density
            # column-integrated (mass-weighted) skill, the reference's
            # column_integrated_* diagnostics
            if delp is not None and delp.shape == p.shape:
                from fv3net_torch.core.constants import GRAVITY

                p_col = (p * delp).sum(dim=1) / GRAVITY
                t_col = (t * delp).sum(dim=1) / GRAVITY
                out[f"column_integrated_{var}_r2"] = Quantity(
                    stats.r2_score(t_col, p_col), ()
                )
                out[f"column_integrated_{var}_bias"] = Quantity(
                    stats.bias(t_col, p_col), ()
                )
    out["n_test_samples"] = Quantity(
        torch.tensor(float(n_samples), dtype=torch.float64), ())
    return out


def input_sensitivity(model, batch: Dataset) -> Dict[str, np.ndarray]:
    """Input -> output Jacobians at the batch's mean inputs (reference
    offline/_input_sensitivity.py), through ``fit/input_sensitivity.py``:
    {f"{out}__{in}": [z_out, z_in]} host arrays; empty for a model that
    reports no Jacobians (a missing input, a model the Jacobians cannot
    differentiate, one that reports feature importances)."""
    from fv3net_torch.fit.input_sensitivity import (
        input_sensitivity as sensitivity,
    )

    base = {}
    for name in model.input_variables:
        if name not in batch:
            return {}
        base[name] = tensor(batch[name].data).mean(dim=0)
    try:
        jacs = sensitivity(model, base).jacobians
    except (AttributeError, NotImplementedError):
        logger.exception("no Jacobians of %s", type(model).__name__)
        return {}
    if jacs is None:
        return {}
    return {f"{out_name}__{in_name}": np.asarray(mat)
            for out_name, per_in in jacs.items()
            for in_name, mat in per_in.items()}


def offline_report(
    diags: Dict[str, Quantity], output_dir: str,
    title: str = "Offline ML diagnostics",
    sensitivities: Optional[Dict[str, np.ndarray]] = None,
) -> str:
    """HTML report of the offline evaluation (reference offline/views/:
    metric table, vertical-profile skill panels, predicted-vs-target
    density panels, input-sensitivity Jacobian heatmaps)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from fv3net_torch.report import ImagePlot, create_report

    scalars = {
        k: f"{float(v.values):.4g}"
        for k, v in diags.items()
        if v.ndim == 0
    }
    sections = {"Vertical profiles": [], "Predicted vs target": []}
    for name, q in diags.items():
        if q.ndim == 1:
            fig, ax = plt.subplots(figsize=(4, 4))
            arr = q.values
            ax.plot(arr, np.arange(len(arr)))
            ax.invert_yaxis()
            ax.set_ylabel("level (0 = top)")
            ax.set_title(name)
            if name.endswith("_r2_profile"):
                ax.set_xlim(-0.5, 1.0)
            sections["Vertical profiles"].append(
                ImagePlot(fig, caption=name)
            )
            plt.close(fig)
        elif q.ndim == 2 and name.endswith("_density"):
            fig, ax = plt.subplots(figsize=(4, 4))
            dens = q.values
            edges = np.asarray(q.attrs.get("edges", np.arange(41)))
            ax.pcolormesh(
                edges, edges, np.log10(dens.T + 1e-8), cmap="viridis"
            )
            ax.plot(edges, edges, "w--", lw=0.7)
            ax.set_xlabel("target")
            ax.set_ylabel("predicted")
            ax.set_title(name)
            sections["Predicted vs target"].append(
                ImagePlot(fig, caption=name)
            )
            plt.close(fig)
    if sensitivities:
        sections["Input sensitivity (Jacobians)"] = []
        for name, mat in sensitivities.items():
            fig, ax = plt.subplots(figsize=(4, 4))
            vmax = np.abs(mat).max() or 1.0
            im = ax.pcolormesh(mat, cmap="RdBu_r", vmin=-vmax, vmax=vmax)
            fig.colorbar(im, ax=ax)
            out_name, in_name = name.split("__", 1)
            ax.set_xlabel(f"input level ({in_name})")
            ax.set_ylabel(f"output level ({out_name})")
            ax.set_title(name)
            sections["Input sensitivity (Jacobians)"].append(
                ImagePlot(fig, caption=name)
            )
            plt.close(fig)
    sections = {k: v for k, v in sections.items() if v}
    return create_report(sections, title, output_dir, metrics=scalars)


def matplotlib_missing() -> bool:
    """True (with a warning logged) where matplotlib is not installed:
    the CLIs then write their files without the HTML report."""
    if importlib.util.find_spec("matplotlib") is None:
        logger.warning("matplotlib is not installed: no HTML report")
        return True
    return False


def data_dtype(model, data: Dataset) -> torch.dtype:
    """The dtype of the model's first input in ``data``."""
    return tensor(data[model.input_variables[0]].data).dtype


def model_on(model, device, dtype=None):
    """A loaded model on ``device``; a torch module also in ``dtype``
    where that is wider than its own (the reference computes a float32
    model on float64 inputs in float64)."""
    if isinstance(model, torch.nn.Module):
        own = next(model.parameters(), None)
        if dtype is not None and own is not None:
            dtype = torch.promote_types(own.dtype, dtype)
        return model.to(device=device, dtype=dtype)
    return model.to(device=device) if hasattr(model, "to") else model


def main(argv=None) -> int:
    """CLI: offline compute on stacked batches (reference
    offline/compute.py:61,315), on ``--device`` (default cuda)."""
    import yaml

    from fv3net_torch.fit import io as fit_io
    from fv3net_torch.fit.train import batches_on
    from fv3net_torch.loaders import batches_from_config
    from fv3net_torch.pipelines import resolve_device

    parser = argparse.ArgumentParser("offline-diags")
    parser.add_argument("model_path")
    parser.add_argument("data_config")
    parser.add_argument("output_dir")
    parser.add_argument("--device", default="cuda",
                        help="device of the evaluation (default cuda)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    with open(args.data_config) as f:
        data_config = yaml.safe_load(f)
    batches = list(batches_on(batches_from_config(data_config), device))
    model = fit_io.load(args.model_path)
    model = model_on(model, device, data_dtype(model, batches[0])
                     if batches else None)
    diags = compute_offline_diags(model, batches)
    sens = input_sensitivity(model, batches[0]) if batches else {}
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
        json.dump(
            {k: float(v.values) for k, v in diags.items()
             if v.ndim == 0},
            f,
            indent=2,
        )
    if not matplotlib_missing():
        offline_report(diags, args.output_dir, sensitivities=sens)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
