"""Offline reservoir-model diagnostics (port of
``fv3net_tpu/diagnostics/reservoir.py``).

Reference semantics: workflows/diagnostics/fv3net/diagnostics/reservoir/
compute.py + external/fv3fit/fv3fit/reservoir/validation.py: run a
trained reservoir over a validation time series (teacher-forced one-step
predictions after a synchronization spin-up), then report time-mean
target/prediction/error fields and scalar skill metrics (MSE/MAE/R2,
grid-scale spatial-variance ratio).

The rollout is the model's ``predict``: a loop over the series' times,
each step one ``fit/reservoir.py::reservoir_increment`` and one readout
on the model's device, in float32 (the reference's state dtype).  Every
reservoir model ``fit.io.load`` reads runs: pure, hybrid, and subdomain
with or without a latent-space transformer.

    python -m fv3net_torch.diagnostics.reservoir MODEL OUT VALIDATION.zarr \
        N_SYNCHRONIZE [--input-name inputs] [--target-name NAME] \
        [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.diagnostics.transform import tensor


def validation_prediction(model, inputs, n_synchronize: int,
                          targets=None):
    """Teacher-forced one-step predictions after spin-up.

    Args:
        model: a trained reservoir (pure, hybrid or subdomain).
        inputs: ``[time, ..., features]`` true state series.
        n_synchronize: steps used only to spin the reservoir state up
            (reference compute.py ``n_synchronize`` argument).
        targets: optional ``[time, ..., outputs]`` series paired with
            ``inputs`` as a trainer pairs them (the readout after
            inputs[t] estimates targets[t]); without it the readout after
            inputs[t] estimates inputs[t + 1], as in the reference.

    Returns:
        (predictions, targets) in float32: without ``targets``
        ``[time - n_synchronize - 1, ..., features]``, predictions[t]
        estimating inputs[n_synchronize + 1 + t]; with them
        ``[time - n_synchronize, ..., outputs]``.
    """
    # float32 like the model weights (the reference's cast)
    u = tensor(inputs, device=model.W.device).to(torch.float32)
    if n_synchronize >= u.shape[0] - 1:
        raise ValueError(
            f"n_synchronize={n_synchronize} leaves no validation steps "
            f"of {u.shape[0]} total"
        )
    # the model's readout after each step, from a zero state (its
    # predict: the loop over reservoir_increment)
    preds = model.predict(Dataset({"inputs": Quantity(
        u, tuple(f"dim_{i}" for i in range(u.ndim)))}))["outputs"].data
    if targets is not None:
        y = tensor(targets, like=u).to(torch.float32)
        return preds[n_synchronize:], y[n_synchronize:]
    # preds[t] is the model's estimate of u[t+1]
    return preds[n_synchronize:-1], u[n_synchronize + 1:]


def _spatial_variance_zsum(arr: torch.Tensor) -> float:
    """Rough grid-scale spatial variance of a [time, ..., features]
    array (reference validation.py:23-42 _compute_2d_variance_mean_zsum,
    taken over the stacked sample axes): the ratio diagnostic detects
    variance collapse or blowup in predictions."""
    return float(torch.var(arr, dim=tuple(range(1, arr.ndim)),
                           correction=0).mean())


def compute_reservoir_diagnostics(
    model,
    validation: Dataset,
    n_synchronize: int,
    input_name: str = "inputs",
    target_name: Optional[str] = None,
):
    """Returns (diags Dataset, metrics dict); with ``target_name`` the
    predictions are held against that series, paired with the inputs
    (see :func:`validation_prediction`)."""
    dims = validation[target_name or input_name].dims[1:]
    preds, targets = validation_prediction(
        model, validation[input_name].data, n_synchronize,
        None if target_name is None else validation[target_name].data)
    err = preds - targets
    diags = Dataset(
        {
            "time_mean_prediction": Quantity(preds.mean(dim=0), dims),
            "time_mean_target": Quantity(targets.mean(dim=0), dims),
            "time_mean_error": Quantity(err.mean(dim=0), dims),
        }
    )
    mse = float(torch.mean(err ** 2))
    var = float(torch.var(targets, correction=0))
    target_variance = _spatial_variance_zsum(targets)
    metrics = {
        "mse": mse,
        "mae": float(torch.mean(torch.abs(err))),
        "r2": 1.0 - mse / var if var > 0 else float("nan"),
        "variance_ratio": (
            _spatial_variance_zsum(preds) / target_variance
            if target_variance > 0
            else float("nan")
        ),
        "n_validation_steps": int(preds.shape[0]),
    }
    return diags, metrics


def main(argv: Optional[list] = None) -> int:
    """CLI (reference reservoir/compute.py argparse surface), on
    ``--device`` (default ``cuda``)."""
    from fv3net_torch.core.zarrio import open_zarr, to_zarr
    from fv3net_torch.diagnostics.transform import on_device
    from fv3net_torch.fit import io as fit_io
    from fv3net_torch.pipelines import resolve_device

    p = argparse.ArgumentParser("reservoir-diags")
    p.add_argument("reservoir_model_path")
    p.add_argument("output_path")
    p.add_argument("validation_zarr")
    p.add_argument("n_synchronize", type=int)
    p.add_argument("--input-name", default="inputs")
    p.add_argument("--target-name", default=None,
                   help="a series paired with the inputs (default: the "
                        "inputs one step ahead)")
    p.add_argument("--device", default="cuda",
                   help="device of the rollout (default cuda)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    model = fit_io.load(args.reservoir_model_path).to(device=device)
    validation = on_device(open_zarr(args.validation_zarr), device)
    diags, metrics = compute_reservoir_diagnostics(
        model, validation, args.n_synchronize, args.input_name,
        args.target_name,
    )
    os.makedirs(args.output_path, exist_ok=True)
    to_zarr(diags, os.path.join(args.output_path, "diags.zarr"))
    with open(os.path.join(args.output_path, "metrics.json"), "w") as f:
        json.dump(metrics, f)
    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
