"""Microphysics-emulation diagnostics (port of
``fv3net_tpu/diagnostics/emulation.py``).

Reference semantics: workflows/diagnostics/fv3net/diagnostics/
prognostic_run/emulation/{tendencies.py,single_run.py}: evaluate a
piggy-backed emulator run: per-stage tendency accessors
(``tendency_of_{field}_due_to_{zhao_carr,gscond}_{emulator,physics}``),
emulator-vs-physics skill metrics, and global-mean drift rates of the
prognostic fields over several time horizons.  The reductions run where
the data's tensors lie; ``main`` moves the stores to ``--device``
(default ``cuda``; without a card that raises: pass ``--device cpu``).

    python -m fv3net_torch.diagnostics.emulation DIAGS.zarr \
        [--state-zarr STATE.zarr] [--dt-seconds 900] [--output M.json] \
        [--device cuda]
"""
from __future__ import annotations

import argparse
import json
from typing import Mapping, Optional, Sequence

import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.diagnostics.transform import tensor

#: fields evaluated by the reference single-run report
FIELDS = ("air_temperature", "specific_humidity", "cloud_water")
DRIFT_VARIABLES = ("air_temperature", "specific_humidity")
DRIFT_HOURS = (3.0, 24.0, 120.0)


def _data(data: Dataset, name: str) -> torch.Tensor:
    return tensor(data[name].data)


def gscond_tendency(data: Dataset, field: str, source: str):
    """Condensation-stage tendency (reference tendencies.py:4-9: the
    emulator's cloud-water gscond tendency is minus its humidity
    tendency; gscond conserves water between q and qc)."""
    if field == "cloud_water" and source == "emulator":
        return -_data(
            data, f"tendency_of_specific_humidity_due_to_gscond_{source}")
    return _data(data, f"tendency_of_{field}_due_to_gscond_{source}")


def total_tendency(data: Dataset, field: str, source: str):
    """Whole-microphysics tendency (reference tendencies.py:11-12)."""
    return _data(data, f"tendency_of_{field}_due_to_zhao_carr_{source}")


def precpd_tendency(data: Dataset, field: str, source: str):
    """Precipitation-stage tendency = total - gscond (reference
    tendencies.py:15-16)."""
    return total_tendency(data, field, source) - gscond_tendency(
        data, field, source
    )


def surface_precipitation(data: Dataset, source: str):
    """(reference tendencies.py:19-20)"""
    return _data(data, f"surface_precipitation_due_to_zhao_carr_{source}")


def _skill(err, truth):
    """(mse, bias, 1 - mse / Var(truth)) as floats; the skill NaN where
    the truth does not vary."""
    mse = float(torch.mean(err ** 2))
    var = float(torch.var(truth, correction=0))
    return mse, float(torch.mean(err)), (1.0 - mse / var if var > 0
                                         else float("nan"))


def emulation_skill(
    data: Dataset,
    fields: Sequence[str] = FIELDS,
    stage: str = "zhao_carr",
) -> Mapping[str, float]:
    """Per-field emulator-vs-physics skill over all available samples
    (reference single_run.py skill metrics): MSE, bias and the
    variance-normalized skill 1 - MSE/Var(physics)."""
    accessor = total_tendency if stage == "zhao_carr" else gscond_tendency
    out = {}
    for field in fields:
        try:
            emu = accessor(data, field, "emulator")
            phys = accessor(data, field, "physics")
        except KeyError:
            continue
        mse, bias, skill = _skill(emu - phys, phys)
        out[f"mse/{stage}/{field}"] = mse
        out[f"bias/{stage}/{field}"] = bias
        out[f"skill/{stage}/{field}"] = skill
    if stage == "zhao_carr":
        try:
            p_e = surface_precipitation(data, "emulator")
            p_p = surface_precipitation(data, "physics")
        except KeyError:
            return out
        mse, _, skill = _skill(p_e - p_p, p_p)
        out["mse/surface_precipitation"] = mse
        out["skill/surface_precipitation"] = skill
    return out


def compute_drift(
    data: Dataset,
    dt_seconds: float,
    variables: Sequence[str] = DRIFT_VARIABLES,
    horizons_hours: Sequence[float] = DRIFT_HOURS,
    area=None,
) -> Mapping[str, float]:
    """Global-mean drift per day of prognostic fields at several time
    horizons (reference single_run.py drift metrics): the mean change
    from the initial time to each horizon, per day."""
    out = {}
    for name in variables:
        if name not in data:
            continue
        arr = _data(data, name)  # [time, ...]
        w = None
        if area is not None:
            w = tensor(area, like=arr).broadcast_to(arr.shape[1:])

        def gmean(x):
            if w is None:
                return float(torch.mean(x))
            return float(torch.sum(x * w) / torch.sum(w))

        t0 = gmean(arr[0])
        for hours in horizons_hours:
            steps = int(round(hours * 3600.0 / dt_seconds))
            if steps < 1 or steps >= arr.shape[0]:
                continue
            days = steps * dt_seconds / 86400.0
            out[f"drift/{name}/{hours:g}h"] = (gmean(arr[steps]) - t0) / days
    return out


def main(argv: Optional[list] = None) -> int:
    """CLI: metrics JSON for a piggy-backed run's diagnostics zarr
    (reference: python -m fv3net.diagnostics.prognostic_run.emulation
    single_run surface)."""
    from fv3net_torch.core.zarrio import open_zarr
    from fv3net_torch.diagnostics.transform import on_device
    from fv3net_torch.pipelines import resolve_device

    p = argparse.ArgumentParser("emulation-diags")
    p.add_argument("diags_zarr", help="zarr with piggy-backed tendencies")
    p.add_argument("--state-zarr", default=None, help="state zarr for drift")
    p.add_argument("--dt-seconds", type=float, default=900.0)
    p.add_argument("--output", default=None, help="write metrics JSON here")
    p.add_argument("--device", default="cuda",
                   help="device of the reductions (default cuda)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    data = on_device(open_zarr(args.diags_zarr), device)
    metrics = dict(emulation_skill(data))
    metrics.update(emulation_skill(data, stage="gscond"))
    if args.state_zarr:
        state = on_device(open_zarr(args.state_zarr), device)
        metrics.update(compute_drift(state, args.dt_seconds))
    payload = json.dumps(metrics)
    if args.output:
        with open(args.output, "w") as f:
            f.write(payload)
    print(payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
