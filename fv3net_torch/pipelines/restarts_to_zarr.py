"""Collect per-segment restarts into one time-indexed zarr (a copy of
``fv3net_tpu/pipelines/restarts_to_zarr.py``; reference:
workflows/dataflow/fv3net/pipelines/restarts_to_zarr), host code over the
port's ``checkpoint.load_state``, which gives CPU tensors.

    python -m fv3net_torch.pipelines.restarts_to_zarr RUN_URL OUT.zarr
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from fv3net_torch.core import zarrio
from fv3net_torch.core.convenience import parse_timestep_str_from_path
from fv3net_torch.runtime.checkpoint import load_state


def restarts_to_zarr(
    run_url: str, output_zarr: str,
    variables: Optional[Sequence[str]] = None,
) -> List[str]:
    """Assemble all segments' RESTART states under ``run_url`` into one
    zarr with a leading time dimension; returns the timestep labels."""
    artifacts = os.path.join(run_url, "artifacts")
    segments = sorted(os.listdir(artifacts))
    labels = []
    group = None
    for t_index, seg in enumerate(segments):
        restart = os.path.join(artifacts, seg, "RESTART")
        if not os.path.isdir(restart):
            continue
        state, time = load_state(restart)
        labels.append(parse_timestep_str_from_path(seg))
        fields = {
            "air_temperature_theta_v": np.asarray(state.dycore.pt),
            "pressure_thickness_of_atmospheric_layer": np.asarray(
                state.dycore.delp
            ),
        }
        for k, v in state.dycore.tracers.items():
            fields[k] = np.asarray(v)
        for c, name in enumerate(("wind_x", "wind_y", "wind_z")):
            fields[name] = np.asarray(state.dycore.wind[c])
        if variables is not None:
            fields = {k: v for k, v in fields.items() if k in variables}
        if group is None:
            group = zarrio.ZarrGroup.create(output_zarr)
            for name, arr in fields.items():
                dims = ("time", "tile", "z", "y", "x")[: arr.ndim + 1]
                group.create_array(
                    name,
                    shape=(0,) + arr.shape,
                    chunks=(1,) + arr.shape,
                    dtype="<f4",
                    dims=dims,
                )
        for name, arr in fields.items():
            za = group[name]
            za.resize_time(len(labels))
            za[(len(labels) - 1,)] = arr.astype(np.float32)
    return labels


def main(argv=None) -> int:
    """python -m fv3net_torch.pipelines.restarts_to_zarr (reference:
    python -m fv3net.pipelines.restarts_to_zarr)."""
    import argparse
    import json

    p = argparse.ArgumentParser(prog="restarts_to_zarr")
    p.add_argument("run_url")
    p.add_argument("output_zarr")
    p.add_argument("--variables", nargs="*", default=None)
    args = p.parse_args(argv)
    labels = restarts_to_zarr(args.run_url, args.output_zarr, args.variables)
    print(json.dumps({"timesteps": labels, "output": args.output_zarr}))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
