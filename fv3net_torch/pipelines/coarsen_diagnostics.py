"""Coarsen diagnostic zarrs, C384 -> C48 and the like (port of
``fv3net_tpu/pipelines/coarsen_diagnostics.py``).

    python -m fv3net_torch.pipelines.coarsen_diagnostics IN.zarr OUT.zarr --factor 8

Every [.., tile, (z,) y, x] variable is coarsened to the training
resolution by area-weighted block averages, one time index at a time, on
``device`` (the card unless the caller asks for the CPU): the fused
kernel K5 there, its plain version on the CPU
(:func:`fv3net_torch.ops.coarsen.weighted_block_average_many`, one launch
for the variables of a weight shape).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from fv3net_torch.core import zarrio
from fv3net_torch.grid.geometry import make_grid
from fv3net_torch.ops.coarsen import weighted_block_average_many


def coarsen_diagnostics(
    input_zarr: str,
    output_zarr: str,
    coarsening_factor: int,
    variables: Optional[Sequence[str]] = None,
    device="cuda",
) -> None:
    """Area-weighted coarsening of every [.., tile, (z,) y, x] variable,
    streamed one time index at a time to bound memory."""
    src = zarrio.open_zarr(input_zarr)
    names = list(variables) if variables else [
        n for n in src if {"y", "x"} <= set(src[n].dims)
    ]
    n_fine = src[names[0]].shape[-1]
    area = torch.as_tensor(make_grid(n_fine).area, dtype=torch.float32,
                           device=device)
    group = None
    n_time = src[names[0]].shape[0] if "time" in src[names[0]].dims else 1
    for t in range(n_time):
        fields = dict.fromkeys(names)
        by_weight = {}  # the variables of a weight shape: one launch
        for name in names:
            q = src[name]
            arr = torch.as_tensor(
                q.values[t] if "time" in q.dims else q.values,
                dtype=torch.float32, device=device,
            )
            by_weight.setdefault(arr.ndim == 3, []).append((name, arr))
        for surface, members in by_weight.items():
            # weights broadcast under the leading (z) axes
            w = area if surface else area[:, None]
            coarse = weighted_block_average_many(
                [arr for _, arr in members], w, coarsening_factor)
            for (name, _), c in zip(members, coarse):
                fields[name] = c.cpu().numpy()
        if group is None:
            group = zarrio.ZarrGroup.create(output_zarr)
            for name, arr in fields.items():
                dims = ("time",) + tuple(src[name].dims[-arr.ndim:])
                group.create_array(
                    name,
                    shape=(0,) + arr.shape,
                    chunks=(1,) + arr.shape,
                    dtype="<f4",
                    dims=dims,
                )
        for name, arr in fields.items():
            za = group[name]
            za.resize_time(t + 1)
            za[(t,)] = arr


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("coarsen-diagnostics")
    parser.add_argument("input_zarr")
    parser.add_argument("output_zarr")
    parser.add_argument("--factor", type=int, default=8)
    parser.add_argument("--variables", nargs="*", default=None)
    parser.add_argument("--device", default="cuda",
                        help="where the averages run (default: the card)")
    args = parser.parse_args(argv)
    coarsen_diagnostics(
        args.input_zarr, args.output_zarr, args.factor, args.variables,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
