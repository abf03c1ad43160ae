"""Coarsen subtile-sharded fine-resolution surface diagnostics (port of
``fv3net_tpu/pipelines/coarsen_surface.py``; reference:
workflows/dataflow/fv3net/pipelines/coarsen_surface_c3072.py).

    python -m fv3net_torch.pipelines.coarsen_surface --input-dir IN \
        --output-dir OUT [--coarsening 8] [--device cpu]

Each (tile, subtile) shard's variables are area-weighted block averages
on ``device`` (K5 on the card), the tiles run through the runner's
thread pool, subtiles are placed by their 1-D x/y coordinate values (the
information ``combine_by_coords`` uses), and one
``{variable}.tile{t}.nc`` per variable is written under ``C{out_res}/``.
The command exits non-zero when any tile failed.
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fv3net_torch.core import netcdfio
from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.ops import coarsen
from fv3net_torch.pipelines import runner
from fv3net_torch.pipelines import resolve_device

logger = logging.getLogger(__name__)

AREA = "area"
_SUBTILE_RE = re.compile(r"\.tile(\d)\.nc(?:\.(\d+))?$")


def _list_shards(
    input_dir: str, prefix: str
) -> Dict[int, List[Tuple[Optional[int], str]]]:
    """{tile: [(subtile or None, path), ...]} for ``{prefix}.tileT.nc``
    or io_layout-sharded ``{prefix}.tileT.nc.SSSS`` files."""
    shards: Dict[int, List[Tuple[Optional[int], str]]] = {}
    for path in sorted(
        glob.glob(os.path.join(input_dir, f"{prefix}.tile*.nc*"))
    ):
        m = _SUBTILE_RE.search(path)
        if not m:
            continue
        tile = int(m.group(1))
        sub = int(m.group(2)) if m.group(2) is not None else None
        shards.setdefault(tile, []).append((sub, path))
    return shards


def _xy_dims(q: Quantity) -> Optional[Tuple[str, str]]:
    """(y_dim, x_dim) when the trailing dims look spatial."""
    if q.data.ndim < 2:
        return None
    return q.dims[-2], q.dims[-1]


def _native(a):
    """NetCDF-3 data comes big-endian from scipy's reader, and torch takes
    only the native byte order."""
    a = np.asarray(a)
    return a.astype(a.dtype.newbyteorder("="))


def coarsen_shard(
    data_path: str, grid_path: str, factor: int, device="cuda"
) -> Dataset:
    """Area-weighted block-average every 2-D+ variable of one shard on
    ``device``; 1-D x/y coordinates are block-averaged so subtile
    placement (and combine_by_coords equivalence) is preserved."""
    ds = netcdfio.open_netcdf(data_path)
    area = torch.as_tensor(
        _native(netcdfio.open_netcdf(grid_path)[AREA].data), device=device)
    out_vars = {}
    for name, q in ds.items():
        if _xy_dims(q) is None:
            out_vars[name] = q
            continue
        coarse = coarsen.weighted_block_average(
            torch.as_tensor(_native(q.data), device=device), area, factor
        )
        out_vars[name] = Quantity(
            coarse.cpu().numpy(), q.dims, q.units, dict(q.attrs)
        )
    coords = {}
    for cname, cvals in ds.coords.items():
        arr = np.asarray(cvals)
        if arr.ndim == 1 and arr.shape[0] % factor == 0 and any(
            _xy_dims(q) is not None and cname in _xy_dims(q)
            for q in ds.values()
        ):
            coords[cname] = arr.reshape(-1, factor).mean(axis=1)
        else:
            coords[cname] = arr
    return Dataset(out_vars, coords=coords, attrs=dict(ds.attrs))


def combine_subtiles(parts: Sequence[Dataset]) -> Dataset:
    """Stitch coarsened subtiles into one tile by their 1-D x/y
    coordinate values (the combine_by_coords role)."""
    if len(parts) == 1:
        return parts[0]
    sample = next(
        q for q in parts[0].values() if _xy_dims(q) is not None
    )
    ydim, xdim = _xy_dims(sample)
    x0 = sorted({float(p.coords[xdim][0]) for p in parts})
    y0 = sorted({float(p.coords[ydim][0]) for p in parts})
    grid: Dict[Tuple[int, int], Dataset] = {}
    for p in parts:
        iy = y0.index(float(p.coords[ydim][0]))
        ix = x0.index(float(p.coords[xdim][0]))
        grid[(iy, ix)] = p
    ny, nx = len(y0), len(x0)
    if len(grid) != ny * nx:
        raise ValueError(
            f"subtiles do not form a full {ny}x{nx} grid"
        )
    out_vars = {}
    for name, q0 in parts[0].items():
        if _xy_dims(q0) is None:
            out_vars[name] = q0
            continue
        rows = [
            np.concatenate(
                [np.asarray(grid[(iy, ix)][name].data) for ix in range(nx)],
                axis=-1,
            )
            for iy in range(ny)
        ]
        out_vars[name] = Quantity(
            np.concatenate(rows, axis=-2), q0.dims, q0.units,
            dict(q0.attrs),
        )
    coords = dict(parts[0].coords)
    coords[xdim] = np.concatenate(
        [grid[(0, ix)].coords[xdim] for ix in range(nx)]
    )
    coords[ydim] = np.concatenate(
        [grid[(iy, 0)].coords[ydim] for iy in range(ny)]
    )
    return Dataset(out_vars, coords=coords, attrs=dict(parts[0].attrs))


def coarsen_surface(
    input_dir: str,
    output_dir: str,
    prefix_data: str = "gfsphysics_15min_fine",
    prefix_grid_spec: str = "grid_spec",
    coarsening: int = 8,
    max_workers: int = 4,
    device="cuda",
) -> List[runner.ItemResult]:
    """Coarsen every (tile, subtile) shard on ``device``, combine subtiles
    per tile, and write one ``{variable}.tile{t}.nc`` per variable under
    ``{output_dir}/C{out_res}`` (the reference's output layout)."""
    device = resolve_device(device)
    data_shards = _list_shards(input_dir, prefix_data)
    grid_shards = {
        t: dict(subs) for t, subs in
        _list_shards(input_dir, prefix_grid_spec).items()
    }
    if not data_shards:
        raise FileNotFoundError(
            f"no {prefix_data}.tile*.nc* shards in {input_dir}"
        )

    def one_tile(tile: int) -> str:
        parts = []
        for sub, path in data_shards[tile]:
            gpath = grid_shards[tile][sub]
            parts.append(coarsen_shard(path, gpath, coarsening, device))
        combined = combine_subtiles(parts)
        out_res = combined[next(iter(combined))].data.shape[-1]
        out_subdir = os.path.join(output_dir, f"C{out_res}")
        os.makedirs(out_subdir, exist_ok=True)
        written = []
        for name, q in combined.items():
            single = Dataset(
                {name: q}, coords=dict(combined.coords),
                attrs=dict(combined.attrs),
            )
            dest = os.path.join(out_subdir, f"{name}.tile{tile}.nc")
            with open(dest, "wb") as f:
                netcdfio.dump_nc(single, f)
            written.append(dest)
        return out_subdir

    return runner.run_pipeline(
        sorted(data_shards), one_tile, max_workers=max_workers
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Coarsen subtile-sharded surface diagnostics"
    )
    parser.add_argument("--input-dir", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument(
        "--prefix-data", default="gfsphysics_15min_fine"
    )
    parser.add_argument("--prefix-grid-spec", default="grid_spec")
    parser.add_argument("--coarsening", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="where the averages run (default: the card)")
    args = parser.parse_args(argv)
    results = coarsen_surface(
        args.input_dir, args.output_dir, args.prefix_data,
        args.prefix_grid_spec, args.coarsening, device=args.device,
    )
    summary = runner.summarize(results)
    logger.info("%s", summary)
    return 0 if summary["n_failed"] == 0 else 1


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    raise SystemExit(main())
