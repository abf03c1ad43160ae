"""Convert a run directory's per-tile diagnostic netCDFs to zarr stores (a
copy of ``fv3net_tpu/pipelines/diagnostics_to_zarr.py``; reference:
workflows/dataflow/fv3net/pipelines/diagnostics_to_zarr.py), host code
over the port's ``netcdfio`` and ``zarrio``.

    python -m fv3net_torch.pipelines.diagnostics_to_zarr --rundir DIR

Each category ``{category}.tile{1..6}.nc`` becomes ``{category}.zarr``
with its tiles along a leading 'tile' dimension; the categories fan out
through the runner, and the command exits non-zero when any failed.
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
from typing import List, Optional, Sequence

from fv3net_torch.core import netcdfio, zarrio
from fv3net_torch.pipelines import runner

logger = logging.getLogger(__name__)

COMMON_SUFFIX = ".tile1.nc"
TIME_CHUNK = 192  # reference INITIAL_CHUNKS = {"time": 192}


def get_all_diagnostic_categories(rundir: str) -> List[str]:
    """Category names: every ``*.tile1.nc`` basename minus the suffix
    (reference _get_all_diagnostic_categories)."""
    paths = sorted(glob.glob(os.path.join(rundir, f"*{COMMON_SUFFIX}")))
    return [
        os.path.basename(p)[: -len(COMMON_SUFFIX)] for p in paths
    ]


def open_convert_save(
    category: str, rundir: str, diagnostic_dir: str
) -> str:
    """One category: stack tiles, write ``{category}.zarr``, consolidate
    (reference open_convert_save; the tile axis is a leading dim here
    rather than an append_dim — one write instead of six appends)."""
    ds = netcdfio.open_tiles(os.path.join(rundir, category))
    out = os.path.join(diagnostic_dir, f"{category}.zarr")
    chunks = {"time": TIME_CHUNK, "tile": 1}
    zarrio.to_zarr(ds, out, chunks=chunks)
    zarrio.consolidate_metadata(out)
    return out


def diagnostics_to_zarr(
    rundir: str,
    diagnostic_dir: Optional[str] = None,
    diagnostic_categories: Optional[Sequence[str]] = None,
    max_workers: int = 4,
) -> List[runner.ItemResult]:
    """Convert every (or the named) diagnostic categories; returns the
    per-category results with dead-letter accounting."""
    diagnostic_dir = diagnostic_dir or rundir
    categories = (
        list(diagnostic_categories)
        if diagnostic_categories
        else get_all_diagnostic_categories(rundir)
    )
    logger.info(
        "diagnostic zarrs for %s being written to %s",
        categories, diagnostic_dir,
    )
    return runner.run_pipeline(
        categories,
        lambda c: open_convert_save(c, rundir, diagnostic_dir),
        max_workers=max_workers,
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert per-tile diagnostic netCDFs to zarr stores"
    )
    parser.add_argument("--rundir", required=True, help="run directory")
    parser.add_argument(
        "--diagnostic-dir", default=None,
        help="output location (defaults to rundir)",
    )
    parser.add_argument(
        "--diagnostic-categories", nargs="+", default=None,
        help="category names (filename part before .tile*.nc); "
        "defaults to all categories found in rundir",
    )
    args = parser.parse_args(argv)
    results = diagnostics_to_zarr(
        args.rundir, args.diagnostic_dir, args.diagnostic_categories
    )
    summary = runner.summarize(results)
    logger.info("%s", summary)
    return 0 if summary["n_failed"] == 0 else 1


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    raise SystemExit(main())
