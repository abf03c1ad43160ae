"""post-process-run-torch: combine a run's segments into per-name stores
(port of ``fv3net_tpu/post_process_cli.py``; reference:
workflows/post_process_run/setup.py, the ``post-process-run`` console
script).

    post-process-run-torch RUNDIR DEST [--names ...] [--latlon]
        [--device cpu]

``--latlon`` also regrids each written store to 180 x 360 lat-lon
(``{store}.latlon.zarr`` beside it; the reference's post-processing ran
the fregrid binary for this) on ``--device``, the card by default.
"""
from __future__ import annotations

import argparse
import json
import sys

from fv3net_torch.post_process import post_process, regrid_zarr_to_latlon


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="post-process-run-torch")
    p.add_argument("rundir")
    p.add_argument("destination")
    p.add_argument("--names", nargs="*", default=None)
    p.add_argument("--latlon", action="store_true",
                   help="also regrid each written store to lat-lon")
    p.add_argument("--device", default="cuda",
                   help="where the lat-lon regrid runs (default: the card)")
    args = p.parse_args(argv)
    if args.latlon:
        from fv3net_torch.pipelines import resolve_device

        device = resolve_device(args.device)
    written = post_process(args.rundir, args.destination, names=args.names)
    result = {"written": written}
    if args.latlon:
        result["latlon"] = []
        for store in written:
            dest = store[: -len(".zarr")] + ".latlon.zarr"
            regrid_zarr_to_latlon(store, dest, device=device)
            result["latlon"].append(dest)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
