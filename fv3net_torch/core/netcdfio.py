"""Classic NetCDF (restart and tile files) read and written with scipy
(a copy of what the segmented run needs of ``fv3net_tpu/core/netcdfio.py``;
reference: external/vcm/vcm/fv3_restarts.py + xarray_loaders.py).

Reading uses scipy's pure-python NetCDF-3 reader, enough for the
classic-format FV3 restart categories.  Float64 variables are written as
float32, as the reference writes them.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity


def open_netcdf(path: str) -> Dataset:
    """Read one classic NetCDF file into a Dataset of numpy arrays."""
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as f:
        data_vars = {}
        coords = {}
        for name, var in f.variables.items():
            dims = tuple(var.dimensions)
            arr = np.asarray(var.data).copy()
            attrs = {
                k: (v.decode() if isinstance(v, bytes) else v)
                for k, v in var._attributes.items()
            }
            if dims == (name,):
                coords[name] = arr
            else:
                data_vars[name] = Quantity(
                    arr, dims, units=str(attrs.get("units", "")), attrs=attrs
                )
        return Dataset(data_vars, coords=coords)


def open_tiles(prefix: str, n_tiles: int = 6) -> Dataset:
    """Concatenate ``{prefix}.tile{1..6}.nc`` along a new leading 'tile'
    dimension."""
    datasets = []
    for t in range(1, n_tiles + 1):
        path = f"{prefix}.tile{t}.nc"
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        datasets.append(open_netcdf(path))
    out = {}
    for name in datasets[0]:
        arrs = [np.asarray(d[name].data) for d in datasets]
        q0 = datasets[0][name]
        out[name] = Quantity(
            np.stack(arrs), ("tile",) + q0.dims, q0.units, dict(q0.attrs)
        )
    return Dataset(out, coords=dict(datasets[0].coords))


RESTART_CATEGORIES = [
    "fv_core.res",
    "fv_srf_wnd.res",
    "fv_tracer.res",
    "phy_data",
    "sfc_data",
]


def open_restarts(restart_dir: str) -> Dict[str, Dataset]:
    """Open every restart category found in a directory."""
    out = {}
    for category in RESTART_CATEGORIES:
        prefix = os.path.join(restart_dir, category)
        if os.path.exists(f"{prefix}.tile1.nc"):
            out[category] = open_tiles(prefix)
    return out


def write_netcdf(ds: Dataset, path: str) -> None:
    """Write a Dataset as classic NetCDF-3."""
    from scipy.io import netcdf_file

    with netcdf_file(path, "w") as f:
        dim_sizes: Dict[str, int] = {}
        for name, q in ds.items():
            for d, s in zip(q.dims, q.shape):
                if d not in dim_sizes:
                    dim_sizes[d] = s
                    f.createDimension(d, s)
        for name, coord in ds.coords.items():
            arr = np.asarray(coord)
            if name not in dim_sizes:
                f.createDimension(name, len(arr))
            if arr.dtype.kind in ("S", "U"):
                # classic-NetCDF string convention: 2-D char array with a
                # per-coordinate string-length dimension
                chars = arr.astype("S")
                strlen = chars.dtype.itemsize
                f.createDimension(f"{name}_strlen", strlen)
                v = f.createVariable(name, "S1", (name, f"{name}_strlen"))
                v[:] = chars.view("S1").reshape(len(arr), strlen)
            else:
                v = f.createVariable(name, arr.dtype, (name,))
                v[:] = arr
        for name, q in ds.items():
            arr = q.values
            dtype = arr.dtype if arr.dtype != np.float64 else np.dtype("f4")
            v = f.createVariable(name, dtype, q.dims)
            v[:] = arr.astype(dtype)
            if q.units:
                v.units = q.units.encode()
