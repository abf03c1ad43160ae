"""Classic NetCDF (restart and tile files) read and written with scipy
(a copy of ``fv3net_tpu/core/netcdfio.py``;
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


def open_restarts_with_time_coordinates(url: str) -> Dict:
    """Open every restart snapshot under a run directory with its time
    coordinate (reference vcm/fv3_restarts/io.py:41-66).

    Times come from the FV3 timestamp prefixes on RESTART files
    (``YYYYMMDD.HHMMSS.<category>.tile1.nc``); unprefixed files take the
    directory's ``coupler.res`` time when present.  Searches ``url``
    itself plus its INPUT/ and RESTART/ subdirectories (the run-directory
    layout).  Returns ``{datetime: {category: Dataset}}`` sorted by time.
    """
    import glob as _glob
    import re

    from fv3net_torch.core.convenience import parse_datetime_from_str

    def _coupler_time(d):
        path = os.path.join(d, "coupler.res")
        if not os.path.exists(path):
            return None
        from fv3net_torch.runtime.checkpoint import _read_coupler_res

        return _read_coupler_res(path)

    out: Dict = {}
    stamp = re.compile(r"(\d{8}\.\d{6})\.(.+)\.tile1\.nc$")
    for sub in ("", "INPUT", "RESTART"):
        d = os.path.join(url, sub) if sub else url
        if not os.path.isdir(d):
            continue
        # timestamp-prefixed snapshots
        for path in sorted(_glob.glob(os.path.join(d, "*.tile1.nc"))):
            m = stamp.search(os.path.basename(path))
            if not m:
                continue
            ts, category = m.groups()
            if category not in RESTART_CATEGORIES:
                continue
            time = parse_datetime_from_str(ts)
            out.setdefault(time, {})[category] = open_tiles(
                os.path.join(d, f"{ts}.{category}")
            )
        # unprefixed snapshot labeled by the directory's coupler.res
        unprefixed = open_restarts(d)
        if unprefixed:
            time = _coupler_time(d)
            if time is not None:
                for category, ds in unprefixed.items():
                    out.setdefault(time, {}).setdefault(category, ds)
    return dict(sorted(out.items()))


#: Fortran restart axis names -> standard names (reference
#: vcm/fv3_restarts/io.py:69-79 standardize_metadata + vcm._schema_registry).
_STANDARD_DIM_NAMES = {
    "xaxis_1": "x",
    "xaxis_2": "x_interface",
    "yaxis_1": "y_interface",
    "yaxis_2": "y",
    "zaxis_1": "z",
    "zaxis_2": "z_interface",
    "nz": "z",
    "grid_xt": "x",
    "grid_yt": "y",
    "grid_x": "x_interface",
    "grid_y": "y_interface",
    "pfull": "z",
    "phalf": "z_interface",
}


def standardize_metadata(ds: Dataset) -> Dataset:
    """Standardize one restart/diag file's metadata: drop the singleton
    ``Time`` dimension and rename Fortran axis names to the x/y/z scheme
    (reference vcm/fv3_restarts/io.py:69-79)."""
    out = {}
    for name, q in ds.items():
        dims = q.dims
        arr = q.data
        if "Time" in dims and q.sizes["Time"] == 1:
            axis = dims.index("Time")
            arr = np.asarray(arr).take(0, axis=axis)
            dims = dims[:axis] + dims[axis + 1 :]
        dims = tuple(_STANDARD_DIM_NAMES.get(d, d) for d in dims)
        out[name] = Quantity(arr, dims, q.units, dict(q.attrs))
    coords = {
        _STANDARD_DIM_NAMES.get(k, k): v
        for k, v in ds.coords.items()
        if k != "Time"
    }
    return Dataset(out, coords=coords, attrs=dict(ds.attrs))


def dump_nc(ds: Dataset, f) -> None:
    """Serialize a Dataset as classic NetCDF into an open binary
    file-like object (reference vcm/xarray_loaders.py:108-115 — used to
    write netCDFs onto filesystems without seek support)."""
    import shutil
    import tempfile

    with tempfile.TemporaryDirectory() as dirname:
        path = os.path.join(dirname, "tmp.nc")
        write_netcdf(ds, path)
        with open(path, "rb") as tmp:
            shutil.copyfileobj(tmp, f)


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
