"""RRTMG lookup-table netCDF IO in the reference's file layout (a copy
of ``fv3net_tpu/physics/radiation/rrtmg/io.py``, which is numpy-only;
the port keeps its own copy so that importing it loads no JAX).

The reference loads its k-distributions, Planck/solar/cloud-optics data
and McICA random-number inputs from a directory of netCDF files
(``totplnk.nc``, ``radlw_ref_data.nc``, ``radlw_cldprlw_data.nc``,
``radlw_kgb01..16_data.nc``; ``radsw_sflux_data.nc``,
``radsw_ref_data.nc``, ``radsw_cldprtb_data.nc``,
``radsw_kgb16..29_data.nc``; ``rand2d_tile*_{lw,sw}.nc``).  This module
reads and writes that layout with classic NetCDF-3 (scipy's reader and
writer), dtypes preserved, so ``RRTMGDriver(lw_tables=load_lw(dir),
sw_tables=load_sw(dir))`` runs on the tables of a directory, and the
synthetic tables (:mod:`.tables`) can be written out.  Files written by
either package are read by the other.

Load returns the nested dict the solvers take: top-level arrays plus
per-band ``radlw_kgbNN`` / ``radsw_kgbNN`` sub-dicts.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np

# top-level key -> file grouping, mirroring reference io.py
_LW_FILE_KEYS = {
    "totplnk.nc": ("totplnk",),
    "radlw_ref_data.nc": ("preflog", "tref", "chi_mls"),
    "radlw_cldprlw_data.nc": (
        "absliq1", "absice0", "absice1", "absice2", "absice3",
    ),
}
_SW_FILE_KEYS = {
    "radsw_sflux_data.nc": (
        "strrat", "specwt", "layreffr", "ix1", "ix2", "ibx",
        "sfluxref01", "sfluxref02", "sfluxref03", "scalekur",
    ),
    "radsw_ref_data.nc": ("preflog", "tref"),
    "radsw_cldprtb_data.nc": (
        "extliq1", "extliq2", "ssaliq1", "ssaliq2", "asyliq1", "asyliq2",
        "extice2", "ssaice2", "asyice2", "extice3", "ssaice3", "asyice3",
        "abari", "bbari", "cbari", "dbari", "ebari", "fbari",
        "b0s", "b1s", "b0r", "c0s", "c0r", "a0r", "a1r", "a0s", "a1s",
    ),
}
_N_LW_BANDS = 16
_SW_BAND_IDS = range(16, 30)  # reference band file numbering 16..29


def _write_vars(path: str, varmap: Mapping[str, np.ndarray]) -> None:
    """One classic-NetCDF file of plain arrays; per-variable dimension
    names (the reference files' dim names are not load-bearing — its
    io.py reads ``.values`` only), dtypes preserved."""
    from scipy.io import netcdf_file

    with netcdf_file(path, "w") as f:
        for name, arr in varmap.items():
            arr = np.asarray(arr)
            if arr.dtype == np.int64:
                arr = arr.astype(np.int32)  # classic NetCDF has no int64
            dims = []
            for i, size in enumerate(arr.shape):
                dname = f"{name}_dim{i}"
                f.createDimension(dname, size)
                dims.append(dname)
            v = f.createVariable(name, arr.dtype, tuple(dims))
            # scipy's Variable.assignValue uses `data[:]`, which numpy
            # rejects on 0-d arrays — ellipsis assignment handles both
            v.data[...] = arr


def _read_vars(path: str) -> Dict[str, np.ndarray]:
    """All variables of one file as {name: ndarray} (0-d stays 0-d)."""
    from scipy.io import netcdf_file

    out: Dict[str, np.ndarray] = {}
    with netcdf_file(path, "r", mmap=False) as f:
        for name, var in f.variables.items():
            arr = np.asarray(var.data)
            # native byte order (scipy returns big-endian views); plain
            # np.array copy — ascontiguousarray would promote 0-d to (1,)
            out[name] = np.array(arr.astype(arr.dtype.newbyteorder("=")))
    return out


def _scalarize(d: Dict[str, np.ndarray]) -> Dict:
    """0-d arrays -> python scalars (the in-memory dicts use plain
    floats for scalar entries like scalekur/a0r)."""
    return {
        k: (v.item() if isinstance(v, np.ndarray) and v.ndim == 0 else v)
        for k, v in d.items()
    }


def dump_lw(lwdict: Mapping, lookup_dir: str) -> None:
    """Write an ``lwdict`` into the reference lookup-directory layout."""
    os.makedirs(lookup_dir, exist_ok=True)
    for fname, keys in _LW_FILE_KEYS.items():
        _write_vars(
            os.path.join(lookup_dir, fname),
            {k: lwdict[k] for k in keys if k in lwdict},
        )
    for b in range(1, _N_LW_BANDS + 1):
        key = f"radlw_kgb{b:02d}"
        _write_vars(
            os.path.join(lookup_dir, f"{key}_data.nc"), lwdict[key]
        )


def dump_sw(swdict: Mapping, lookup_dir: str) -> None:
    """Write an ``swdict`` into the reference lookup-directory layout."""
    os.makedirs(lookup_dir, exist_ok=True)
    for fname, keys in _SW_FILE_KEYS.items():
        _write_vars(
            os.path.join(lookup_dir, fname),
            {k: swdict[k] for k in keys if k in swdict},
        )
    for b in _SW_BAND_IDS:
        key = f"radsw_kgb{b}"
        _write_vars(
            os.path.join(lookup_dir, f"{key}_data.nc"), swdict[key]
        )


def load_lw(lookup_dir: str) -> Dict:
    """Reference io.py::load_lw — the full ``lwdict`` from a lookup
    directory (all variables per file; the reference's hard-coded
    per-band variable lists are exactly each file's contents)."""
    d: Dict = {}
    for fname in _LW_FILE_KEYS:
        d.update(_scalarize(_read_vars(os.path.join(lookup_dir, fname))))
    for b in range(1, _N_LW_BANDS + 1):
        key = f"radlw_kgb{b:02d}"
        d[key] = _read_vars(os.path.join(lookup_dir, f"{key}_data.nc"))
    return d


def load_sw(lookup_dir: str) -> Dict:
    """Reference io.py::load_sw — the full ``swdict``."""
    d: Dict = {}
    for fname in _SW_FILE_KEYS:
        d.update(_scalarize(_read_vars(os.path.join(lookup_dir, fname))))
    for b in _SW_BAND_IDS:
        key = f"radsw_kgb{b}"
        d[key] = _read_vars(os.path.join(lookup_dir, f"{key}_data.nc"))
    return d


def load_random_numbers(lookup_dir: str, tile_number: int) -> Dict:
    """Reference io.py::load_random_numbers — serialized McICA
    subcolumn randoms per tile (``rand2d`` variable)."""
    if tile_number == 0:
        sw_file = os.path.join(lookup_dir, "rand2d_sw.nc")
    else:
        sw_file = os.path.join(lookup_dir, f"rand2d_tile{tile_number}_sw.nc")
    lw_file = os.path.join(lookup_dir, f"rand2d_tile{tile_number}_lw.nc")
    return {
        "sw_rand": _read_vars(sw_file)["rand2d"],
        "lw_rand": _read_vars(lw_file)["rand2d"],
    }


def dump_random_numbers(
    lookup_dir: str, tile_number: int, lw_rand: np.ndarray,
    sw_rand: np.ndarray,
) -> None:
    os.makedirs(lookup_dir, exist_ok=True)
    if tile_number == 0:
        sw_file = os.path.join(lookup_dir, "rand2d_sw.nc")
    else:
        sw_file = os.path.join(lookup_dir, f"rand2d_tile{tile_number}_sw.nc")
    lw_file = os.path.join(lookup_dir, f"rand2d_tile{tile_number}_lw.nc")
    _write_vars(sw_file, {"rand2d": np.asarray(sw_rand)})
    _write_vars(lw_file, {"rand2d": np.asarray(lw_rand)})
