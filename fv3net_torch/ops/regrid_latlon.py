"""Cubed-sphere -> lat-lon regridding with precomputed weights (port of
``fv3net_tpu/ops/regrid_latlon.py``, which replaces the reference's
``fregrid`` binary: workflows/post_process_run/fv3post/fregrid.py).

First-order conservative remap: each cube cell's area is spread over the
lat-lon boxes holding its ``subsample`` x ``subsample`` sub-cell centres.
The (flat box index, weight) tables are built on the host with numpy, as
the reference builds them; applying them is one scatter-add
(``index_add_``) on the field's device, batched over leading axes.  On
the card the scatter-add is atomic, so a float32 box sum may differ in
its last bits from run to run.
"""
from __future__ import annotations

import numpy as np
import torch

from fv3net_torch.grid.geometry import Grid, _face_xyz


def _containing_cell(lat: np.ndarray, lon: np.ndarray, n: int):
    """Invert the equiangular gnomonic projection: (lat, lon) -> (tile,
    j, i) of the containing C{n} cell.  Follows the face layout of
    fv3net_torch.grid.geometry._face_xyz."""
    lat, lon = np.broadcast_arrays(lat, lon)
    x = np.cos(lat) * np.cos(lon)
    y = np.cos(lat) * np.sin(lon)
    z = np.sin(lat)
    # face-local (X, Y) gnomonic coordinates per face, as in _face_xyz
    faces = [
        (x, y, z),  # tile 0: v = (1, X, Y)/|..| -> X=y/x, Y=z/x, need x>0
        (y, -x, z),  # tile 1: (-X, 1, Y) -> X=-x/y, Y=z/y, need y>0
        (-x, -y, z),  # tile 2: (-1, -X, Y) -> X=-y/(-x)? see below
        (-y, x, z),  # tile 3
        (z, y, -x),  # tile 4: (-Y, X, 1) -> X=y/z, Y=-x/z, need z>0
        (-z, y, x),  # tile 5: (Y, X, -1) -> X=y/(-z), Y=x/(-z), need z<0
    ]
    denom = np.stack([f[0] for f in faces])
    tile = np.argmax(denom, axis=0)
    Xs = np.stack([f[1] / np.maximum(f[0], 1e-12) for f in faces])
    Ys = np.stack([f[2] / np.maximum(f[0], 1e-12) for f in faces])
    ii = np.arange(tile.size)
    X = Xs.reshape(6, -1)[tile.ravel(), ii].reshape(tile.shape)
    Y = Ys.reshape(6, -1)[tile.ravel(), ii].reshape(tile.shape)
    ang = np.linspace(-np.pi / 4, np.pi / 4, n + 1)
    i_idx = np.clip(np.searchsorted(ang, np.arctan(X)) - 1, 0, n - 1)
    j_idx = np.clip(np.searchsorted(ang, np.arctan(Y)) - 1, 0, n - 1)
    return tile, j_idx, i_idx


class CubeToLatLon:
    """Precomputed conservative cube->latlon regridder; its tables live on
    ``device``."""

    def __init__(self, grid: Grid, nlat: int = 180, nlon: int = 360,
                 subsample: int = 2, device="cuda"):
        self.nlat = nlat
        self.nlon = nlon
        n = grid.n
        s = subsample
        # sub-cell centers in the gnomonic parameter plane
        ang = np.linspace(-np.pi / 4, np.pi / 4, n + 1)
        sub = (np.arange(s) + 0.5) / s
        # parameter values of sub-centers within each cell
        a_sub = ang[:-1, None] + np.diff(ang)[:, None] * sub[None, :]
        a_flat = a_sub.reshape(-1)  # [n*s]
        X = np.tan(a_flat)
        lat_idx_all = []
        lon_idx_all = []
        for t in range(6):
            XX, YY = np.meshgrid(X, X, indexing="xy")
            xyz = _face_xyz(t, XX, YY)
            lon = np.mod(np.arctan2(xyz[..., 1], xyz[..., 0]), 2 * np.pi)
            lat = np.arcsin(np.clip(xyz[..., 2], -1, 1))
            lat_idx = np.clip(
                ((lat + np.pi / 2) / np.pi * nlat).astype(np.int64), 0, nlat - 1
            )
            lon_idx = np.clip(
                (lon / (2 * np.pi) * nlon).astype(np.int64), 0, nlon - 1
            )
            lat_idx_all.append(lat_idx)
            lon_idx_all.append(lon_idx)
        lat_idx = np.stack(lat_idx_all)  # [6, n*s, n*s]
        lon_idx = np.stack(lon_idx_all)
        flat_box = lat_idx * nlon + lon_idx
        # weight of each sub-cell = its parent cell's area / s^2
        w = np.repeat(np.repeat(grid.area, s, axis=1), s, axis=2) / (s * s)
        self.device = torch.device(device)
        self._box = torch.as_tensor(flat_box.reshape(-1), device=self.device)
        self._w = torch.as_tensor(w.reshape(-1), device=self.device)
        self._den = torch.zeros(nlat * nlon, dtype=self._w.dtype,
                                device=self.device).index_add_(
            0, self._box, self._w)
        self._s = s
        self._n = n
        self.lat = (np.arange(nlat) + 0.5) / nlat * 180.0 - 90.0
        self.lon = (np.arange(nlon) + 0.5) / nlon * 360.0
        # nearest-cell fallback for boxes no sub-cell lands in (small polar
        # boxes): analytic inverse gnomonic projection of each box center
        t_idx, j_idx, i_idx = _containing_cell(
            np.deg2rad(self.lat)[:, None], np.deg2rad(self.lon)[None, :], n
        )
        self._fb_flat = torch.as_tensor(
            (t_idx * n * n + j_idx * n + i_idx).reshape(-1),
            device=self.device)

    def _box_sums(self, field: torch.Tensor) -> torch.Tensor:
        """sum over sub-cells of field * weight into each flat box:
        (..., 6, n, n) -> (..., nlat * nlon), one scatter-add."""
        s = self._s
        f = field.repeat_interleave(s, dim=-2).repeat_interleave(s, dim=-1)
        lead = field.shape[:-3]
        ff = f.reshape(lead + (-1,))
        num = torch.zeros(lead + (self.nlat * self.nlon,), dtype=ff.dtype,
                          device=ff.device)
        return num.index_add_(-1, self._box, ff * self._w.to(ff.dtype))

    def __call__(self, field: torch.Tensor) -> torch.Tensor:
        """Regrid (..., 6, n, n) -> (..., nlat, nlon).  Boxes covered by
        sub-cells get the conservative area-weighted mean; the remaining
        (small polar) boxes fall back to the value of the cube cell
        containing their center."""
        lead = field.shape[:-3]
        num = self._box_sums(field)
        den = self._den.to(num.dtype)
        mean = num / torch.where(den > 0, den, 1.0)
        fallback = field.reshape(lead + (-1,))[..., self._fb_flat]
        out = torch.where(den > 0, mean, fallback)
        return out.reshape(lead + (self.nlat, self.nlon))

    def sample_points(self, field: torch.Tensor, lat_deg, lon_deg):
        """Nearest-cell sampling of (..., 6, n, n) at arbitrary points (the
        ``vcm.interpolate_unstructured`` nearest-neighbor path) by the
        analytic inverse projection."""
        t, j, i = _containing_cell(
            np.deg2rad(np.asarray(lat_deg)), np.deg2rad(np.asarray(lon_deg)),
            self._n,
        )
        flat = torch.as_tensor((t * self._n * self._n + j * self._n
                                + i).ravel(), device=field.device)
        out = field.reshape(field.shape[:-3] + (-1,))[..., flat]
        return out.reshape(field.shape[:-3] + np.shape(lat_deg))

    def conservative_sum(self, field: torch.Tensor) -> torch.Tensor:
        """Area-weighted integral on the target grid: sums to
        sum(field * area)."""
        lead = field.shape[:-3]
        return self._box_sums(field).reshape(lead + (self.nlat, self.nlon))


def interpolate_unstructured(field, source_coords, target_coords):
    """Nearest-neighbor interpolation between unstructured coordinate sets
    (reference external/vcm/vcm/interpolate.py:251-298, a KDTree there):
    one pairwise-distance product and an argmin.

    Args:
        field: ``[..., *spatial]`` data.
        source_coords: sequence of arrays, each shaped like the spatial
            axes of ``field`` (e.g. ``(lat, lon)``).
        target_coords: sequence (same length) of arrays with a common
            shape giving the query points.

    Returns:
        ``[..., *target_shape]`` nearest-source values.
    """
    src = torch.stack([torch.as_tensor(np.ravel(np.asarray(c)),
                                       device=field.device)
                       for c in source_coords], dim=-1)
    tgt = torch.stack([torch.as_tensor(np.ravel(np.asarray(c)),
                                       device=field.device)
                       for c in target_coords], dim=-1)
    # ||s - t||^2 = |s|^2 - 2 s.t + |t|^2 ; |t|^2 is constant over the argmin
    d2 = (src * src).sum(-1)[:, None] - 2.0 * (src @ tgt.T)
    idx = torch.argmin(d2, dim=0)
    src_ndim = np.ndim(np.asarray(source_coords[0]))
    lead = field.shape[: field.ndim - src_ndim]
    out = field.reshape(lead + (-1,))[..., idx]
    return out.reshape(lead + np.shape(np.asarray(target_coords[0])))
