"""Subdomain decomposition for reservoir training (port of
``fv3net_tpu/fit/domain.py``; reference:
external/fv3fit/fv3fit/reservoir/domain2.py:22-60 RankXYDivider): split
each tile into an sy-by-sx grid of subdomains with ``overlap`` halo
cells, flatten per-subdomain features and merge predictions back.  The
cross-subdomain and cross-tile overlap comes from the cube halo append.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from fv3net_torch.parallel.halo import halo_append_concat


@dataclasses.dataclass
class CubeXYDivider:
    """Divide [6, ny, nx(, z)] cube fields into overlapping subdomains.

    Attributes:
        subdomain_layout: (sy, sx) subdomains per tile
        overlap: halo cells around each subdomain (cross-tile overlap via
            the cube halo append)
        rank_extent: (ny, nx) tile shape without overlap
    """

    subdomain_layout: Tuple[int, int]
    overlap: int
    rank_extent: Tuple[int, int]

    def __post_init__(self):
        sy, sx = self.subdomain_layout
        ny, nx = self.rank_extent
        if ny % sy or nx % sx:
            raise ValueError(
                f"tile extent {self.rank_extent} not divisible by layout "
                f"{self.subdomain_layout}"
            )
        self._sub_ny = ny // sy
        self._sub_nx = nx // sx

    @property
    def n_subdomains(self) -> int:
        return 6 * self.subdomain_layout[0] * self.subdomain_layout[1]

    @property
    def subdomain_extent(self) -> Tuple[int, int]:
        return (
            self._sub_ny + 2 * self.overlap,
            self._sub_nx + 2 * self.overlap,
        )

    def get_subdomains(self, field: torch.Tensor) -> torch.Tensor:
        """[6, ny, nx(, z)] -> [n_subdomains, sub_ny+2o, sub_nx+2o(, z)].

        ``field`` is the whole cube, so the overlap comes from the
        single-device halo append even while a sharded layout is active
        (its ranks gather the cube first)."""
        o = self.overlap
        has_z = field.ndim == 4
        x = field.movedim(-1, 1) if has_z else field[:, None]
        ext = halo_append_concat(x, o) if o else x  # [6, z|1, ny+2o, nx+2o]
        sy, sx = self.subdomain_layout
        subs = []
        for j in range(sy):
            for i in range(sx):
                y0 = j * self._sub_ny
                x0 = i * self._sub_nx
                subs.append(
                    ext[
                        :,
                        :,
                        y0: y0 + self._sub_ny + 2 * o,
                        x0: x0 + self._sub_nx + 2 * o,
                    ]
                )
        out = torch.cat(subs, dim=0)  # [6*sy*sx, z|1, ...]
        out = out.movedim(1, -1)
        return out if has_z else out[..., 0]

    def flatten_subdomain_features(self, subs: torch.Tensor) -> torch.Tensor:
        """[n_sub, sy, sx(, z)] -> [n_sub, features]."""
        return subs.reshape(subs.shape[0], -1)

    def merge_subdomains(self, subs_interior: torch.Tensor) -> torch.Tensor:
        """Inverse of get_subdomains for *interior-only* (no overlap)
        subdomain fields: [n_sub, sub_ny, sub_nx(, z)] -> [6, ny, nx(, z)]."""
        sy, sx = self.subdomain_layout
        has_z = subs_interior.ndim == 4
        z = subs_interior.shape[-1] if has_z else 1
        # get_subdomains stacks j-major, then i, tile fastest within each
        s = subs_interior.reshape(sy, sx, 6, self._sub_ny, self._sub_nx, z)
        s = s.permute(2, 0, 3, 1, 4, 5)  # [6, sy, ny_s, sx, nx_s, z]
        ny, nx = self.rank_extent
        out = s.reshape(6, ny, nx, z)
        return out if has_z else out[..., 0]
