"""Equiangular gnomonic cubed-sphere grid geometry.

A numpy-only copy of ``fv3net_tpu/grid/geometry.py``: importing any
``fv3net_tpu`` module loads jax, so the port carries its own copy.  Keep
the two identical; ``tests/test_torch_dycore.py`` compares them.

The reference gets its grid from the Fortran model / pre-computed GCS
catalogs (reference: external/vcm/vcm/catalog.yaml `grid/c48`,
external/vcm/vcm/cubedsphere/xgcm.py:94).  Here the grid is generated
directly: 6 gnomonic faces, cell corners/centers embedded in R^3, with
areas, edge lengths, edge normals/tangents and local east/north bases all
derived numerically from the embedding.  The finite-volume dycore needs
only these integral quantities (areas + edge geometry) — no metric-tensor
or Christoffel bookkeeping — and stores horizontal wind as a 3-D Cartesian
tangent vector so halo exchange requires no component rotation anywhere,
including the 12 cube edges and 8 corners.

Tile layout (this framework's convention; a permutation maps to FV3's):
    tiles 0..3: equatorial, centered at lon 0, 90, 180, 270 deg
    tile 4: north polar cap; tile 5: south polar cap
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from fv3net_torch.core.constants import EARTH_RADIUS, EARTH_ROTATION_RATE

NUM_TILES = 6


def _face_xyz(tile: int, X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """Map gnomonic plane coords (X=tan(xi), Y=tan(eta)) to unit sphere."""
    one = np.ones_like(X)
    if tile == 0:
        v = np.stack([one, X, Y], axis=-1)
    elif tile == 1:
        v = np.stack([-X, one, Y], axis=-1)
    elif tile == 2:
        v = np.stack([-one, -X, Y], axis=-1)
    elif tile == 3:
        v = np.stack([X, -one, Y], axis=-1)
    elif tile == 4:
        v = np.stack([-Y, X, one], axis=-1)
    elif tile == 5:
        v = np.stack([Y, X, -one], axis=-1)
    else:
        raise ValueError(tile)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _great_circle_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Angle between unit vectors (robust for small angles)."""
    cross = np.linalg.norm(np.cross(a, b), axis=-1)
    dot = np.sum(a * b, axis=-1)
    return np.arctan2(cross, dot)


def _spherical_triangle_area(a, b, c) -> np.ndarray:
    """Solid angle of spherical triangle via L'Huilier's theorem."""
    ta = _great_circle_distance(b, c)
    tb = _great_circle_distance(c, a)
    tc = _great_circle_distance(a, b)
    s = 0.5 * (ta + tb + tc)
    arg = (
        np.tan(0.5 * s)
        * np.tan(0.5 * (s - ta))
        * np.tan(0.5 * (s - tb))
        * np.tan(0.5 * (s - tc))
    )
    return 4.0 * np.arctan(np.sqrt(np.maximum(arg, 0.0)))


@dataclasses.dataclass
class EdgeMatch:
    """One side of a tile matched to a side of a neighboring tile.

    ``edge`` indices: 0=west (i=0), 1=east (i=n), 2=south (j=0), 3=north (j=n).
    ``reversed`` means the corner node order along the shared edge is
    opposite between the two tiles.
    """

    tile: int
    edge: int
    neighbor_tile: int
    neighbor_edge: int
    reversed: bool


def _edge_nodes(corners_xyz: np.ndarray, tile: int, edge: int) -> np.ndarray:
    """Corner nodes along a tile edge, ordered by the running index."""
    if edge == 0:
        return corners_xyz[tile, :, 0]
    if edge == 1:
        return corners_xyz[tile, :, -1]
    if edge == 2:
        return corners_xyz[tile, 0, :]
    if edge == 3:
        return corners_xyz[tile, -1, :]
    raise ValueError(edge)


def derive_topology(corners_xyz: np.ndarray) -> Dict[Tuple[int, int], EdgeMatch]:
    """Derive the cube edge-connectivity by geometric corner matching.

    This replaces hand-coded neighbor tables (reference: pace.util
    CubedSpherePartitioner): each tile edge's node polyline is matched
    against every other tile's edges; identical node sets (forward or
    reversed) identify the neighbor and its orientation.  Because the same
    table drives both grid metadata and halo exchange, they cannot drift
    apart.
    """
    topology: Dict[Tuple[int, int], EdgeMatch] = {}
    tol = 1e-9
    for t in range(NUM_TILES):
        for e in range(4):
            nodes = _edge_nodes(corners_xyz, t, e)
            found = False
            for t2 in range(NUM_TILES):
                if t2 == t:
                    continue
                for e2 in range(4):
                    nodes2 = _edge_nodes(corners_xyz, t2, e2)
                    if np.allclose(nodes, nodes2, atol=tol):
                        topology[(t, e)] = EdgeMatch(t, e, t2, e2, False)
                        found = True
                    elif np.allclose(nodes, nodes2[::-1], atol=tol):
                        topology[(t, e)] = EdgeMatch(t, e, t2, e2, True)
                        found = True
                    if found:
                        break
                if found:
                    break
            if not found:
                raise RuntimeError(f"no neighbor found for tile {t} edge {e}")
    return topology


@dataclasses.dataclass
class Grid:
    """All static geometry for a C{n} cubed-sphere grid (numpy, float64).

    Shapes use [tile, y, x] index order ("j, i").
    """

    n: int
    radius: float
    # unit-sphere embeddings
    corners_xyz: np.ndarray  # [6, n+1, n+1, 3]
    centers_xyz: np.ndarray  # [6, n, n, 3]
    lon: np.ndarray  # [6, n, n] radians
    lat: np.ndarray  # [6, n, n] radians
    lon_corners: np.ndarray  # [6, n+1, n+1]
    lat_corners: np.ndarray  # [6, n+1, n+1]
    area: np.ndarray  # [6, n, n] m^2
    # edge geometry: x-edges run along x (south/north faces of cells),
    # y-edges run along y (west/east faces).
    edge_len_x: np.ndarray  # [6, n+1, n] m
    edge_len_y: np.ndarray  # [6, n, n+1] m
    normal_x: np.ndarray  # [6, n+1, n, 3] unit normal of x-edges, points +j
    normal_y: np.ndarray  # [6, n, n+1, 3] unit normal of y-edges, points +i
    # local bases at cell centers
    khat: np.ndarray  # [6, n, n, 3] radial unit vector
    east: np.ndarray  # [6, n, n, 3] unit east
    north: np.ndarray  # [6, n, n, 3] unit north
    f_coriolis: np.ndarray  # [6, n, n] 2*Omega*sin(lat)
    topology: Dict[Tuple[int, int], EdgeMatch]

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (NUM_TILES, self.n, self.n)


def make_grid(n: int, radius: float = EARTH_RADIUS) -> Grid:
    """Build a C{n} equiangular gnomonic cubed-sphere grid."""
    # corner parameter values: equiangular
    ang = np.linspace(-np.pi / 4, np.pi / 4, n + 1)
    Xc = np.tan(ang)
    ang_mid = 0.5 * (ang[:-1] + ang[1:])
    Xm = np.tan(ang_mid)

    corners = np.empty((NUM_TILES, n + 1, n + 1, 3))
    centers = np.empty((NUM_TILES, n, n, 3))
    for t in range(NUM_TILES):
        XX, YY = np.meshgrid(Xc, Xc, indexing="xy")  # [j, i] with x along i
        corners[t] = _face_xyz(t, XX, YY)
        XXm, YYm = np.meshgrid(Xm, Xm, indexing="xy")
        centers[t] = _face_xyz(t, XXm, YYm)

    lon_c = np.arctan2(corners[..., 1], corners[..., 0])
    lat_c = np.arcsin(np.clip(corners[..., 2], -1, 1))
    lon = np.arctan2(centers[..., 1], centers[..., 0])
    lat = np.arcsin(np.clip(centers[..., 2], -1, 1))

    # cell areas from two spherical triangles
    p00 = corners[:, :-1, :-1]
    p01 = corners[:, :-1, 1:]
    p11 = corners[:, 1:, 1:]
    p10 = corners[:, 1:, :-1]
    area = (
        _spherical_triangle_area(p00, p01, p11)
        + _spherical_triangle_area(p00, p11, p10)
    ) * radius ** 2

    # edge lengths
    edge_len_x = _great_circle_distance(corners[:, :, :-1], corners[:, :, 1:]) * radius
    edge_len_y = _great_circle_distance(corners[:, :-1, :], corners[:, 1:, :]) * radius

    # edge midpoints, tangents, normals
    def edge_geometry(p1, p2, plus_dir):
        mid = _normalize(p1 + p2)
        tang = p2 - p1
        tang = _normalize(tang - np.sum(tang * mid, axis=-1, keepdims=True) * mid)
        norm = np.cross(mid, tang)  # in tangent plane, perpendicular to edge
        # orient along +j (x-edges) or +i (y-edges)
        sign = np.sign(np.sum(norm * plus_dir, axis=-1, keepdims=True))
        return mid, tang, norm * np.where(sign == 0, 1.0, sign)

    # +j direction estimate at x-edge midpoints: difference of corner rows
    jdir = np.empty_like(corners[:, :, :-1])
    jdir[:, 1:-1] = corners[:, 2:, :-1] - corners[:, :-2, :-1]
    jdir[:, 0] = corners[:, 1, :-1] - corners[:, 0, :-1]
    jdir[:, -1] = corners[:, -1, :-1] - corners[:, -2, :-1]
    _, _, normal_x = edge_geometry(corners[:, :, :-1], corners[:, :, 1:], jdir)

    idir = np.empty_like(corners[:, :-1, :])
    idir[:, :, 1:-1] = corners[:, :-1, 2:] - corners[:, :-1, :-2]
    idir[:, :, 0] = corners[:, :-1, 1] - corners[:, :-1, 0]
    idir[:, :, -1] = corners[:, :-1, -1] - corners[:, :-1, -2]
    _, _, normal_y = edge_geometry(corners[:, :-1, :], corners[:, 1:, :], idir)

    khat = centers  # already unit
    zhat = np.array([0.0, 0.0, 1.0])
    east = _normalize(np.cross(np.broadcast_to(zhat, centers.shape), centers))
    north = np.cross(centers, east)
    f_coriolis = 2.0 * EARTH_ROTATION_RATE * centers[..., 2]

    topology = derive_topology(corners)

    return Grid(
        n=n,
        radius=radius,
        corners_xyz=corners,
        centers_xyz=centers,
        lon=lon,
        lat=lat,
        lon_corners=lon_c,
        lat_corners=lat_c,
        area=area,
        edge_len_x=edge_len_x,
        edge_len_y=edge_len_y,
        normal_x=normal_x,
        normal_y=normal_y,
        khat=khat,
        east=east,
        north=north,
        f_coriolis=f_coriolis,
        topology=topology,
    )
