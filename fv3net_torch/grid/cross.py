"""Cross-layout assembly of cubed-sphere tiles.

Reference semantics: external/vcm/vcm/cubedsphere/cross.py (``to_cross``
lays the 6 tiles into a 4x3 cross for quick-look plotting).  Under this
framework's face convention (grid/geometry.py::_face_xyz — equatorial
ring 0-3 in order, tile 4 = north over tile 0, tile 5 = south under
tile 0), all six placements are rotation-free, so the assembly is pure
block placement:

::

    [4][ ][ ][ ]
    [0][1][2][3]
    [5][ ][ ][ ]

with j increasing upward in the output.
"""
from __future__ import annotations

import numpy as np

__all__ = ["to_cross", "CROSS_LAYOUT"]

#: tile -> (row, col) of its block in the 3x4 cross (row 0 = bottom)
CROSS_LAYOUT = {
    5: (0, 0),
    0: (1, 0),
    1: (1, 1),
    2: (1, 2),
    3: (1, 3),
    4: (2, 0),
}


def to_cross(field, fill=np.nan):
    """Assemble ``[..., 6, ny, nx]`` into ``[..., 3*ny, 4*nx]``.

    Empty blocks are filled with ``fill``.  Edge continuity between
    placed neighbors is exact for this framework's tile convention
    (verified in tests against grid longitude/latitude fields).
    """
    field = np.asarray(field)
    if field.shape[-3] != 6:
        raise ValueError(f"expected 6 tiles on axis -3, got {field.shape}")
    ny, nx = field.shape[-2:]
    lead = field.shape[:-3]
    dtype = field.dtype
    if not np.issubdtype(dtype, np.floating) and (
        isinstance(fill, float) and not np.isfinite(fill)
    ):
        # a NaN/inf fill cannot live in an integer field: promote so the
        # empty blocks stay distinguishable from data
        dtype = np.result_type(dtype, np.float32)
    out = np.full(lead + (3 * ny, 4 * nx), fill, dtype=dtype)
    for tile, (row, col) in CROSS_LAYOUT.items():
        out[
            ..., row * ny : (row + 1) * ny, col * nx : (col + 1) * nx
        ] = field[..., tile, :, :]
    return out
