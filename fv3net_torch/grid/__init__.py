"""Cubed-sphere grid geometry and layout utilities.

Reference: external/vcm/vcm/cubedsphere/{xgcm.py,cross.py,
grid_metadata.py} — the grid factory is ``geometry.make_grid``.
"""
import dataclasses

from fv3net_torch.grid.cross import CROSS_LAYOUT, to_cross  # noqa: F401
from fv3net_torch.grid.geometry import Grid, make_grid  # noqa: F401


@dataclasses.dataclass
class GridMetadata:
    """Dimension/coordinate naming metadata (reference
    vcm/cubedsphere/grid_metadata.py GridMetadataFV3 defaults)."""

    x: str = "x"
    x_interface: str = "x_interface"
    y: str = "y"
    y_interface: str = "y_interface"
    tile: str = "tile"
    lon: str = "lon"
    lat: str = "lat"
    lonb: str = "lonb"
    latb: str = "latb"

    @property
    def dims(self):
        return (self.tile, self.y, self.x)
