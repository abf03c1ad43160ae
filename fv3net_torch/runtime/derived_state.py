"""Named-variable view over the model state (port of
``fv3net_tpu/runtime/derived_state.py``; reference:
workflows/prognostic_c48_run/runtime/derived_state.py:83-160).

Dict-like access to physical variables by the reference's names, computed
from the dycore state (which stores theta_v and Cartesian winds), and
setters that write back consistently.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from fv3net_torch.core.constants import TOA_PRESSURE
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.dycore.state import (
    DycoreState,
    temperature_from_theta_v,
    theta_v_from_temperature,
)
from fv3net_torch.ops import thermo
from fv3net_torch.runtime import names


@dataclasses.dataclass
class ModelState:
    """Full prognostic state: dycore fields and surface fields."""

    dycore: DycoreState
    surface: Dict[str, torch.Tensor]  # [6, ny, nx] fields by reference names

    def copy(self) -> "ModelState":
        return ModelState(dycore=self.dycore, surface=dict(self.surface))


DIMS_3D = ("tile", "z", "y", "x")
DIMS_2D = ("tile", "y", "x")


class DerivedState:
    """Named access over a :class:`ModelState`.

    get: ``state[name]`` -> Quantity; set: ``state[name] = Quantity``
    updates the underlying prognostic fields consistently (the reference's
    ``set_state_mass_conserving``).
    """

    def __init__(self, state: ModelState, grid_arrays,
                 ptop: float = TOA_PRESSURE):
        self.state = state
        self._g = grid_arrays
        self._ptop = ptop

    # -- helpers ----------------------------------------------------------
    def _pmid(self):
        delp = self.state.dycore.delp.movedim(1, -1)
        pm = thermo.pressure_at_midpoint_log(delp, toa_pressure=self._ptop)
        return pm.movedim(-1, 1)

    def _temperature(self):
        d = self.state.dycore
        return temperature_from_theta_v(d.pt, self._pmid(),
                                        d.tracers["sphum"])

    def _east_north(self):
        """Unit east/north at centers, [3, 6, ny, nx]."""
        return self._g.east, self._g.north

    # -- mapping interface ------------------------------------------------
    def keys(self):
        base = [
            names.TEMP,
            names.SPHUM,
            names.CLOUD,
            names.DELP,
            names.EASTWARD_WIND,
            names.NORTHWARD_WIND,
            names.AREA,
            "surface_geopotential",
            "surface_pressure",
            "latitude",
            "longitude",
        ]
        return base + list(self.state.surface)

    def __contains__(self, key) -> bool:
        return key in self.keys()

    def __getitem__(self, key: str) -> Quantity:
        d = self.state.dycore
        if key == names.TEMP:
            return Quantity(self._temperature(), DIMS_3D, "degK")
        if key == names.SPHUM:
            return Quantity(d.tracers["sphum"], DIMS_3D, "kg/kg")
        if key == names.CLOUD:
            return Quantity(d.tracers["cloud_water"], DIMS_3D, "kg/kg")
        if key == names.DELP:
            return Quantity(d.delp, DIMS_3D, "Pa")
        if key == names.EASTWARD_WIND:
            east, _ = self._east_north()
            return Quantity((d.wind * east[:, :, None]).sum(dim=0), DIMS_3D,
                            "m/s")
        if key == names.NORTHWARD_WIND:
            _, north = self._east_north()
            return Quantity((d.wind * north[:, :, None]).sum(dim=0),
                            DIMS_3D, "m/s")
        if key == names.AREA:
            return Quantity(self._g.area, DIMS_2D, "m^2")
        if key == "surface_geopotential":
            return Quantity(d.phis, DIMS_2D, "m^2/s^2")
        if key == "surface_pressure":
            return Quantity(d.delp.sum(dim=1) + self._ptop, DIMS_2D, "Pa")
        if key == "latitude":
            return Quantity(self._g.lat, DIMS_2D, "radians")
        if key == "longitude":
            return Quantity(self._g.lon, DIMS_2D, "radians")
        if key == "ozone_mixing_ratio" and "o3mr" in d.tracers:
            return Quantity(d.tracers["o3mr"], DIMS_3D, "kg/kg")
        if key in d.tracers:
            return Quantity(d.tracers[key], DIMS_3D, "kg/kg")
        if key in self.state.surface:
            return Quantity(self.state.surface[key], DIMS_2D)
        raise KeyError(key)

    def _replace(self, **changes):
        self.state.dycore = dataclasses.replace(self.state.dycore, **changes)

    def _set_tracer(self, name, data):
        tracers = dict(self.state.dycore.tracers)
        tracers[name] = data
        self._replace(tracers=tracers)

    def __setitem__(self, key: str, value: Quantity):
        data = value.data if isinstance(value, Quantity) else value
        d = self.state.dycore
        # incoming data must not widen the prognostic state's dtype
        if torch.is_tensor(data):
            data = data.to(d.pt.dtype)
        else:
            data = torch.as_tensor(np.asarray(data), dtype=d.pt.dtype,
                                   device=d.pt.device)
        if key == names.TEMP:
            self._replace(pt=theta_v_from_temperature(
                data, self._pmid(), d.tracers["sphum"]))
        elif key == names.SPHUM:
            # the set_state_mass_conserving semantics: overwriting the
            # specific humidity changes the layer's water mass, so delp is
            # rescaled to keep the DRY air mass per layer exact
            # (delp * (1 - q) invariant).  Temperature is held fixed
            # (theta_v recomputed at the new pmid and q).
            T = self._temperature()
            q_old = d.tracers["sphum"]
            tracers = dict(d.tracers)
            tracers["sphum"] = data
            self._replace(delp=d.delp * (1.0 - q_old) / (1.0 - data),
                          tracers=tracers)
            self._replace(pt=theta_v_from_temperature(T, self._pmid(), data))
        elif key == names.CLOUD:
            self._set_tracer("cloud_water", data)
        elif key == "ozone_mixing_ratio" and "o3mr" in d.tracers:
            self._set_tracer("o3mr", data)
        elif key in d.tracers:
            self._set_tracer(key, data)
        elif key == names.EASTWARD_WIND or key == names.NORTHWARD_WIND:
            east, north = self._east_north()
            basis = east if key == names.EASTWARD_WIND else north
            cur = (d.wind * basis[:, :, None]).sum(dim=0)
            self._replace(wind=d.wind + (data - cur)[None] * basis[:, :, None])
        elif key in self.state.surface or data.ndim == 3:
            self.state.surface[key] = data
        else:
            raise KeyError(f"cannot set {key!r}")
