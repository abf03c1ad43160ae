"""The reference's radiation driver API over the port's schemes (port of
``fv3net_tpu/physics/radiation/wrapper.py``; reference:
external/radiation/radiation/wrapper_api.py:119-349)."""
from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, Optional

import torch

from fv3net_torch.ops import zenith
from fv3net_torch.physics import radiation_gray as gray
from fv3net_torch.physics.radiation.driver import DriverConfig, RadiationDriver


@dataclasses.dataclass
class RadiationConfig:
    """Schemes: ``gray`` (Frierson gray gas), ``rrtmg`` (the RRTMG band
    solvers, rrtmg/) and ``synthband`` (the synthetic band model,
    driver.py)."""

    scheme: str = "gray"  # gray | rrtmg | synthband
    gray: gray.GrayRadiationParams = gray.GrayRadiationParams()
    # RRTMG namelist-style options (driver.DriverConfig meanings)
    iovr_lw: int = 1
    iovr_sw: int = 1
    isol: int = 0
    ico2: int = 0
    iaer: int = 1
    icld: int = 1
    # a directory of k-table netCDFs in the reference's layout, read by
    # rrtmg/io.py; None takes the synthetic documented-shape tables
    lookup_dir: Optional[str] = None
    # rrtmg column blocking: None or 0 off, > 0 the block size (the
    # reference's None picks blocks by backend; the port's runs unblocked)
    column_block: Optional[int] = None


class Radiation:
    """validate() / init_driver() / __call__(time, state).  The band
    drivers live on ``device``; the RRTMG driver computes in ``dtype``
    (float32 by default, as the reference's), the synthband driver in
    float32 (the reference's fixed dtype).  ``impl`` picks the RRTMG
    k-table selections' version (None: the CUDA kernels on a CUDA
    device)."""

    def __init__(self, config: RadiationConfig, timestep: float,
                 dtype=torch.float32, device="cuda", impl: str = None):
        self.config = config
        self.timestep = timestep
        self.dtype = dtype
        self.device = device
        self.impl = impl
        self._initialized = False
        self._driver = None

    def validate(self) -> None:
        if self.config.scheme not in ("gray", "rrtmg", "synthband"):
            raise ValueError(f"unknown radiation scheme {self.config.scheme}")

    def init_driver(self) -> None:
        """Builds the band data once (the reference downloads its lookup
        tables here; ``lookup_dir`` is a local directory)."""
        self.validate()
        if self.config.scheme == "rrtmg":
            from fv3net_torch.physics.radiation.rrtmg.driver import (
                RRTMGConfig,
                RRTMGDriver,
            )

            lw_tables = sw_tables = None
            if self.config.lookup_dir is not None:
                from fv3net_torch.physics.radiation.rrtmg import io as rio

                lw_tables = rio.load_lw(self.config.lookup_dir)
                sw_tables = rio.load_sw(self.config.lookup_dir)
            self._driver = RRTMGDriver(
                RRTMGConfig(
                    iovr=self.config.iovr_lw,
                    isol=self.config.isol,
                    ico2=self.config.ico2,
                    iaer=self.config.iaer,
                    icld=self.config.icld,
                    column_block=self.config.column_block,
                ),
                lw_tables=lw_tables,
                sw_tables=sw_tables,
                dtype=self.dtype, device=self.device, impl=self.impl,
            )
        elif self.config.scheme == "synthband":
            self._driver = RadiationDriver(
                DriverConfig(
                    iovr=self.config.iovr_lw,
                    isol=self.config.isol,
                    ico2=self.config.ico2,
                    iaer=self.config.iaer,
                    icld=self.config.icld,
                ),
                device=self.device,
            )
        self._initialized = True

    def __call__(self, time: datetime.datetime,
                 state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Radiative heating and flux diagnostics.  ``state`` holds z-last
        columns: air_temperature [..., nz],
        pressure_thickness_of_atmospheric_layer [..., nz],
        surface_temperature, latitude and longitude (radians) [...]; the
        band schemes also read specific_humidity,
        cloud_water_mixing_ratio, ozone_mixing_ratio and land_sea_mask
        where present."""
        if not self._initialized:
            self.init_driver()
        if self.config.scheme in ("rrtmg", "synthband"):
            return self._driver(time, state)
        days = zenith.days_from_2000(time)
        cosz = zenith.cos_zenith_angle(days,
                                       torch.rad2deg(state["longitude"]),
                                       torch.rad2deg(state["latitude"]))
        heating, diags = gray.gray_radiation(
            state["air_temperature"],
            state["pressure_thickness_of_atmospheric_layer"],
            state["surface_temperature"],
            cosz,
            state["latitude"],
            self.config.gray,
        )
        out = dict(diags)
        out["tendency_of_air_temperature_due_to_radiation"] = heating
        out["cos_zenith_angle"] = cosz
        return out
