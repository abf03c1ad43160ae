"""Variable naming conventions, matching the reference so configs and
trained models carry over (a copy of ``fv3net_tpu/runtime/names.py``;
the two must stay identical; reference:
workflows/prognostic_c48_run/runtime/names.py:1-72)."""
from typing import Hashable, Mapping

TEMP = "air_temperature"
TOTAL_WATER = "total_water"
CLOUD = "cloud_water_mixing_ratio"
SPHUM = "specific_humidity"
DELP = "pressure_thickness_of_atmospheric_layer"
PHYSICS_PRECIP_RATE = "surface_precipitation_rate"  # kg/m2/s from physics
TOTAL_PRECIP_RATE = "total_precipitation_rate"  # may include ML/nudging
TOTAL_PRECIP = "total_precipitation"  # m
AREA = "area_of_grid_cell"
EASTWARD_WIND = "eastward_wind"
NORTHWARD_WIND = "northward_wind"
EASTWARD_WIND_AFTER_PHYSICS = "eastward_wind_after_physics"
SST = "ocean_surface_temperature"
TSFC = "surface_temperature"
MASK = "land_sea_mask"
TIME_KEYS = ["time", "initialization_time"]

EASTWARD_WIND_TENDENCY = "dQu"
NORTHWARD_WIND_TENDENCY = "dQv"

TENDENCY_TO_STATE_NAME: Mapping[Hashable, Hashable] = {
    "dQ1": TEMP,
    "dQ2": SPHUM,
    EASTWARD_WIND_TENDENCY: EASTWARD_WIND,
    NORTHWARD_WIND_TENDENCY: NORTHWARD_WIND,
    "dQp": DELP,
}
STATE_NAME_TO_TENDENCY = {v: k for k, v in TENDENCY_TO_STATE_NAME.items()}
A_GRID_WIND_TENDENCIES = {EASTWARD_WIND_TENDENCY, NORTHWARD_WIND_TENDENCY}
TENDENCY_NAMES = set(TENDENCY_TO_STATE_NAME)


def is_tendency_variable(key) -> bool:
    return key in TENDENCY_NAMES


def is_state_update_variable(key, state) -> bool:
    if key in state and key not in TENDENCY_NAMES:
        return True
    return key == TOTAL_PRECIP_RATE
