"""Physical constants, following FV3GFS (FMS constants.f90).

A copy of ``fv3net_tpu/core/constants.py``; the two must stay identical.

Values match the reference's vcm constants
(reference: external/vcm/vcm/calc/thermo/constants.py) so thermodynamic
parity tests agree bit-for-bit in float64 and to rounding in float32.
"""

GRAVITY = 9.80665  # m / s^2
RDGAS = 287.05  # J / K / kg
RVGAS = 461.5  # J / K / kg
CP_AIR = 1004.0  # specific heat at constant pressure, J / K / kg
CV_AIR = CP_AIR - RDGAS  # specific heat at constant volume
KAPPA = RDGAS / CP_AIR  # ~0.2859; note vcm uses POISSON_CONST=0.2854
POISSON_CONST = 0.2854  # the value vcm hard-codes for potential temperature
LATENT_HEAT_VAPORIZATION_0_C = 2.5e6  # J / kg
LATENT_HEAT_FUSION = 3.3358e5  # J / kg
SPECIFIC_ENTHALPY_LIQUID = 4185.5
SPECIFIC_ENTHALPY_VAPOR = 1846.0
FREEZING_TEMPERATURE = 273.15  # K
DEFAULT_SURFACE_TEMPERATURE = FREEZING_TEMPERATURE + 15
EARTH_RADIUS = 6.3712e6  # m
EARTH_ROTATION_RATE = 7.2921e-5  # rad / s (2*pi / sidereal day)

REFERENCE_SURFACE_PRESSURE = 100000.0  # Pa, for potential temperature
TOA_PRESSURE = 300.0  # Pa, model-top pressure of default 79-level FV3GFS

SEC_PER_DAY = 86400
KG_M2S_TO_MM_DAY = (1e3 * 86400) / 997.0
KG_M2_TO_MM = 1000.0 / 997.0

# Solar constant used by the simplified radiation scheme [W/m^2]
SOLAR_CONSTANT = 1361.0

# Stefan-Boltzmann constant [W/m^2/K^4]
STEFAN_BOLTZMANN = 5.670374419e-8
