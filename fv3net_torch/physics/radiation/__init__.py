"""Band radiation (port of ``fv3net_tpu/physics/radiation``): the RRTMG
LW and SW solvers and their GFS-style driver (``rrtmg/``), the synthetic
band model (params, spectra, optics, lw, sw, driver), the GFS radiation
driver chain (``gfs_driver``), and the ``Radiation`` wrapper over the
gray, rrtmg and synthband schemes."""
from fv3net_torch.physics.radiation.wrapper import (  # noqa: F401
    Radiation,
    RadiationConfig,
)
from fv3net_torch.physics.radiation.driver import (  # noqa: F401
    DriverConfig,
    RadiationDriver,
)
