"""Band radiation (port of ``fv3net_tpu/physics/radiation``): the RRTMG
LW and SW solvers and their GFS-style driver (``rrtmg/``), with the gas,
surface-optics and aerosol inputs they read."""
