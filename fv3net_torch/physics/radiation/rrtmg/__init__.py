"""RRTMG band solvers on tensors (port of
``fv3net_tpu/physics/radiation/rrtmg``): ``lw`` (16 bands / 140
g-points), ``sw`` (14 bands / 112 g-points), ``tables`` (table schemas +
synthetic fabrication), ``params`` (spectral constants) and ``driver``
(the GFS-driver adapter)."""
