"""Radiation stepper: the Python radiation in the loop (port of
``fv3net_tpu/runtime/steppers/radiation.py``; reference:
workflows/prognostic_c48_run/runtime/steppers/radiation.py:28-55): runs
the radiation wrapper beside the model's own radiation and returns its
fluxes as diagnostics, and with ``apply_heating`` its heating as dQ1."""
from __future__ import annotations

from typing import Dict

from fv3net_torch.core.quantity import Quantity
from fv3net_torch.physics.radiation import Radiation
from fv3net_torch.runtime import names
from fv3net_torch.runtime.derived_state import DIMS_2D, DIMS_3D, DerivedState


class RadiationStepper:
    label = "radiation"

    def __init__(self, radiation: Radiation, apply_heating: bool = False):
        self.radiation = radiation
        self.apply_heating = apply_heating

    def __call__(self, time, state: DerivedState):
        def zlast(q):
            return q.data.movedim(1, -1)

        cols = {
            "air_temperature": zlast(state[names.TEMP]),
            "pressure_thickness_of_atmospheric_layer": zlast(
                state[names.DELP]),
            "surface_temperature": state[names.TSFC].data,
            "latitude": state["latitude"].data,
            "longitude": state["longitude"].data,
        }
        # optional fields the band schemes read where available
        for opt, zdim in ((names.SPHUM, True), (names.CLOUD, True),
                          ("ozone_mixing_ratio", True), (names.MASK, False)):
            try:
                q = state[opt]
            except KeyError:
                continue
            cols[opt] = zlast(q) if zdim else q.data
        out = self.radiation(time, cols)
        nd3 = cols["air_temperature"].ndim
        diagnostics: Dict[str, Quantity] = {
            key: (Quantity(arr.movedim(-1, 1), DIMS_3D) if arr.ndim == nd3
                  else Quantity(arr, DIMS_2D))
            for key, arr in out.items()
        }
        tendencies: Dict[str, Quantity] = {}
        if self.apply_heating:
            tendencies["dQ1"] = diagnostics[
                "tendency_of_air_temperature_due_to_radiation"]
        return tendencies, diagnostics, {}
