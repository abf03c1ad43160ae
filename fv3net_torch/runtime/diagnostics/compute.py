"""Per-stepper diagnostics of the prognostic loop (port of
``fv3net_tpu/runtime/diagnostics/compute.py``; reference:
workflows/prognostic_c48_run/runtime/diagnostics/compute.py).

So far only the non-negative-humidity limiter of the ML stepper with its
change diagnostics; arrays are model-grid tensors [tile, nz, ny, nx]
(column axis 1).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from fv3net_torch.core.quantity import Quantity
from fv3net_torch.ops import thermo

DIMS_3D = ("tile", "z", "y", "x")
DIMS_2D = ("tile", "y", "x")


def _column_heating(dT_dt, delp, hydrostatic: bool):
    if hydrostatic:
        return thermo.column_integrated_heating_from_isobaric_transition(
            dT_dt, delp, axis=1
        )
    return thermo.column_integrated_heating_from_isochoric_transition(
        dT_dt, delp, axis=1
    )


def limit_sphum_tendency(
    sphum,
    tendencies: Dict[str, Quantity],
    dt: float,
    mse_conserving: bool,
    delp,
    hydrostatic: bool,
) -> Tuple[Dict[str, Quantity], Dict[str, Quantity]]:
    """Apply the non-negative-humidity limiter to dQ2 (and dQ1 through
    MSE conservation or plain scaling); returns (updated tendencies,
    limiter diagnostics)."""
    dQ2 = tendencies.get("dQ2")
    if dQ2 is None:
        return tendencies, {}
    dq2_old = dQ2.data
    dQ1 = tendencies.get("dQ1")
    dq1_old = None if dQ1 is None else dQ1.data
    if mse_conserving:
        dq2_new, dq1_new = thermo.non_negative_sphum_mse_conserving(
            sphum, dq2_old, dt, q1=dq1_old
        )
    else:
        dq1_new, dq2_new = thermo.non_negative_sphum(
            sphum,
            torch.zeros_like(dq2_old) if dq1_old is None else dq1_old,
            dq2_old,
            dt,
        )
        if dq1_old is None:
            dq1_new = None
    out = dict(tendencies)
    out["dQ2"] = Quantity(dq2_new, DIMS_3D)
    diags: Dict[str, Quantity] = {
        "specific_humidity_limiter_active": Quantity(
            (dq2_new != dq2_old).any().to(torch.float32), ()
        ),
        "column_integrated_dQ2_change_non_neg_sphum_constraint": Quantity(
            thermo.mass_integrate(dq2_new - dq2_old, delp, axis=1),
            DIMS_2D,
            "kg/m^2/s",
        ),
    }
    if dq1_new is not None and dq1_old is not None:
        out["dQ1"] = Quantity(dq1_new, DIMS_3D)
        diags[
            "column_integrated_dQ1_change_non_neg_sphum_constraint"
        ] = Quantity(
            _column_heating(dq1_new - dq1_old, delp, hydrostatic),
            DIMS_2D,
            "W/m^2",
        )
    return out, diags
