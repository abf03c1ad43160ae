"""Per-stepper diagnostics of the prognostic loop (port of
``fv3net_tpu/runtime/diagnostics/compute.py``; reference:
workflows/prognostic_c48_run/runtime/diagnostics/compute.py).

``compute_diagnostics`` (column moistening, heating and mass tendency
per stepper label), ``compute_ml_momentum_diagnostics`` (dQu/dQv column
stresses), ``compute_baseline_diagnostics`` (water vapor path and
physics precipitation), ``rename_diagnostics`` (the diagnostic-only ML
mode) and the non-negative-humidity limiter of the ML stepper with its
change diagnostics.  Arrays are model-grid tensors [tile, nz, ny, nx]
(column axis 1), wrapped as Quantities.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from fv3net_torch.core.quantity import Quantity
from fv3net_torch.ops import thermo
from fv3net_torch.parallel import sharded
from fv3net_torch.runtime import names

DIMS_3D = ("tile", "z", "y", "x")
DIMS_2D = ("tile", "y", "x")

# names zeroed (with a ``_diagnostic`` copy kept) when ML runs in
# diagnostic-only mode (reference compute.py:273-292 rename_diagnostics)
_ML_TENDENCY_DIAGS = (
    "net_moistening_due_to_{label}",
    "column_heating_due_to_{label}",
    "net_heating_due_to_{label}",
    "net_mass_tendency_due_to_{label}",
    "column_integrated_dQu_stress",
    "column_integrated_dQv_stress",
)


def _column_heating(dT_dt, delp, hydrostatic: bool):
    if hydrostatic:
        return thermo.column_integrated_heating_from_isobaric_transition(
            dT_dt, delp, axis=1
        )
    return thermo.column_integrated_heating_from_isochoric_transition(
        dT_dt, delp, axis=1
    )


def compute_diagnostics(
    delp, tendencies: Mapping[str, Quantity], label: str, hydrostatic: bool
) -> Dict[str, Quantity]:
    """Column-integrated moistening/heating/mass diagnostics for one
    stepper."""
    zeros = torch.zeros_like(delp)
    dQ1 = tendencies.get("dQ1")
    dQ2 = tendencies.get("dQ2")
    dT_dt = zeros if dQ1 is None else dQ1.data
    dq_dt = zeros if dQ2 is None else dQ2.data
    diags: Dict[str, Quantity] = {
        f"net_moistening_due_to_{label}": Quantity(
            thermo.mass_integrate(dq_dt, delp, axis=1), DIMS_2D, "kg/m^2/s"
        ),
        f"column_heating_due_to_{label}": Quantity(
            _column_heating(dT_dt, delp, hydrostatic), DIMS_2D, "W/m^2"
        ),
    }
    dQp = tendencies.get("dQp")
    if dQp is not None:
        diags[f"net_mass_tendency_due_to_{label}"] = Quantity(
            thermo.mass_integrate(torch.ones_like(delp), dQp.data, axis=1),
            DIMS_2D,
            "kg/m^2/s",
        )
    return diags


def compute_ml_momentum_diagnostics(
    delp, tendencies: Mapping[str, Quantity]
) -> Dict[str, Quantity]:
    """Column-integrated wind stresses due to ML."""
    out: Dict[str, Quantity] = {}
    for key, stress_name in (
        ("dQu", "column_integrated_dQu_stress"),
        ("dQv", "column_integrated_dQv_stress"),
    ):
        tend = tendencies.get(key)
        if tend is None:
            continue
        out[stress_name] = Quantity(
            thermo.mass_integrate(tend.data, delp, axis=1), DIMS_2D, "Pa"
        )
    return out


def compute_baseline_diagnostics(state) -> Dict[str, Quantity]:
    """water_vapor_path [mm], and physics_precip [kg/m^2/s] where the
    state holds the physics precipitation rate."""
    delp = state[names.DELP].data
    sphum = state[names.SPHUM].data
    diags = {
        "water_vapor_path": Quantity(
            thermo.mass_integrate(sphum, delp, axis=1), DIMS_2D, "mm"
        )
    }
    try:
        precip = state[names.PHYSICS_PRECIP_RATE]
    except KeyError:
        precip = None
    if precip is not None:
        diags["physics_precip"] = Quantity(precip.data, DIMS_2D, "kg/m^2/s")
    return diags


def rename_diagnostics(
    diags: Dict[str, Quantity], label: str = "machine_learning"
) -> None:
    """Postfix ML output names with ``_diagnostic`` and zero the
    originals, in place (the diagnostic-only ML mode: predictions are
    recorded, and the zeroed originals keep downstream budgets such as
    the precipitation sum unperturbed)."""
    for template in _ML_TENDENCY_DIAGS:
        name = template.format(label=label)
        q = diags.get(name)
        if q is None:
            continue
        diags[f"{name}_diagnostic"] = q
        diags[name] = Quantity(torch.zeros_like(q.data), q.dims, q.units)


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
            sharded.global_max(
                (dq2_new != dq2_old).any().to(torch.float32)), ()
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
