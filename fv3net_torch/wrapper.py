"""The ``fv3gfs.wrapper``-shaped module API (port of
``fv3net_tpu/wrapper.py``).

reference: the Fortran model's Python bindings (SURVEY §1 L0; usage at
workflows/prognostic_c48_run/runtime/loop.py:376-426,630,637 and
runtime/derived_state.py:105-145): ``initialize() / step_dynamics() /
step_pre_radiation() / step_radiation() / step_post_radiation_physics()
/ apply_physics() / get_state() / set_state() /
set_state_mass_conserving() / get_diagnostic_by_name() /
get_tracer_metadata() / get_step_count() /
save_intermediate_restart_if_enabled() / cleanup() / flags``.

The Fortran wrapper mutates hidden global model memory; this module keeps
that call surface over one explicit ``_Model`` (a :class:`TimeLoop` on
``device``, the card unless the caller asks for the CPU), and every stage
call replaces its state.  The physics split is the reference's:
``step_radiation`` computes (and caches) the gray heating only on
``[..., z]``-last planes, ``step_post_radiation_physics`` computes the
full physics update with that cached heating, and ``apply_physics`` is
the state commit point.  ``step_dynamics`` runs the dycore step, whose
three vertical remaps launch the hand-written remap kernel on the card.
"""
from __future__ import annotations

import datetime
import types
from typing import Dict, Optional

import torch

from fv3net_torch.core.quantity import Quantity
from fv3net_torch.physics import physics_step
from fv3net_torch.runtime import names
from fv3net_torch.runtime.config import UserConfig
from fv3net_torch.runtime.derived_state import DIMS_2D, DIMS_3D

_MODEL: Optional["_Model"] = None


class _Model:
    def __init__(self, config: UserConfig, dtype=torch.float32,
                 device="cuda"):
        from fv3net_torch.runtime.loop import TimeLoop

        self.loop = TimeLoop(config, dtype=dtype, device=device)
        self.config = config
        self.step_count = 0
        self._pending_physics = None
        self._heating = None
        self._cosz = None
        self.diagnostics: Dict[str, Quantity] = {}
        nml = config.namelist
        self.flags = types.SimpleNamespace(
            hydrostatic=nml.hydrostatic,
            npx=nml.npx,
            npz=nml.npz,
            dt_atmos=nml.dt_atmos,
            n_split=nml.n_split,
            save_intermediate_restart=False,
            intermediate_restart_path="./RESTART",
        )

    # stages ---------------------------------------------------------------
    def step_dynamics(self) -> None:
        self.loop.time += datetime.timedelta(seconds=self.loop.timestep)
        self.loop._step_dynamics()
        self.step_count += 1

    def step_pre_radiation(self) -> None:
        dtype = self.loop.state.dycore.pt.dtype
        self._cosz = self.loop._cos_zenith(self.loop.time).to(dtype)
        self.diagnostics["cos_zenith_angle"] = Quantity(self._cosz, DIMS_2D)

    def step_radiation(self) -> None:
        from fv3net_torch.physics import radiation_gray as gray

        if self._cosz is None:
            self.step_pre_radiation()
        d = self.loop.state.dycore
        delp = torch.movedim(d.delp, 1, -1)
        derived = self.loop._derived()
        T = torch.movedim(derived[names.TEMP].data, 1, -1)
        heating, rad_diags = gray.gray_radiation(
            T,
            delp,
            self.loop.state.surface[names.TSFC],
            self._cosz,
            self.loop._g.lat,
            self.loop._phys_cfg.radiation,
        )
        self._heating = heating
        for k, arr in rad_diags.items():
            dims = DIMS_3D if arr.ndim == 4 else DIMS_2D
            self.diagnostics[k] = Quantity(
                torch.movedim(arr, -1, 1) if arr.ndim == 4 else arr, dims
            )

    def step_post_radiation_physics(self) -> None:
        if self._heating is None:
            self.step_radiation()
        heating = self._heating

        def cached_radiation(
            T, delp, q, qc, tsfc, cosz, lat, o3=None, land=None, ice=None
        ):
            return heating, {}

        new_dycore, raw = physics_step(
            self.loop.state.dycore,
            self.loop.state.surface[names.TSFC],
            self._cosz,
            self.loop._g.lat,
            self.loop.timestep,
            self.loop._phys_cfg,
            radiation_fn=cached_radiation,
        )
        self._pending_physics = new_dycore
        for k, arr in raw.items():
            dims = DIMS_3D if arr.ndim == 4 else DIMS_2D
            self.diagnostics[k] = Quantity(arr, dims)

    def apply_physics(self) -> None:
        if self._pending_physics is None:
            self.step_post_radiation_physics()
        self.loop.state.dycore = self._pending_physics
        self._pending_physics = None
        self._heating = None
        self._cosz = None


def _model() -> _Model:
    if _MODEL is None:
        raise RuntimeError("call initialize() first")
    return _MODEL


# ---------------------------------------------------------------- surface
def initialize(config: Optional[dict] = None, dtype=torch.float32,
               device="cuda") -> None:
    """(reference: wrapper.initialize() — reads namelist/restarts and sets
    up model memory; here a UserConfig-shaped dict) on ``device``."""
    global _MODEL
    if config is None:
        cfg = UserConfig()
    elif isinstance(config, UserConfig):
        cfg = config
    else:
        from fv3net_torch.runtime.config import get_config

        cfg = get_config(config)
    _MODEL = _Model(cfg, dtype=dtype, device=device)


def step_dynamics() -> None:
    _model().step_dynamics()


def step_pre_radiation() -> None:
    _model().step_pre_radiation()


def step_radiation() -> None:
    _model().step_radiation()


def step_post_radiation_physics() -> None:
    _model().step_post_radiation_physics()


def apply_physics() -> None:
    _model().apply_physics()


def get_state(variables) -> Dict[str, Quantity]:
    derived = _model().loop._derived()
    return {name: derived[name] for name in variables}


def set_state(updates: Dict[str, Quantity]) -> None:
    derived = _model().loop._derived()
    for key, value in updates.items():
        derived[key] = value
    _model().loop.state = derived.state


def set_state_mass_conserving(updates: Dict[str, Quantity]) -> None:
    """DerivedState setters are mass-conserving by construction
    (derived_state.py — the set_state_mass_conserving semantics)."""
    set_state(updates)


def get_diagnostic_by_name(name: str) -> Quantity:
    try:
        return _model().diagnostics[name]
    except KeyError:
        raise ValueError(f"no diagnostic {name!r} computed this step")


def get_tracer_metadata() -> Dict[str, Dict]:
    d = _model().loop.state.dycore
    out = {}
    for i, key in enumerate(sorted(d.tracers)):
        units = {"sphum": "kg/kg", "cloud_water": "kg/kg"}.get(key, "")
        out[key] = {"i_tracer": i + 1, "units": units}
    return out


def get_step_count() -> int:
    return _model().step_count


def save_intermediate_restart_if_enabled() -> None:
    m = _model()
    if m.flags.save_intermediate_restart:
        from fv3net_torch.runtime.checkpoint import save_state

        save_state(m.loop.state, m.loop.time, m.flags.intermediate_restart_path)


def cleanup() -> None:
    global _MODEL
    _MODEL = None


def flags() -> types.SimpleNamespace:
    return _model().flags
