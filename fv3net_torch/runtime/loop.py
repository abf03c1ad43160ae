"""TimeLoop: the prognostic main loop (port of
``fv3net_tpu/runtime/loop.py``; reference:
workflows/prognostic_c48_run/runtime/loop.py:106-664).

An iterator over (time, diagnostics): per step it runs the prephysics
steppers, the dynamics, the physics with the prognostic surface and the
postphysics ML stepper, with the Monitor's tendency diagnostics of each
part; or, when the configuration allows it (:meth:`TimeLoop.fusable`),
whole chunks of steps: the flagship chunk
(``runtime/fused.py::build_fused_multi_step``) or, with ML, prescribers, a
prognostic surface or the online microphysics emulator, the production
chunk (``build_fused_production_chunk``), each followed by the
chunk-boundary diagnostics and their global means.  The Python radiation
stepper (``radiation_scheme``) runs on the per-step path, beside the
model's own radiation, after the dynamics.  ``impl`` reaches both chunk
builders, the per-step dynamics and radiation and the radiation stepper:
the same loop runs the hand kernels or their plain versions.

The reference's caches of compiled chunks (keyed on the configuration,
the ML model and the emulator) and its abstract-tracing probe of the ML
model are JAX's; here a loop builds its chunk once, when it is
constructed, with its own ML model and emulator, and any model of the
port runs inside a chunk.
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from fv3net_torch.core.constants import GRAVITY, TOA_PRESSURE
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.dycore.core import (
    DycoreConfig,
    GridArrays,
    dynamics_step,
    validate_acoustic_cfl,
)
from fv3net_torch.dycore.state import add_nonhydrostatic_fields, init_state
from fv3net_torch.grid.geometry import make_grid
from fv3net_torch.ops import zenith, zscan
from fv3net_torch.physics import PhysicsConfig
from fv3net_torch.physics.microphysics_gfdl import GFDL_TRACER_NAMES
from fv3net_torch.physics.radiation import gases
from fv3net_torch.runtime import factories, names
from fv3net_torch.runtime.factories import not_ported
from fv3net_torch.runtime.config import UserConfig
from fv3net_torch.runtime.derived_state import (
    DIMS_2D,
    DIMS_3D,
    DerivedState,
    ModelState,
)
from fv3net_torch.runtime.fused import aquaplanet_sst
from fv3net_torch.runtime.metrics import GLOBAL_MEANS_KEY, GlobalMeans, mean_impl
from fv3net_torch.runtime.monitor import Monitor
from fv3net_torch.runtime.steppers.machine_learning import add_tendency

logger = logging.getLogger(__name__)

#: the state fields every step (or chunk) reports, so that diagnostics
#: configs can record them (the reference's state_after_timestep.zarr)
STATE_FIELDS = (
    names.TEMP,
    names.SPHUM,
    names.EASTWARD_WIND,
    names.NORTHWARD_WIND,
    names.DELP,
    "surface_pressure",
)


class TimeLoop:
    """Iterator over (time, diagnostics) of a run configured by a
    :class:`~fv3net_torch.runtime.config.UserConfig`, on ``device`` in
    ``dtype``.

    The state starts at rest (``init_state``) over an aquaplanet SST, or
    from ``initial_conditions`` (a ``state.npz`` restart or a
    reference-layout Fortran RESTART); the sea-ice, bucket and Noah
    fields start as the reference starts them.  ``postphysics_stepper``
    and ``prephysics_steppers`` replace the steppers the config builds.
    Options the port does not run raise ``NotImplementedError`` naming
    their ROADMAP.md item.
    """

    def __init__(
        self,
        config: UserConfig,
        postphysics_stepper=None,
        prephysics_steppers: Optional[List] = None,
        dtype=torch.float32,
        device="cuda",
        impl: str = None,
    ):
        nml = config.namelist
        self._config = config
        self._dtype = dtype
        self._device = torch.device(device)
        self._impl = impl
        if tuple(int(v) for v in (nml.layout or (1, 1))) != (1, 1):
            raise not_ported(
                f"namelist layout {tuple(nml.layout)} (the sharded state)", 7)
        if nml.surface_data:
            raise not_ported(
                f"surface_data {nml.surface_data!r} (the catalog)", 10)
        factories.check_unported_steppers(config)

        self.grid = make_grid(nml.npx)
        self._g = GridArrays.from_grid(self.grid, dtype=dtype,
                                       device=self._device)
        dstate, ak, bk = init_state(self.grid, nml.npz, dtype=dtype,
                                    device=self._device)
        self._ak = torch.tensor(ak, dtype=dtype, device=self._device)
        self._bk = torch.tensor(bk, dtype=dtype, device=self._device)
        sst = aquaplanet_sst(self._g.lat)
        self.state = ModelState(
            dycore=dstate,
            surface={
                names.TSFC: sst,
                names.SST: sst,
                names.MASK: torch.zeros_like(sst),  # all ocean
            },
        )
        self.time = datetime.datetime.fromisoformat(config.initial_time)
        if config.initial_conditions:
            self._load_initial_conditions(config.initial_conditions,
                                          tuple(dstate.delp.shape))
        d = self.state.dycore
        tracers = dict(d.tracers)
        if nml.prognostic_ozone and "o3mr" not in tracers:
            # the radiation's climatology on the starting layers
            pe = torch.cat([torch.full_like(d.delp[:, :1], TOA_PRESSURE),
                            TOA_PRESSURE + zscan.cumsum(d.delp, axis=1)],
                           dim=1)
            pmid = d.delp / (torch.log(pe[:, 1:]) - torch.log(pe[:, :-1]))
            tracers["o3mr"] = gases.ozone_profile(
                pmid.movedim(1, -1), self._g.lat).movedim(-1, 1).to(dtype)
        if nml.microphysics == "gfdl":
            for name in GFDL_TRACER_NAMES:
                if name not in tracers:
                    tracers[name] = torch.zeros_like(d.delp)
        self.state.dycore = dataclasses.replace(d, tracers=tracers)
        surface = self.state.surface
        if nml.sea_ice and "ice_thickness" not in surface:
            surface["ice_thickness"] = torch.zeros_like(surface[names.TSFC])
        if nml.bucket_land and "soil_moisture" not in surface:
            from fv3net_torch.physics.land import BucketLandParams

            p = BucketLandParams(field_capacity_m=nml.bucket_capacity_m)
            surface["soil_moisture"] = torch.full_like(
                surface[names.TSFC], p.initial_fraction * p.field_capacity_m
            )
        if nml.land_model == "noah":
            from fv3net_torch.physics.soil import SoilParams

            tsfc0 = surface[names.TSFC]
            nl = len(SoilParams().dz)
            if "soil_temperature" not in surface:
                surface["soil_temperature"] = tsfc0.expand(
                    nl, *tsfc0.shape).clone()
            if "soil_moisture_layers" not in surface:
                surface["soil_moisture_layers"] = torch.full(
                    (nl, *tsfc0.shape), 0.25, dtype=dtype,
                    device=self._device)
            if "snow_water_equivalent" not in surface:
                surface["snow_water_equivalent"] = torch.zeros_like(tsfc0)
            if "deep_soil_temperature" not in surface:
                # tg3: a damped version of the initial skin state
                surface["deep_soil_temperature"] = torch.clamp(
                    tsfc0, 271.0, 300.0)
        self._timestep = nml.dt_atmos
        self._dyn_cfg = DycoreConfig(
            dt=nml.dt_atmos,
            n_split=nml.n_split,
            kord=nml.kord,
            diff_coef=nml.diff_coef,
            advection_order=nml.hord,
            divergence_damp_coef=nml.d2_div,
            d2_bg_k1=nml.d2_bg_k1,
            d2_bg_k2=nml.d2_bg_k2,
            remap_te=nml.remap_te,
            hydrostatic=nml.hydrostatic,
            tau_rayleigh=nml.tau,
            rf_cutoff=nml.rf_cutoff,
        )
        validate_acoustic_cfl(self._g, self._dyn_cfg)
        if not nml.hydrostatic and self.state.dycore.w is None:
            # a restart may already carry w and delz
            self.state.dycore = add_nonhydrostatic_fields(
                self.state.dycore, ptop=self._dyn_cfg.ptop)
        self._phys_cfg = PhysicsConfig(
            radiation_scheme=nml.radiation,
            surface_scheme=nml.surface_scheme,
            pbl_scheme=nml.pbl_scheme,
            convection_scheme=nml.convection,
            stratospheric_h2o=nml.stratospheric_h2o,
            microphysics_scheme=nml.microphysics,
            strat_eddy_damp_days=nml.strat_eddy_damp_days,
            strat_eddy_damp_pa=nml.strat_eddy_damp_pa,
        )
        self._fused_chunk = int(config.fused_chunk_steps or 0)
        self._radiation_interval = int(config.radiation_interval_steps or 1)
        self._postphysics_stepper = postphysics_stepper or (
            factories.get_postphysics_stepper(
                config, self._timestep, dtype=dtype, device=self._device)
        )
        self._prephysics_steppers = (
            prephysics_steppers
            if prephysics_steppers is not None
            else factories.get_prephysics_steppers(config, self._timestep)
        )
        self._radiation_stepper = factories.get_radiation_stepper(
            config, self._timestep, dtype=dtype, device=self._device,
            impl=impl)
        (self._microphysics_emulator, emu_target,
         self._emulator_piggy_back) = factories.get_microphysics_emulator(
            config, dtype=dtype, device=self._device)
        self._gscond_emulator = None
        if emu_target == "gscond":
            self._gscond_emulator = self._microphysics_emulator
            self._microphysics_emulator = None
        self.monitor = Monitor(
            [names.TEMP, names.SPHUM, names.CLOUD], self._timestep
        )
        # cos-zenith is computed in float64 and cast to the state's dtype
        self._lon_deg = torch.tensor(np.rad2deg(self.grid.lon),
                                     dtype=torch.float64, device=self._device)
        self._lat_deg = torch.tensor(np.rad2deg(self.grid.lat),
                                     dtype=torch.float64, device=self._device)
        # the chunk (with its RRTMG tables) or the per-step radiation is
        # built here, so that a segment's setup holds it
        self._chunk_fns: Dict = {}
        self._radiation_fn = None
        n_total = self.n_steps
        if self.fusable():
            if n_total:
                self._chunk_fn(min(self._fused_chunk, n_total))
        elif nml.radiation != "gray":
            from fv3net_torch.runtime.fused import _build_radiation_fn

            self._radiation_fn = _build_radiation_fn(
                self._phys_cfg, self._device, dtype, impl)

    # -- state placement --------------------------------------------------
    def place(self, state: ModelState) -> ModelState:
        """``state`` (say, a restart read on the CPU) on this loop's device
        in its dtype, every tensor contiguous.

        The loop places its state so after every step and chunk: a step
        leaves its fields z-last in memory, and some reductions round
        otherwise on such strides than on the contiguous fields a restart
        reads back, so that without it a run continued from a restart
        would part from an unbroken one by roundoff."""
        def t(x):
            return None if x is None else x.to(
                device=self._device, dtype=self._dtype).contiguous()

        d = state.dycore
        dycore = dataclasses.replace(
            d, delp=t(d.delp), pt=t(d.pt), wind=t(d.wind), phis=t(d.phis),
            w=t(d.w), delz=t(d.delz),
            tracers={k: t(v) for k, v in d.tracers.items()})
        return ModelState(dycore=dycore,
                          surface={k: t(v) for k, v in state.surface.items()})

    def _load_initial_conditions(self, ic: str, shape) -> None:
        """Start from a restart directory: this package's (or the
        reference's) ``state.npz``, or a reference-layout Fortran
        RESTART, whose surface fields add to the aquaplanet's."""
        import os

        from fv3net_torch.runtime import checkpoint

        if os.path.exists(os.path.join(ic, "state.npz")):
            state, self.time = checkpoint.load_state(ic)
            self.state = self.place(state)
            return
        loaded, t0 = checkpoint.load_fortran_restarts(ic,
                                                      expected_shape=shape)
        loaded = self.place(loaded)
        surface = dict(self.state.surface)
        surface.update(loaded.surface)
        self.state = ModelState(dycore=loaded.dycore, surface=surface)
        if t0 is not None:
            self.time = t0

    @property
    def timestep(self) -> float:
        return self._timestep

    @property
    def area(self) -> torch.Tensor:
        """Cell areas [6, ny, nx] on the loop's device, in its dtype."""
        return self._g.area

    @property
    def n_steps(self) -> int:
        """Model steps in the configured duration."""
        return int(self._config.duration_seconds // self._timestep)

    # -- substeps ---------------------------------------------------------
    def _derived(self) -> DerivedState:
        return DerivedState(self.state, self._g, ptop=self._dyn_cfg.ptop)

    def _cos_zenith(self, time: datetime.datetime) -> torch.Tensor:
        days = zenith.days_from_2000(time)
        return zenith.cos_zenith_angle(
            days, self._lon_deg, self._lat_deg).to(self._dtype)

    def _step_dynamics(self) -> Dict[str, Quantity]:
        self.state.dycore = dynamics_step(
            self.state.dycore, self._g, self._ak, self._bk, self._dyn_cfg,
            impl=self._impl,
        )
        return {}

    def _step_physics(self) -> Dict[str, Quantity]:
        from fv3net_torch.runtime.surface_step import physics_with_surface

        cosz = self._cos_zenith(self.time)
        new_dycore, new_surface, raw = physics_with_surface(
            self.state.dycore,
            self.state.surface,
            cosz,
            self._g.lat,
            self._timestep,
            self._config.namelist,
            self._phys_cfg,
            radiation_fn=self._radiation_fn,
            microphysics_emulator=self._microphysics_emulator,
            gscond_emulator=self._gscond_emulator,
            emulator_piggy_back=self._emulator_piggy_back,
        )
        self.state.dycore = new_dycore
        self.state.surface = new_surface
        diags: Dict[str, Quantity] = {}
        for key, arr in raw.items():
            diags[key] = Quantity(arr, DIMS_3D if arr.ndim == 4 else DIMS_2D)
        diags["cos_zenith_angle"] = Quantity(cosz, DIMS_2D)
        # the reference's surface precipitation name (kg/m2/s)
        diags[names.PHYSICS_PRECIP_RATE] = diags["PRATEsfc"]
        diags[names.TOTAL_PRECIP] = Quantity(
            new_surface[names.TOTAL_PRECIP], DIMS_2D, "m"
        )
        return diags

    def _apply_stepper(
        self, stepper, track_precip: bool = False
    ) -> Dict[str, Quantity]:
        from fv3net_torch.runtime.diagnostics.compute import (
            compute_diagnostics,
            compute_ml_momentum_diagnostics,
            rename_diagnostics,
        )
        from fv3net_torch.runtime.tendency import fillna_tendencies

        state = self._derived()
        tendencies, diagnostics, state_updates = stepper(self.time, state)
        delp_before = state[names.DELP].data if track_precip else None
        # zero-fill NaN tendencies (masked predictions) and record the
        # filled fraction
        if tendencies:
            tendencies, filled_frac = fillna_tendencies(tendencies)
            diagnostics = dict(diagnostics)
            diagnostics.update(filled_frac)
        # column-integrated moistening/heating/mass/momentum diagnostics
        # by stepper label
        column_diags: Dict[str, Quantity] = {}
        if any(k in tendencies for k in ("dQ1", "dQ2", "dQp")):
            column_diags.update(
                compute_diagnostics(
                    state[names.DELP].data,
                    tendencies,
                    stepper.label,
                    hydrostatic=self._config.namelist.hydrostatic,
                )
            )
        if any(k in tendencies for k in ("dQu", "dQv")):
            column_diags.update(
                compute_ml_momentum_diagnostics(
                    state[names.DELP].data, tendencies
                )
            )
        if getattr(stepper, "diagnostic_only", False):
            # record the predictions, apply nothing
            out = dict(diagnostics)
            out.update(column_diags)
            rename_diagnostics(out, stepper.label)
            for key, tend in tendencies.items():
                out[f"{key}_{stepper.label}"] = tend
            if track_precip:
                phys_precip = self.state.surface.get(names.TOTAL_PRECIP)
                if phys_precip is not None:
                    out[names.TOTAL_PRECIP] = Quantity(
                        phys_precip, DIMS_2D, "m"
                    )
            return out
        add_tendency(state, tendencies, self._timestep)
        # a stepper updating TOTAL_PRECIP_RATE directly overrides the
        # accumulation
        state_updates = dict(state_updates)
        rate_update = state_updates.pop(names.TOTAL_PRECIP_RATE, None)
        if rate_update is not None:
            rate_update = torch.as_tensor(rate_update.data).to(
                device=self._device, dtype=self._dtype)
        for key, value in state_updates.items():
            state[key] = value
        out = dict(diagnostics)
        out.update(column_diags)
        if track_precip:
            # precipitation_sum: physics precipitation less the ML
            # moistening, thresholded non-negative.  The moistening is the
            # column's delp change: the humidity setter keeps the dry
            # mass, so the delp change is the water added
            net_moistening = (state[names.DELP].data - delp_before).sum(
                dim=1) / (GRAVITY * self._timestep)
            phys_precip = self.state.surface.get(names.TOTAL_PRECIP)
            if phys_precip is None:
                phys_precip = torch.zeros_like(
                    self.state.surface[names.TSFC])
            total = phys_precip - net_moistening * self._timestep / 1000.0
            if rate_update is not None:
                total = rate_update * self._timestep / 1000.0
            total = torch.clamp(total, min=0.0)
            state.state.surface[names.TOTAL_PRECIP] = total
            out[names.TOTAL_PRECIP] = Quantity(total, DIMS_2D, "m")
            out[names.TOTAL_PRECIP_RATE] = Quantity(
                1000.0 * total / self._timestep, DIMS_2D, "kg/m^2/s"
            )
            out["net_moistening_due_to_machine_learning"] = Quantity(
                net_moistening, DIMS_2D, "kg/m^2/s"
            )
        elif rate_update is not None:
            state.state.surface[names.TOTAL_PRECIP] = (
                rate_update * self._timestep / 1000.0
            )
        self.state = state.state
        for key, tend in tendencies.items():
            out[f"{key}_{stepper.label}"] = tend
        return out

    def _step_postphysics(self) -> Dict[str, Quantity]:
        if self._postphysics_stepper is None:
            return {}
        return self._apply_stepper(
            self._postphysics_stepper, track_precip=True
        )

    @torch.no_grad()
    def _step(self) -> Tuple[datetime.datetime, Dict[str, Quantity]]:
        """One step of the per-step path."""
        from fv3net_torch.runtime.diagnostics.compute import (
            compute_baseline_diagnostics,
        )

        self.time += datetime.timedelta(seconds=self._timestep)
        diags: Dict[str, Quantity] = {}
        state = self._derived()
        for stepper in self._prephysics_steppers:
            diags.update(self._apply_stepper(stepper))
        diags.update(self.monitor("dynamics", self._step_dynamics, state))
        if self._radiation_stepper is not None:
            # the Python radiation beside the model's own: its fluxes as
            # diagnostics, its heating as dQ1 with apply_heating
            diags.update(self.monitor(
                "radiation",
                lambda: self._apply_stepper(self._radiation_stepper),
                state))
        diags.update(self.monitor("fv3_physics", self._step_physics, state))
        diags.update(self.monitor("python", self._step_postphysics, state))
        # water_vapor_path (+ physics_precip) every step
        diags.update(compute_baseline_diagnostics(self._derived()))
        if names.PHYSICS_PRECIP_RATE in diags:
            diags["physics_precip"] = diags[names.PHYSICS_PRECIP_RATE]
        for name in STATE_FIELDS:
            diags[name] = state[name]
        self.state = self.place(self.state)
        return self.time, diags

    # -- fused path -------------------------------------------------------
    def _production_features(self) -> bool:
        """Anything beyond the plain dynamics + physics chunk: the ML
        stepper, prescribers, the emulators or prognostic surface
        components."""
        nml = self._config.namelist
        return bool(
            self._postphysics_stepper is not None
            or self._prephysics_steppers
            or self._microphysics_emulator is not None
            or self._gscond_emulator is not None
            or nml.slab_ocean
            or nml.bucket_land
            or nml.sea_ice
            or nml.land_model
        )

    def fusable(self) -> bool:
        """True when the run goes in chunks of ``fused_chunk_steps``
        steps: more than one step a chunk, no Python radiation stepper,
        a postphysics stepper (if any) that is a dense ML stepper
        applying its predictions, and prephysics steppers (if any) that
        are prescribers; the emulators run inside a chunk.  A
        diagnostic-only ML stepper keeps the per-step path (its per-step
        record is the point of that mode)."""
        from fv3net_torch.runtime.steppers.machine_learning import (
            PureMLStepper,
        )
        from fv3net_torch.runtime.steppers.prescriber import Prescriber

        if self._fused_chunk <= 1 or self._radiation_stepper is not None:
            return False
        post = self._postphysics_stepper
        if post is not None and not (
            isinstance(post, PureMLStepper)
            and not getattr(post, "diagnostic_only", False)
        ):
            return False
        return all(isinstance(s, Prescriber)
                   for s in self._prephysics_steppers)

    def _prefetch_prescribed(self, n_steps: int, start_time):
        """Every prephysics stepper's data for a chunk of ``n_steps`` from
        ``start_time``: a tuple (one per stepper) of {name: [n_steps,
        ...]} tensors on the device in the state's dtype, one
        host->device copy per variable."""
        out = []
        for stepper in self._prephysics_steppers:
            per_step: List[Dict] = []
            t = start_time
            for _ in range(n_steps):
                t = t + datetime.timedelta(seconds=self._timestep)
                tendencies, _, state_updates = stepper(t, None)
                updates = tendencies or state_updates
                per_step.append(
                    {k: getattr(v, "data", v) for k, v in updates.items()})
            out.append({
                k: torch.stack([torch.as_tensor(d[k]) for d in per_step]).to(
                    device=self._device, dtype=self._dtype)
                for k in per_step[0]
            })
        return tuple(out)

    def chunk_cos_zenith(self, n_steps: int) -> torch.Tensor:
        """The cos-zenith a chunk of ``n_steps`` from the loop's time
        holds (at the chunk's midpoint)."""
        return self._cos_zenith(self.time + datetime.timedelta(
            seconds=self._timestep * n_steps / 2.0))

    def chunk_inputs(self, n_steps: int):
        """``(dycore, surface, cos_zenith, prescribed)``: the arguments of
        the production chunk of ``n_steps`` from the loop's state and
        time, as the fused path hands them to it."""
        return (self.state.dycore, self.state.surface,
                self.chunk_cos_zenith(n_steps),
                self._prefetch_prescribed(n_steps, self.time))

    def build_production_chunk(self, n_steps: int):
        """The bare production chunk this loop runs (without its
        boundary diagnostics)."""
        from fv3net_torch.runtime.fused import build_fused_production_chunk

        return build_fused_production_chunk(
            self._g, self._ak, self._bk, self._dyn_cfg, self._phys_cfg,
            self._config.namelist,
            ml_stepper=self._postphysics_stepper,
            n_steps=n_steps,
            radiation_interval=self._radiation_interval,
            prephysics_kinds=("set",) * len(self._prephysics_steppers),
            impl=self._impl,
            microphysics_emulator=self._microphysics_emulator,
            gscond_emulator=self._gscond_emulator,
            emulator_piggy_back=self._emulator_piggy_back,
        )

    @torch.no_grad()
    def _boundary_diagnostics(self, dycore, surface, cosz, raw=None):
        """The chunk-boundary diagnostics: the state fields, the baseline
        diagnostics, the chunk's physics and surface diagnostics (the
        last step's; TOTAL_PRECIP accumulated over the chunk) and the
        global means of the cos-zenith and of every 2-D field."""
        from fv3net_torch.runtime.diagnostics.compute import (
            compute_baseline_diagnostics,
        )

        st = DerivedState(ModelState(dycore=dycore, surface=surface),
                          self._g, ptop=self._dyn_cfg.ptop)
        out = {name: st[name] for name in STATE_FIELDS}
        out.update(compute_baseline_diagnostics(st))
        for k, v in (raw or {}).items():
            if k not in out:
                out[k] = Quantity(v, DIMS_3D if v.ndim == 4 else DIMS_2D,
                                  "m" if k == names.TOTAL_PRECIP else "")
        f2d = {"cos_zenith_angle": cosz}
        f2d.update({k: q.data for k, q in out.items() if q.data.ndim == 3})
        means = torch.stack([mean_impl(v, self._g.area)
                             for v in f2d.values()])
        out[GLOBAL_MEANS_KEY] = GlobalMeans(list(f2d), means)
        return out

    def _chunk_fn(self, n_steps: int):
        """The chunk of ``n_steps`` and its boundary diagnostics:
        ``fn(dycore, surface, cosz, prescribed) -> (dycore, surface,
        diags)``, built once per length."""
        fn = self._chunk_fns.get(n_steps)
        if fn is not None:
            return fn
        if self._production_features():
            base = self.build_production_chunk(n_steps)

            def fn(dycore, surface, cosz, prescribed):
                new, new_surface, raw = base(dycore, surface, cosz,
                                             prescribed)
                return new, new_surface, self._boundary_diagnostics(
                    new, new_surface, cosz, raw)
        else:
            from fv3net_torch.runtime.fused import build_fused_multi_step

            base = build_fused_multi_step(
                self._g, self._ak, self._bk, self._dyn_cfg, self._phys_cfg,
                n_steps=n_steps,
                radiation_interval=self._radiation_interval,
                impl=self._impl,
            )

            def fn(dycore, surface, cosz, prescribed):
                new = base(dycore, 0, surface[names.TSFC], cosz)
                return new, surface, self._boundary_diagnostics(
                    new, surface, cosz)
        self._chunk_fns[n_steps] = fn
        return fn

    def _iter_fused(self):
        """Chunked iteration: ``fused_chunk_steps`` model steps a chunk,
        diagnostics at chunk boundaries."""
        n_total = self.n_steps
        done = 0
        if (self._production_features()
                and names.TOTAL_PRECIP not in self.state.surface):
            # the production chunk adds TOTAL_PRECIP to the surface state
            self.state.surface[names.TOTAL_PRECIP] = torch.zeros_like(
                self.state.surface[names.TSFC])
        while done < n_total:
            this = min(self._fused_chunk, n_total - done)
            dycore, surface, cosz, prescribed = self.chunk_inputs(this)
            self.state.dycore, new_surface, diag_out = self._chunk_fn(this)(
                dycore, surface, cosz, prescribed)
            self.state.surface = dict(new_surface)
            self.state = self.place(self.state)
            done += this
            self.time += datetime.timedelta(seconds=self._timestep * this)
            diags: Dict[str, Quantity] = {
                "cos_zenith_angle": Quantity(cosz, DIMS_2D)
            }
            diags.update(diag_out)
            yield self.time, diags

    # -- iteration --------------------------------------------------------
    def __iter__(self) -> Iterator[Tuple[datetime.datetime,
                                         Dict[str, Quantity]]]:
        if self.fusable():
            yield from self._iter_fused()
            return
        for _ in range(self.n_steps):
            yield self._step()
