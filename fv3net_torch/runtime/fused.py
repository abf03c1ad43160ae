"""The whole-model step: dynamics + physics + the in-step dense ML
correction (port of ``fv3net_tpu/runtime/fused.py``).

PyTorch runs eagerly, so a "fused" step here is a plain Python function
under ``torch.no_grad``; the chunk's step loop and the radiation cache
are Python.  ``impl`` selects the kernels' versions -- the vertical-remap
application and the RRTMG k-table selections (None: the CUDA kernels on
CUDA tensors, the plain versions on CPU tensors).
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Callable, Optional, Tuple

import torch
from torch.profiler import record_function

from fv3net_torch.dycore.core import (
    DycoreConfig,
    GridArrays,
    dynamics_step,
    validate_acoustic_cfl,
)
from fv3net_torch.dycore.state import (
    DycoreState,
    temperature_from_theta_v,
    theta_v_from_temperature,
)
from fv3net_torch.fit import packer
from fv3net_torch.ops import thermo
from fv3net_torch.physics import radiation_gray
from fv3net_torch.physics.driver import PhysicsConfig, physics_step


def aquaplanet_sst(lat: torch.Tensor) -> torch.Tensor:
    """Zonally symmetric SST profile (QOBS-like), from the reference's
    ``runtime/loop.py``."""
    return 300.15 - 30.0 * torch.sin(lat) ** 2


def ml_correction_fn(model) -> Tuple[Callable, object]:
    """From a :class:`~fv3net_torch.fit.dense.DenseModel`, build
    ``apply(params, state, pmid, dt) -> state`` adding its dQ1/dQ2
    tendencies with the MSE-conserving non-negative humidity limiter.
    Returns ``(apply, params)`` where ``params`` is the model itself."""

    def apply(params, state: DycoreState, pmid, dt: float) -> DycoreState:
        q = state.tracers["sphum"]
        T = temperature_from_theta_v(state.pt, pmid, q)
        cols = {
            "air_temperature": packer.stack_columns(T),
            "specific_humidity": packer.stack_columns(q),
        }
        X, _ = packer.pack(cols, params.input_variables)
        out = packer.unpack(params.apply_packed(X), params.output_info)
        grid_shape = (T.shape[0], T.shape[2], T.shape[3])
        dQ1 = packer.unstack_columns(out["dQ1"], grid_shape)
        dQ2 = packer.unstack_columns(out["dQ2"], grid_shape)
        dQ2, dQ1 = thermo.non_negative_sphum_mse_conserving(
            q, dQ2, dt, q1=dQ1
        )
        T = T + dt * dQ1
        q = q + dt * dQ2
        tracers = dict(state.tracers)
        tracers["sphum"] = q
        return dataclasses.replace(
            state, pt=theta_v_from_temperature(T, pmid, q), tracers=tracers
        )

    return apply, model


def _build_radiation_fn(phys_cfg: PhysicsConfig, device, dtype,
                        impl: str = None, lw_taumol: str = "ktable",
                        rrtmg_options: Optional[dict] = None
                        ) -> Optional[Callable]:
    """The band-solver closure handed to physics_step: the RRTMG driver
    for scheme "rrtmg", None for "gray" (which physics_step computes).

    The driver computes in ``dtype``, the state's (the reference's
    driver computes in float32 whatever the state's dtype), at solar
    constant 1368.22 * ``solcon_scale``.  ``lw_taumol`` is its route
    of the LW gas optics; ``rrtmg_options`` other fields of its
    ``RRTMGConfig`` (``storage_dtype``, ``compress_daylight``,
    ``fast_exp``, ``column_block``, ...)."""
    if phys_cfg.radiation_scheme == "gray":
        return None
    if phys_cfg.radiation_scheme != "rrtmg":
        raise NotImplementedError(
            f"radiation_scheme={phys_cfg.radiation_scheme!r} is not ported "
            "to fv3net_torch yet (gray and rrtmg are; ROADMAP.md Queue 1 "
            "item 6)"
        )
    from fv3net_torch.physics.radiation.rrtmg.driver import (
        RRTMGConfig,
        RRTMGDriver,
    )

    driver = RRTMGDriver(
        RRTMGConfig(solcon=1368.22 * phys_cfg.solcon_scale,
                    **(rrtmg_options or {})),
        dtype=dtype, device=device, impl=impl, lw_taumol=lw_taumol,
    )
    epoch = datetime.datetime(2016, 7, 1)  # isol=0: the date seeds o3 only

    def radiation_fn(T, delp, q, qc, t_surface, cos_zenith, lat, o3=None,
                     land=None, ice=None):
        state = {
            "air_temperature": T,
            "pressure_thickness_of_atmospheric_layer": delp,
            "specific_humidity": q,
            "cloud_water_mixing_ratio": qc,
            "surface_temperature": t_surface,
            "latitude": lat,
            "longitude": torch.zeros_like(lat),
        }
        if o3 is not None:  # a prognostic ozone tracer
            state["ozone_mixing_ratio"] = o3
        if land is not None:
            state["land_sea_mask"] = land
        if ice is not None:  # the sea-ice albedo feedback
            state["ice_fraction"] = ice
        out = driver(epoch, state, cosz=cos_zenith)
        sfx = "_python"
        return out["tendency_of_air_temperature_due_to_radiation"], {
            "ULWRFtoa": out["total_sky_upward_longwave_flux_at_top_of_"
                            "atmosphere" + sfx],
            "USWRFtoa": out["total_sky_upward_shortwave_flux_at_top_of_"
                            "atmosphere" + sfx],
            "DSWRFsfc": out["total_sky_downward_shortwave_flux_at_surface"
                            + sfx],
            "DLWRFsfc": out["total_sky_downward_longwave_flux_at_surface"
                            + sfx],
        }

    return radiation_fn


def _ml_step(ml_apply, ml_params, s: DycoreState, dyn_cfg: DycoreConfig):
    delp_c = s.delp.movedim(1, -1)
    pmid = thermo.pressure_at_midpoint_log(
        delp_c, toa_pressure=dyn_cfg.ptop
    ).movedim(-1, 1)
    return ml_apply(ml_params, s, pmid, dyn_cfg.dt)


def build_fused_step(
    g: GridArrays,
    ak: torch.Tensor,
    bk: torch.Tensor,
    dyn_cfg: DycoreConfig,
    phys_cfg: PhysicsConfig,
    ml_apply: Optional[Callable] = None,
    impl: str = None,
    lw_taumol: str = "ktable",
    rrtmg_options: Optional[dict] = None,
):
    """Returns step(state, ml_params, t_surface, cos_zenith) -> state."""
    validate_acoustic_cfl(g, dyn_cfg)
    radiation_fn = _build_radiation_fn(phys_cfg, g.lat.device, g.lat.dtype,
                                       impl, lw_taumol, rrtmg_options)

    @torch.no_grad()
    def step(state: DycoreState, ml_params, t_surface, cos_zenith):
        state = dynamics_step(state, g, ak, bk, dyn_cfg, impl=impl)
        state, _ = physics_step(
            state, t_surface, cos_zenith, g.lat, dyn_cfg.dt, phys_cfg,
            radiation_fn=radiation_fn,
        )
        if ml_apply is not None:
            state = _ml_step(ml_apply, ml_params, state, dyn_cfg)
        return state

    return step


def build_fused_multi_step(
    g: GridArrays,
    ak: torch.Tensor,
    bk: torch.Tensor,
    dyn_cfg: DycoreConfig,
    phys_cfg: PhysicsConfig,
    ml_apply: Optional[Callable] = None,
    n_steps: int = 8,
    radiation_interval: int = 1,
    impl: str = None,
    lw_taumol: str = "ktable",
    rrtmg_options: Optional[dict] = None,
):
    """``n_steps`` model steps, computing radiation only every
    ``radiation_interval`` steps (always at step 0) and reusing the
    stored heating rates and fluxes in between (for rrtmg the heating
    plus the four flux diagnostics ULWRFtoa, USWRFtoa, DSWRFsfc,
    DLWRFsfc).  ``lw_taumol`` routes RRTMG's LW gas optics ("ktable" or
    "mega"), ``rrtmg_options`` sets fields of its ``RRTMGConfig``.  Each
    step's parts run under the profiler ranges "dynamics", "radiation",
    "physics" and "ml".

    Returns fn(state, ml_params, t_surface, cos_zenith) -> state.
    """
    validate_acoustic_cfl(g, dyn_cfg)
    band_radiation = _build_radiation_fn(phys_cfg, g.lat.device,
                                         g.lat.dtype, impl, lw_taumol,
                                         rrtmg_options)

    def radiation(s: DycoreState, t_surface, cos_zenith):
        delp = s.delp.movedim(1, -1)
        q = s.tracers["sphum"].movedim(1, -1)
        pmid = thermo.pressure_at_midpoint_log(
            delp, toa_pressure=dyn_cfg.ptop
        )
        T = temperature_from_theta_v(s.pt.movedim(1, -1), pmid, q)
        if band_radiation is None:
            return radiation_gray.gray_radiation(
                T, delp, t_surface, cos_zenith, g.lat, phys_cfg.radiation
            )
        qc = s.tracers["cloud_water"].movedim(1, -1)
        o3 = (s.tracers["o3mr"].movedim(1, -1)
              if "o3mr" in s.tracers else None)
        return band_radiation(T, delp, q, qc, t_surface, cos_zenith, g.lat,
                              o3=o3)

    @torch.no_grad()
    def multi(state: DycoreState, ml_params, t_surface, cos_zenith):
        cache = None
        for i in range(n_steps):
            with record_function("dynamics"):
                state = dynamics_step(state, g, ak, bk, dyn_cfg, impl=impl)
            if i % radiation_interval == 0:
                with record_function("radiation"):
                    cache = radiation(state, t_surface, cos_zenith)
            with record_function("physics"):
                state, _ = physics_step(
                    state, t_surface, cos_zenith, g.lat, dyn_cfg.dt,
                    phys_cfg,
                    radiation_fn=lambda *_a, cached=cache, **_k: cached,
                )
            if ml_apply is not None:
                with record_function("ml"):
                    state = _ml_step(ml_apply, ml_params, state, dyn_cfg)
        return state

    return multi


def _rad_inputs_full(state: DycoreState, dyn_cfg: DycoreConfig,
                     gfdl_mode: bool = False):
    """Radiation column inputs (z-last) from the dycore state: (T, delp,
    q, qc, o3), o3 None without a prognostic ozone tracer.

    In six-category mode (``gfdl_mode``) the reference's chunk adds a
    "cloud_ice" tracer to the condensate, as here; the six-category state
    holds its ice as "ice_wat", so the chunk's cached radiation sees the
    liquid only where ``physics_step`` hands liquid + ice to its
    ``radiation_fn`` (ROADMAP Queue 3)."""
    delp = state.delp.movedim(1, -1)
    q = state.tracers["sphum"].movedim(1, -1)
    qc = state.tracers["cloud_water"].movedim(1, -1)
    if gfdl_mode and "cloud_ice" in state.tracers:
        qc = qc + state.tracers["cloud_ice"].movedim(1, -1)
    pmid = thermo.pressure_at_midpoint_log(delp, toa_pressure=dyn_cfg.ptop)
    T = temperature_from_theta_v(state.pt.movedim(1, -1), pmid, q)
    o3 = (state.tracers["o3mr"].movedim(1, -1)
          if "o3mr" in state.tracers else None)
    return T, delp, q, qc, o3


def apply_stepper_in_graph(stepper, st, dt: float,
                           track_precip: bool = False):
    """Apply one stepper's (tendencies, diagnostics, state_updates) to a
    DerivedState ``st`` (mutated in place): NaN-filling, the tendencies,
    the state updates and, with ``track_precip`` (postphysics ML), the
    precipitation bookkeeping that closes the surface water budget.
    Returns the call's diagnostics (tensors)."""
    from fv3net_torch.core.constants import GRAVITY
    from fv3net_torch.runtime import names
    from fv3net_torch.runtime.steppers.machine_learning import add_tendency
    from fv3net_torch.runtime.tendency import fillna_tendencies

    tendencies, diagnostics, state_updates = stepper(None, st)
    out = {k: getattr(v, "data", v) for k, v in diagnostics.items()}
    if tendencies:
        tendencies, filled_frac = fillna_tendencies(tendencies)
        out.update({k: v.data for k, v in filled_frac.items()})
    delp_before = st[names.DELP].data if track_precip else None
    add_tendency(st, tendencies, dt)
    state_updates = dict(state_updates)
    rate_update = state_updates.pop(names.TOTAL_PRECIP_RATE, None)
    for key, value in state_updates.items():
        st[key] = value
    if track_precip:
        net_moistening = (st[names.DELP].data - delp_before).sum(dim=1) / (
            GRAVITY * dt
        )
        phys_precip = st.state.surface.get(names.TOTAL_PRECIP)
        if phys_precip is None:
            phys_precip = torch.zeros_like(net_moistening)
        total = phys_precip - net_moistening * dt / 1000.0
        if rate_update is not None:
            total = rate_update.data * dt / 1000.0
        st.state.surface[names.TOTAL_PRECIP] = torch.clamp(total, min=0.0)
        out["net_moistening_due_to_machine_learning"] = net_moistening
    elif rate_update is not None:
        st.state.surface[names.TOTAL_PRECIP] = rate_update.data * dt / 1000.0
    return out


def build_fused_production_chunk(
    g: GridArrays,
    ak: torch.Tensor,
    bk: torch.Tensor,
    dyn_cfg: DycoreConfig,
    phys_cfg: PhysicsConfig,
    nml,
    ml_stepper=None,
    n_steps: int = 8,
    radiation_interval: int = 1,
    prephysics_kinds: Tuple[str, ...] = (),
    impl: str = None,
):
    """The production configuration as one chunk of ``n_steps`` steps:
    prephysics prescribers -> dynamics -> physics with the prognostic
    surface (slab ocean, sea ice, bucket land, Noah soil) -> the
    postphysics ML stepper, with the band radiation computed every
    ``radiation_interval`` steps (from step 0) and reused between.

    ``nml``: a :class:`~fv3net_torch.runtime.config.NamelistConfig` (its
    surface switches).  ``prephysics_kinds``: "set" or "tend" per
    prephysics stepper; ``prescribed`` then holds, per stepper, a dict of
    [n_steps, ...] tensors applied in order before the dynamics of each
    step ("set" overwrites the named variables, "tend" adds dt times the
    named tendencies).  The band radiation takes the default k-table
    route of the LW gas optics.  Each step's parts run under the profiler
    ranges "prephysics", "dynamics", "radiation", "physics" (with the
    surface models) and "ml".  The reference's microphysics emulator
    hooks are not ported.

    Returns ``fn(dycore, surface, cos_zenith, prescribed) -> (dycore,
    surface, chunk_diags)``: ``chunk_diags`` holds the last step's
    physics diagnostics, the chunk-accumulated TOTAL_PRECIP [m] and
    ``chunk_accumulated_{PRATEsfc,evaporation,RUNOFFsfc,DRAINsfc}``
    [kg/m^2] for those of the four the physics emits.
    """
    from fv3net_torch.core.quantity import Quantity
    from fv3net_torch.runtime import names
    from fv3net_torch.runtime.derived_state import (
        DIMS_2D,
        DIMS_3D,
        DerivedState,
        ModelState,
    )
    from fv3net_torch.runtime.steppers.machine_learning import add_tendency
    from fv3net_torch.runtime.surface_step import (
        physics_with_surface,
        surface_coupling_factors,
    )

    if getattr(ml_stepper, "diagnostic_only", False):
        raise ValueError(
            "a diagnostic-only ML stepper records its predictions without "
            "applying them; it runs on the TimeLoop's per-step path only"
        )
    for kind in prephysics_kinds:
        if kind not in ("set", "tend"):
            raise ValueError(f"prephysics kind must be 'set' or 'tend'; "
                             f"got {kind!r}")
    validate_acoustic_cfl(g, dyn_cfg)
    band_radiation = _build_radiation_fn(phys_cfg, g.lat.device,
                                         g.lat.dtype, impl)
    gfdl_mode = phys_cfg.microphysics_scheme == "gfdl"
    dt = dyn_cfg.dt

    def derived(s, sfc):
        return DerivedState(ModelState(dycore=s, surface=sfc), g,
                            ptop=dyn_cfg.ptop)

    def compute_radiation_cache(s: DycoreState, surface, cos_zenith):
        """One band-radiation call with the current surface state (ice
        and snow albedo, land mask), as physics_step would make it."""
        T, delp, q, qc, o3 = _rad_inputs_full(s, dyn_cfg, gfdl_mode)
        _, ice_frac = surface_coupling_factors(surface, nml)
        return band_radiation(
            T, delp, q, qc, surface[names.TSFC], cos_zenith, g.lat,
            o3=o3, land=surface.get(names.MASK), ice=ice_frac,
        )

    def apply_prescribed(s: DycoreState, surface, updates, kind: str):
        """One prephysics stepper's updates for this step."""
        st = derived(s, dict(surface))
        if kind == "set":
            for key, value in updates.items():
                st[key] = value
        else:
            add_tendency(st, {
                k: Quantity(v, DIMS_3D if v.ndim == 4 else DIMS_2D)
                for k, v in updates.items()
            }, dt)
        return st.state.dycore, st.state.surface

    @torch.no_grad()
    def production(dycore: DycoreState, surface, cos_zenith, prescribed):
        surface = dict(surface)
        cache = None
        precip_acc = torch.zeros_like(surface[names.TSFC])
        water_acc = None
        raw = None
        for i in range(n_steps):
            with record_function("prephysics"):
                for kind, upd in zip(prephysics_kinds, prescribed):
                    dycore, surface = apply_prescribed(
                        dycore, surface, {k: v[i] for k, v in upd.items()},
                        kind)
            with record_function("dynamics"):
                dycore = dynamics_step(dycore, g, ak, bk, dyn_cfg, impl=impl)
            radiation_fn = None  # the gray scheme, computed in the step
            if band_radiation is not None:
                if i % radiation_interval == 0:
                    with record_function("radiation"):
                        cache = compute_radiation_cache(dycore, surface,
                                                        cos_zenith)
                radiation_fn = (
                    lambda *_a, cached=cache, **_k: cached)
            with record_function("physics"):
                dycore, surface, raw = physics_with_surface(
                    dycore, surface, cos_zenith, g.lat, dt, nml, phys_cfg,
                    radiation_fn=radiation_fn,
                )
            if ml_stepper is not None:
                with record_function("ml"):
                    st = derived(dycore, surface)
                    apply_stepper_in_graph(ml_stepper, st, dt,
                                           track_precip=True)
                    dycore, surface = st.state.dycore, st.state.surface
            precip_acc = precip_acc + surface[names.TOTAL_PRECIP]
            if water_acc is None:
                # chunk-accumulated surface water fluxes [kg/m^2], so the
                # land water ledger (dW rho = (P - E - R) dt) is auditable
                water_acc = {
                    k: torch.zeros_like(raw[k])
                    for k in ("PRATEsfc", "evaporation", "RUNOFFsfc",
                              "DRAINsfc") if k in raw
                }
            water_acc = {k: v + raw[k] * dt for k, v in water_acc.items()}
        diags = dict(raw)
        diags[names.TOTAL_PRECIP] = precip_acc
        for k, v in water_acc.items():
            diags[f"chunk_accumulated_{k}"] = v
        return dycore, surface, diags

    return production
