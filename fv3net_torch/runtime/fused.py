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
                        impl: str = None,
                        lw_taumol: str = "ktable") -> Optional[Callable]:
    """The band-solver closure handed to physics_step: the RRTMG driver
    for scheme "rrtmg", None for "gray" (which physics_step computes).

    The driver computes in ``dtype``, the state's (the reference's
    driver computes in float32 whatever the state's dtype), at solar
    constant 1368.22 * ``solcon_scale``.  ``lw_taumol`` is its route
    of the LW gas optics."""
    if phys_cfg.radiation_scheme == "gray":
        return None
    if phys_cfg.radiation_scheme != "rrtmg":
        raise NotImplementedError(
            f"radiation_scheme={phys_cfg.radiation_scheme!r} is not ported "
            "to fv3net_torch yet (gray and rrtmg are)"
        )
    from fv3net_torch.physics.radiation.rrtmg.driver import (
        RRTMGConfig,
        RRTMGDriver,
    )

    driver = RRTMGDriver(
        RRTMGConfig(solcon=1368.22 * phys_cfg.solcon_scale),
        dtype=dtype, device=device, impl=impl, lw_taumol=lw_taumol,
    )
    epoch = datetime.datetime(2016, 7, 1)  # isol=0: the date seeds o3 only

    def radiation_fn(T, delp, q, qc, t_surface, cos_zenith, lat):
        out = driver(epoch, {
            "air_temperature": T,
            "pressure_thickness_of_atmospheric_layer": delp,
            "specific_humidity": q,
            "cloud_water_mixing_ratio": qc,
            "surface_temperature": t_surface,
            "latitude": lat,
            "longitude": torch.zeros_like(lat),
        }, cosz=cos_zenith)
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
):
    """Returns step(state, ml_params, t_surface, cos_zenith) -> state."""
    validate_acoustic_cfl(g, dyn_cfg)
    radiation_fn = _build_radiation_fn(phys_cfg, g.lat.device, g.lat.dtype,
                                       impl, lw_taumol)

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
):
    """``n_steps`` model steps, computing radiation only every
    ``radiation_interval`` steps (always at step 0) and reusing the
    stored heating rates and fluxes in between (for rrtmg the heating
    plus the four flux diagnostics ULWRFtoa, USWRFtoa, DSWRFsfc,
    DLWRFsfc).  ``lw_taumol`` routes RRTMG's LW gas optics ("ktable" or
    "mega").  Each step's parts run under the profiler ranges
    "dynamics", "radiation", "physics" and "ml".

    Returns fn(state, ml_params, t_surface, cos_zenith) -> state.
    """
    validate_acoustic_cfl(g, dyn_cfg)
    band_radiation = _build_radiation_fn(phys_cfg, g.lat.device,
                                         g.lat.dtype, impl, lw_taumol)

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
        return band_radiation(T, delp, q, qc, t_surface, cos_zenith, g.lat)

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
