"""Entry points of the port: the flagship C48 hybrid chunk with RRTMG
radiation (counterpart of ``__graft_entry__._flagship``) and the
production chunk around it (the reference entry's production
configuration, ``__graft_entry__.py:293-408``).

    step, (state, ml_params, sst, cosz) = flagship(device="cuda")
    state = step(state, ml_params, sst, cosz)   # one 8-step chunk

    chunk, (dycore, surface, cosz, prescribed) = production(device="cuda")
    dycore, surface, diags = chunk(dycore, surface, cosz, prescribed)
"""
from __future__ import annotations

import numpy as np
import torch

from fv3net_torch.dycore.core import DycoreConfig, GridArrays
from fv3net_torch.dycore.state import init_state
from fv3net_torch.fit.dense import DenseModel, init_mlp_params
from fv3net_torch.fit.normalize import StandardScaler
from fv3net_torch.fit.packer import PackingInfo
from fv3net_torch.grid.geometry import make_grid
from fv3net_torch.physics.driver import PhysicsConfig
from fv3net_torch.runtime.fused import (
    aquaplanet_sst,
    build_fused_multi_step,
    build_fused_step,
    ml_correction_fn,
)

#: the flagship dynamics configuration (hydrostatic PPM, kord=9, remap_te)
FLAGSHIP_DYCORE = DycoreConfig(
    dt=900.0, n_split=2, kord=9, advection_order=4, diff_coef=0.004,
    divergence_damp_coef=0.06, remap_te=True,
)


#: the production chunk's dynamics (the reference entry's ``prod_dyn``:
#: hydrostatic PPM, kord=9, without the energy-conserving remap)
PRODUCTION_DYCORE = DycoreConfig(
    dt=900.0, n_split=2, kord=9, advection_order=4, diff_coef=0.004,
    divergence_damp_coef=0.06,
)


def flagship_dense_model(npz: int, dtype=torch.float32, device=None,
                         seed: int = 0, hidden=(128, 128), n: int = 256,
                         dq_scale=(1e-5, 1e-8)) -> DenseModel:
    """The flagship's dQ1/dQ2 dense model: scalers from the reference
    entry's numpy sample batch (``n`` samples, tendencies of the scales
    ``dq_scale``), untrained He-normal weights of ``hidden`` widths from
    a ``torch.Generator`` seeded with ``seed``."""
    rng = np.random.RandomState(seed)
    T = 260 + 30 * rng.rand(n, npz)
    q = 0.01 * rng.rand(n, npz)
    dQ1 = dq_scale[0] * rng.randn(n, npz)
    dQ2 = dq_scale[1] * rng.randn(n, npz)

    def scaler(X):
        return StandardScaler.fit(torch.tensor(X, dtype=dtype, device=device))

    names_in = ["air_temperature", "specific_humidity"]
    names_out = ["dQ1", "dQ2"]
    sizes = [2 * npz, *hidden, 2 * npz]
    generator = torch.Generator().manual_seed(seed)
    return DenseModel(
        input_variables=names_in,
        output_variables=names_out,
        params=init_mlp_params(generator, sizes, dtype=dtype, device=device),
        input_info=PackingInfo(names_in, [npz, npz]),
        output_info=PackingInfo(names_out, [npz, npz]),
        x_scaler=scaler(np.concatenate([T, q], axis=1)),
        y_scaler=scaler(np.concatenate([dQ1, dQ2], axis=1)),
    )


def flagship(npx: int = 48, npz: int = 32, radiation: str = "rrtmg",
             chunk: int = 8, radiation_interval: int = 4,
             dtype=torch.float32, device="cuda", seed: int = 0,
             impl: str = None, lw_taumol: str = "ktable"):
    """The flagship hybrid configuration: PPM dynamics, GFS-style column
    physics with RRTMG LW+SW (or ``radiation="gray"``) every
    ``radiation_interval`` steps, and the in-step dense ML correction.

    ``chunk=None`` returns a single step; ``chunk=N`` the N-step chunk.
    Returns ``(step, (state, ml_params, sst, cosz))``.  ``impl`` selects
    the kernels' versions, the vertical remap and the k-table selections
    (None: the CUDA kernels on a CUDA device).  RRTMG computes in
    ``dtype``; ``lw_taumol`` routes its LW gas optics: "ktable" through
    the k-table selections, "mega" through the one-launch kernel.
    """
    grid = make_grid(npx)
    g = GridArrays.from_grid(grid, dtype=dtype, device=device)
    state, ak, bk = init_state(grid, npz, dtype=dtype, device=device)
    phys_cfg = PhysicsConfig(radiation_scheme=radiation)

    ml_apply, ml_params = ml_correction_fn(
        flagship_dense_model(npz, dtype, device, seed)
    )

    akt = torch.tensor(ak, dtype=dtype, device=device)
    bkt = torch.tensor(bk, dtype=dtype, device=device)
    if chunk:
        step = build_fused_multi_step(
            g, akt, bkt, FLAGSHIP_DYCORE, phys_cfg, ml_apply,
            n_steps=chunk, radiation_interval=radiation_interval, impl=impl,
            lw_taumol=lw_taumol,
        )
    else:
        step = build_fused_step(g, akt, bkt, FLAGSHIP_DYCORE, phys_cfg,
                                ml_apply, impl=impl, lw_taumol=lw_taumol)
    sst = aquaplanet_sst(g.lat)
    cosz = torch.tensor(np.cos(grid.lat) * np.cos(grid.lon), dtype=dtype,
                        device=device)
    return step, (state, ml_params, sst, cosz)


def production(npx: int = 48, npz: int = 32, radiation: str = "rrtmg",
               chunk: int = 8, radiation_interval: int = 4,
               land_model: str = "", land_mask=None, sgh=None,
               model: DenseModel = None, dtype=torch.float32,
               device="cuda", seed: int = 0, impl: str = None):
    """The reference entry's production configuration: the namelist's
    RRTMG (or ``radiation="gray"``), slab ocean and sea ice, hydrostatic;
    the dynamics of :data:`PRODUCTION_DYCORE`; radiation every
    ``radiation_interval`` steps; an aquaplanet SST that one "set"
    prephysics stepper resets every step; and a dense
    :class:`~fv3net_torch.runtime.steppers.machine_learning.PureMLStepper`
    (1 hidden layer of 16).  The port has no trainer yet, so the dense
    model's weights are untrained, drawn from ``seed`` (scalers from the
    reference entry's sample batch), as :func:`flagship_dense_model`
    draws the flagship's; ``model`` takes another (for example one
    trained by the reference package, carried over by
    :func:`~fv3net_torch.fit.dense.params_from_jax`).

    The land variant: ``land_model`` ("bucket" or "noah"), a ``land_mask``
    [6, npx, npx] (1 on land; default all ocean) and ``sgh`` [6, npx,
    npx], the subgrid orography's standard deviation in m (default none:
    no gravity-wave drag), both numpy arrays; the land fields start as
    the reference's TimeLoop starts them.

    Returns ``(chunk, (dycore, surface, cosz, prescribed))``, with
    ``chunk(dycore, surface, cosz, prescribed) -> (dycore, surface,
    diags)`` the ``chunk``-step production chunk.  ``impl`` selects the
    kernels' versions (None: the CUDA kernels on a CUDA device).
    """
    from fv3net_torch.physics.land import BucketLandParams
    from fv3net_torch.physics.soil import SoilParams
    from fv3net_torch.runtime import names
    from fv3net_torch.runtime.config import NamelistConfig
    from fv3net_torch.runtime.fused import build_fused_production_chunk
    from fv3net_torch.runtime.steppers.machine_learning import PureMLStepper

    nml = NamelistConfig(
        npx=npx, npz=npz, dt_atmos=PRODUCTION_DYCORE.dt,
        n_split=PRODUCTION_DYCORE.n_split, radiation=radiation,
        slab_ocean=True, sea_ice=True, hydrostatic=True,
        land_model=land_model,
    )
    grid = make_grid(npx)
    g = GridArrays.from_grid(grid, dtype=dtype, device=device)
    dycore, ak, bk = init_state(grid, npz, dtype=dtype, device=device)
    if model is None:
        model = flagship_dense_model(npz, dtype, device, seed, hidden=(16,),
                                     n=64, dq_scale=(1e-6, 1e-9))
    step = build_fused_production_chunk(
        g, torch.tensor(ak, dtype=dtype, device=device),
        torch.tensor(bk, dtype=dtype, device=device), PRODUCTION_DYCORE,
        PhysicsConfig(radiation_scheme=radiation), nml,
        ml_stepper=PureMLStepper(model, timestep=PRODUCTION_DYCORE.dt),
        n_steps=chunk, radiation_interval=radiation_interval,
        prephysics_kinds=("set",), impl=impl,
    )

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    sst = aquaplanet_sst(g.lat)
    zeros = torch.zeros_like(sst)
    surface = {
        names.TSFC: sst,
        names.SST: sst.clone(),
        names.MASK: zeros if land_mask is None else t(land_mask),
        "ice_thickness": zeros,
        names.TOTAL_PRECIP: zeros,
    }
    if sgh is not None:
        surface["sgh"] = t(sgh)
    if nml.bucket_land:
        p = BucketLandParams(field_capacity_m=nml.bucket_capacity_m)
        surface["soil_moisture"] = torch.full_like(
            sst, p.initial_fraction * p.field_capacity_m)
    if nml.land_model == "noah":
        nl = len(SoilParams().dz)
        surface["soil_temperature"] = sst.expand(nl, *sst.shape).clone()
        surface["soil_moisture_layers"] = torch.full(
            (nl, *sst.shape), 0.25, dtype=dtype, device=device)
        surface["snow_water_equivalent"] = zeros
        surface["deep_soil_temperature"] = torch.clamp(sst, 271.0, 300.0)
    prescribed = ({names.SST: sst.expand(chunk, *sst.shape).clone()},)
    cosz = t(np.cos(grid.lat) * np.cos(grid.lon))
    return step, (dycore, surface, cosz, prescribed)
