"""Entry point of the port: the flagship C48 hybrid chunk with RRTMG
radiation (counterpart of ``__graft_entry__._flagship``).

    step, (state, ml_params, sst, cosz) = flagship(device="cuda")
    state = step(state, ml_params, sst, cosz)   # one 8-step chunk
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


def flagship_dense_model(npz: int, dtype=torch.float32, device=None,
                         seed: int = 0) -> DenseModel:
    """The flagship's dQ1/dQ2 dense model: scalers from the reference
    entry's numpy sample batch, untrained He-normal weights from a
    ``torch.Generator`` seeded with ``seed``."""
    rng = np.random.RandomState(seed)
    n = 256
    T = 260 + 30 * rng.rand(n, npz)
    q = 0.01 * rng.rand(n, npz)
    dQ1 = 1e-5 * rng.randn(n, npz)
    dQ2 = 1e-8 * rng.randn(n, npz)

    def scaler(X):
        return StandardScaler.fit(torch.tensor(X, dtype=dtype, device=device))

    names_in = ["air_temperature", "specific_humidity"]
    names_out = ["dQ1", "dQ2"]
    sizes = [2 * npz, 128, 128, 2 * npz]  # 2 hidden layers of 128
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
