"""The port's flagship slice held against the reference: the dense model
carried over by ``params_from_jax``, a 2-step gray chunk with the ML
correction (C12, npz=16, f64), a 2-step RRTMG chunk (C8, npz=16, f64),
the port's entry point, and the rule that the port never loads jax."""
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import assert_states_close, jax_state, make_state_numpy

from fv3net_torch import entry
from fv3net_torch.dycore.core import GridArrays
from fv3net_torch.dycore.state import state_from_numpy
from fv3net_torch.fit.dense import params_from_jax
from fv3net_torch.ops import remap_cuda
from fv3net_torch.physics import PhysicsConfig
from fv3net_torch.runtime import fused

jax.config.update("jax_enable_x64", True)

NPX, NPZ = 12, 16
# two f64 steps: roundoff-level differences, grown through the step
CHUNK_RTOL = 1e-8


@functools.lru_cache(maxsize=None)
def _jax_model():
    """A reference DenseModel trained as ``__graft_entry__._flagship``
    trains it (same batch recipe and hyperparameters), at f64."""
    from fv3net_tpu.core.dataset import Dataset
    from fv3net_tpu.core.quantity import Quantity
    from fv3net_tpu.fit.dense import DenseHyperparameters, train_dense_model

    rng = np.random.RandomState(0)
    n = 256

    def q(x):
        return Quantity(jnp.asarray(x, jnp.float64), ("sample", "z"))

    batch = Dataset({
        "air_temperature": q(260 + 30 * rng.rand(n, NPZ)),
        "specific_humidity": q(0.01 * rng.rand(n, NPZ)),
        "dQ1": q(1e-5 * rng.randn(n, NPZ)),
        "dQ2": q(1e-8 * rng.randn(n, NPZ)),
    })
    hp = DenseHyperparameters(
        input_variables=["air_temperature", "specific_humidity"],
        output_variables=["dQ1", "dQ2"],
        hidden_layers=2, width=128, epochs=1,
    )
    return train_dense_model(hp, [batch])


def test_params_from_jax_matches_reference():
    model = _jax_model()
    port = params_from_jax(model)
    rng = np.random.RandomState(1)
    X = np.concatenate(
        [260 + 30 * rng.rand(64, NPZ), 0.01 * rng.rand(64, NPZ)], axis=1
    )
    want = np.asarray(model.apply_packed(model.params, jnp.asarray(X)))
    got = port.apply_packed(torch.tensor(X)).detach().numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert port.input_info.names == ["air_temperature", "specific_humidity"]
    assert port.output_info.features == [NPZ, NPZ]


@pytest.mark.parametrize("chunk", [None, 2])
def test_fused_chunk_matches_reference(chunk):
    """A 2-step gray chunk (radiation every 4th step, so step 2 reuses the
    cache) or a single fused step, with the dense correction, from one
    convecting numpy state."""
    from fv3net_tpu.dycore.core import GridArrays as JGridArrays
    from fv3net_tpu.grid.geometry import make_grid as jmake_grid
    from fv3net_tpu.physics import PhysicsConfig as JPhysicsConfig
    from fv3net_tpu.runtime import fused as jfused
    from fv3net_tpu.dycore.core import DycoreConfig as JDycoreConfig

    st, grid, ak, bk = make_state_numpy(NPX, NPZ, seed=3, moist=True)
    sst = 300.15 - 30.0 * np.sin(grid.lat) ** 2
    cosz = np.cos(grid.lat) * np.cos(grid.lon)
    model = _jax_model()

    jg = JGridArrays.from_grid(jmake_grid(NPX), dtype=jnp.float64)
    j_apply, j_params = jfused.ml_correction_fn(model)
    j_args = (jg, jnp.asarray(ak), jnp.asarray(bk),
              JDycoreConfig(**vars(entry.FLAGSHIP_DYCORE)), JPhysicsConfig(),
              j_apply)
    j_step = (
        jfused.build_fused_multi_step(*j_args, n_steps=chunk,
                                      radiation_interval=4)
        if chunk else jfused.build_fused_step(*j_args)
    )
    want = j_step(jax_state(st, jnp.float64), j_params, jnp.asarray(sst),
                  jnp.asarray(cosz))

    g = GridArrays.from_grid(grid, dtype=torch.float64)
    t_apply, t_params = fused.ml_correction_fn(params_from_jax(model))
    t_args = (g, torch.tensor(ak), torch.tensor(bk), entry.FLAGSHIP_DYCORE,
              PhysicsConfig(), t_apply)
    t_step = (
        fused.build_fused_multi_step(*t_args, n_steps=chunk,
                                     radiation_interval=4)
        if chunk else fused.build_fused_step(*t_args)
    )
    got = t_step(state_from_numpy(st), t_params, torch.tensor(sst),
                 torch.tensor(cosz))
    assert_states_close(got, want, CHUNK_RTOL)


def _air_mass(state, g):
    return float((state.delp.sum(dim=1) * g.area).sum())


@pytest.mark.parametrize("chunk", [None, 2])
def test_entry_flagship_runs_on_cpu(chunk):
    """The port's entry point end to end on the CPU (plain remap): finite
    fields of the input shapes, global air mass conserved, and no kernel
    launch."""
    step, (state, ml_params, sst, cosz) = entry.flagship(
        npx=6, npz=NPZ, chunk=chunk, dtype=torch.float64, device="cpu"
    )
    g = GridArrays.from_grid(entry.make_grid(6), torch.float64)
    before = remap_cuda.LAUNCHES
    out = step(state, ml_params, sst, cosz)
    assert remap_cuda.LAUNCHES == before
    for name, x in [("delp", out.delp), ("pt", out.pt), ("wind", out.wind),
                    *out.tracers.items()]:
        ref = getattr(state, name, None)
        ref = state.tracers[name] if ref is None else ref
        assert x.shape == ref.shape and torch.isfinite(x).all(), name
    m0, m1 = _air_mass(state, g), _air_mass(out, g)
    assert abs(m1 - m0) <= 1e-12 * m0


def test_rrtmg_chunk_matches_reference(monkeypatch):
    """A 2-step chunk with RRTMG at every step (radiation_interval=1) and
    the dense correction, C8, npz=16, float64 throughout: both drivers
    compute in float64 (the port's in the state's dtype, the reference's
    by its ``dtype`` argument) and the port samples the reference's McICA
    draws."""
    from test_torch_rrtmg import jax_mcica_draws

    from fv3net_tpu.dycore.core import DycoreConfig as JDycoreConfig
    from fv3net_tpu.dycore.core import GridArrays as JGridArrays
    from fv3net_tpu.grid.geometry import make_grid as jmake_grid
    from fv3net_tpu.physics import PhysicsConfig as JPhysicsConfig
    from fv3net_tpu.physics.radiation.rrtmg import driver as jdrv
    from fv3net_tpu.runtime import fused as jfused

    from fv3net_torch.physics.radiation.rrtmg import driver as tdrv

    npx = 8
    st, grid, ak, bk = make_state_numpy(npx, NPZ, seed=3, moist=True)
    st["tracers"]["cloud_water"] *= 10.0  # clouds in most columns
    sst = 300.15 - 30.0 * np.sin(grid.lat) ** 2
    cosz = np.cos(grid.lat) * np.cos(grid.lon)
    model = _jax_model()

    monkeypatch.setattr(jdrv, "RRTMGDriver", functools.partial(
        jdrv.RRTMGDriver, dtype=jnp.float64))
    jg = JGridArrays.from_grid(jmake_grid(npx), dtype=jnp.float64)
    j_apply, j_params = jfused.ml_correction_fn(model)
    j_step = jfused.build_fused_multi_step(
        jg, jnp.asarray(ak), jnp.asarray(bk),
        JDycoreConfig(**vars(entry.FLAGSHIP_DYCORE)),
        JPhysicsConfig(radiation_scheme="rrtmg"), j_apply, n_steps=2,
        radiation_interval=1,
    )
    want = j_step(jax_state(st, jnp.float64), j_params, jnp.asarray(sst),
                  jnp.asarray(cosz))

    monkeypatch.setattr(tdrv.RRTMGDriver, "draw_mcica",
                        jax_mcica_draws(torch.float64))
    g = GridArrays.from_grid(grid, dtype=torch.float64)
    t_apply, t_params = fused.ml_correction_fn(params_from_jax(model))
    t_step = fused.build_fused_multi_step(
        g, torch.tensor(ak), torch.tensor(bk), entry.FLAGSHIP_DYCORE,
        PhysicsConfig(radiation_scheme="rrtmg"), t_apply, n_steps=2,
        radiation_interval=1,
    )
    got = t_step(state_from_numpy(st), t_params, torch.tensor(sst),
                 torch.tensor(cosz))
    assert_states_close(got, want, CHUNK_RTOL)


@pytest.mark.parametrize("radiation", ["rrtmg", "gray"])
def test_entry_flagship_radiation_runs_on_cpu(radiation):
    """``flagship(radiation=...)`` as a 2-step float64 chunk on the CPU:
    finite fields, conserved air mass, and no kernel launch."""
    from fv3net_torch.ops import ktable_cuda

    step, (state, ml_params, sst, cosz) = entry.flagship(
        npx=4, npz=8, radiation=radiation, chunk=2, dtype=torch.float64,
        device="cpu",
    )
    launches = (remap_cuda.LAUNCHES, ktable_cuda.SELECT_LAUNCHES,
                ktable_cuda.SPEC_LAUNCHES)
    out = step(state, ml_params, sst, cosz)
    assert launches == (remap_cuda.LAUNCHES, ktable_cuda.SELECT_LAUNCHES,
                        ktable_cuda.SPEC_LAUNCHES)
    for x in [out.delp, out.pt, out.wind, *out.tracers.values()]:
        assert torch.isfinite(x).all()
    g = GridArrays.from_grid(entry.make_grid(4), torch.float64)
    m0, m1 = _air_mass(state, g), _air_mass(out, g)
    assert abs(m1 - m0) <= 1e-12 * m0
    assert not torch.equal(out.pt, state.pt)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import pkgutil, sys, fv3net_torch\n"
        "import fv3net_torch.entry\n"
        "import fv3net_torch.ops.ktable, fv3net_torch.ops.ktable_cuda\n"
        "import fv3net_torch.physics.radiation.rrtmg.driver\n"
        "import fv3net_torch.physics.radiation.rrtmg.lw\n"
        "import fv3net_torch.physics.radiation.rrtmg.sw\n"
        "from fv3net_torch.entry import production\n"
        "import fv3net_torch.runtime.steppers.machine_learning\n"
        "import fv3net_torch.runtime.segmented_run.api\n"
        "import fv3net_torch.runtime.segmented_run.cli\n"
        "import fv3net_torch.runtime.loop\n"
        "import fv3net_torch.emulation, fv3net_torch.physics.held_suarez\n"
        "import fv3net_torch.physics.radiation.gfs_driver\n"
        "import fv3net_torch.runtime.steppers.radiation\n"
        "import fv3net_torch.runtime.steppers.reservoir\n"
        "import fv3net_torch.runtime.steppers.nudging\n"
        "import fv3net_torch.fit.reservoir\n"
        "for m in pkgutil.walk_packages(fv3net_torch.__path__, 'fv3net_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'fv3net_tpu'))\n"
        "assert not bad, bad\n"
        "for name in ('core.zarrio', 'ops.coarsen', 'ops.coarsen_cuda',\n"
        "             'pipelines.coarsen_diagnostics',\n"
        "             'physics.radiation.rrtmg.taumol_cuda',\n"
        "             'runtime.names', 'runtime.config',\n"
        "             'physics.slab_ocean', 'physics.sea_ice',\n"
        "             'physics.land', 'physics.soil',\n"
        "             'physics.gravity_wave_drag', 'runtime.surface_step',\n"
        "             'runtime.derived_state', 'runtime.tendency',\n"
        "             'runtime.diagnostics.compute',\n"
        "             'runtime.steppers.machine_learning',\n"
        "             'runtime.loop', 'runtime.checkpoint',\n"
        "             'runtime.diagnostics.manager', 'runtime.metrics',\n"
        "             'runtime.segmented_run.api',\n"
        "             'runtime.segmented_run.cli', 'fit.io',\n"
        "             'core.netcdfio', 'loaders.batches',\n"
        "             'physics.radiation.rrtmg.io', 'dycore.testcases',\n"
        "             'dycore.nonhydro', 'physics.microphysics_gfdl',\n"
        "             'physics.ozone', 'physics.h2ophys',\n"
        "             'emulation', 'emulation.hooks', 'emulation.transforms',\n"
        "             'physics.radiation.params', 'physics.radiation.spectra',\n"
        "             'physics.radiation.optics', 'physics.radiation.lw',\n"
        "             'physics.radiation.sw', 'physics.radiation.driver',\n"
        "             'physics.radiation.wrapper',\n"
        "             'physics.radiation.gfs_driver',\n"
        "             'physics.held_suarez', 'runtime.steppers.radiation',\n"
        "             'runtime.factories', 'fit.config', 'fit.networks',\n"
        "             'fit.train', 'fit.dense', 'parallel.sharded',\n"
        "             'parallel.shardmap_halo', 'core.sharded_io',\n"
        "             'ops.limit', 'runtime.steppers.tendency_prescriber',\n"
        "             'runtime.steppers.combine', 'runtime.steppers.nudging',\n"
        "             'runtime.steppers.reservoir', 'fit.predictor',\n"
        "             'fit.domain', 'fit.reservoir',\n"
        "             'ops.regridz', 'ops.regrid_latlon', 'ops.spherical',\n"
        "             'ops.statistics', 'ops.winds', 'ops.vertical_flux',\n"
        "             'grid.cross', 'pipelines.coarsen_restarts',\n"
        "             'pipelines.fine_res_budget', 'pipelines.runner',\n"
        "             'pipelines.coarsen_surface',\n"
        "             'pipelines.diagnostics_to_zarr',\n"
        "             'pipelines.restarts_to_zarr', 'post_process',\n"
        "             'post_process_cli'):\n"
        "    assert 'fv3net_torch.' + name in sys.modules, name\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
