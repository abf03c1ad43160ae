"""The FV3GFS-style namelist (nonhydrostatic core, GFDL microphysics,
prognostic ozone, stratospheric water) through fv3net_torch's segmented
run, held against fv3net_tpu's (float64, on the CPU): one segment of two
fused production chunks of 2 steps through each package's
``run_segment`` (slab ocean, sea ice, a dense ML model), its RESTART
read back in both formats, and the TimeLoop's setup of the namelist's
fields.  The radiation is the gray scheme: the reference's float64
TimeLoop builds its RRTMG driver in float32 and turns non-finite within
one chunk (a float64 driver would need patching in, and its compile
would double this file's time); ``test_torch_gfdl_physics.py`` holds
what the namelist hands a band radiation, and ``chip_smoke.py`` phase
19 runs the namelist with RRTMG on the card.

The reference's fused TimeLoop compiles its chunk; its run is shared by
a module-scoped fixture."""
import datetime
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_segmented_run import _jax_model, _same_surface
from torch_port_util import assert_states_close, make_state_numpy

from fv3net_torch.dycore.state import state_from_numpy
from fv3net_torch.physics.microphysics_gfdl import GFDL_TRACER_NAMES
from fv3net_torch.runtime import checkpoint, names
from fv3net_torch.runtime.config import get_config
from fv3net_torch.runtime.derived_state import ModelState
from fv3net_torch.runtime.segmented_run import api

jax.config.update("jax_enable_x64", True)

NPX, NPZ = 12, 8  # _jax_model's columns are NPZ = 8 levels
# float64, 4 steps of the namelist's chunk: roundoff grown through them,
# relative to each field's scale
RTOL = 1e-10
NAMELIST = {
    "npx": NPX, "npz": NPZ, "hydrostatic": False, "microphysics": "gfdl",
    "prognostic_ozone": True, "stratospheric_h2o": True,
    "slab_ocean": True, "sea_ice": True,
}
NAMELIST_FIELDS = ("o3mr",) + GFDL_TRACER_NAMES


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's ``run_segment`` of the namelist from one seeded
    moist restart (hydrostatic: the loops add w and delz)."""
    from fv3net_tpu import fit as jfit
    from fv3net_tpu.runtime.config import get_config as jget_config
    from fv3net_tpu.runtime.loop import TimeLoop as JTimeLoop
    from fv3net_tpu.runtime.segmented_run import api as japi

    d = tmp_path_factory.mktemp("namelist")
    jfit.dump(_jax_model(), str(d / "model"))
    st, grid, _, _ = make_state_numpy(NPX, NPZ, seed=7, moist=True)
    sfc = {names.TSFC: 300.15 - 30.0 * np.sin(grid.lat) ** 2}
    sfc[names.SST] = sfc[names.TSFC].copy()
    sfc[names.MASK] = np.zeros_like(sfc[names.TSFC])
    checkpoint.save_state(
        ModelState(dycore=state_from_numpy(st),
                   surface={k: torch.tensor(v) for k, v in sfc.items()}),
        datetime.datetime(2016, 8, 1), str(d / "ic"))
    cfg = {
        "namelist": NAMELIST,
        "duration_seconds": 3600.0,
        "fused_chunk_steps": 2,
        "initial_conditions": str(d / "ic"),
        "scikit_learn": {"model": [str(d / "model")]},
    }
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi, "TimeLoop",
                   functools.partial(JTimeLoop, dtype=jnp.float64))
        jl = japi.run_segment(jget_config(cfg), str(d / "jax"))
    tl = api.run_segment(get_config(cfg), str(d / "torch"), device="cpu",
                         dtype=torch.float64)
    return jl, tl, d


def test_namelist_segment_matches_reference(runs):
    """Two fused production chunks of the namelist: the end state (w,
    delz, o3mr and the GFDL tracers among its fields) and the surface."""
    jl, tl, _ = runs
    assert jl.fusable() and tl.fusable() and tl._production_features()
    assert jl.time == tl.time == datetime.datetime(2016, 8, 1, 1)
    diffs = assert_states_close(tl.state.dycore, jl.state.dycore, RTOL)
    assert {"w", "delz", *NAMELIST_FIELDS} <= set(diffs)
    _same_surface(tl.state.surface, jl.state.surface, RTOL)
    assert (tl.state.dycore.delz > 0).all()
    assert float(tl.state.dycore.w.abs().max()) > 0


def test_namelist_restart_round_trips(runs):
    """The segment's RESTART holds the namelist's fields: the npz restart
    the loop's state bit for bit, and the Fortran files (float32, as the
    reference writes them) w, delz, o3mr and the GFDL tracers rounded to
    float32 and nothing more; the reference reads the port's npz restart
    as its own."""
    from fv3net_tpu.runtime.checkpoint import load_state as jload_state

    jl, tl, d = runs
    restart = str(d / "torch" / "RESTART")
    state, t = checkpoint.load_state(restart)
    assert t == tl.time
    a, b = checkpoint._state_arrays(state), checkpoint._state_arrays(tl.state)
    assert set(a) == set(b) and {"w", "delz"} <= set(a)
    for k in b:
        assert torch.equal(a[k], b[k]), k
    fortran = checkpoint.load_fortran_restarts(restart)[0].dycore
    want = tl.state.dycore
    assert torch.equal(fortran.w, want.w.float())
    assert torch.equal(fortran.delz, want.delz.float())
    for k in NAMELIST_FIELDS:
        assert torch.equal(fortran.tracers[k], want.tracers[k].float()), k
    got, _ = jload_state(restart)
    assert_states_close(got.dycore, jl.state.dycore, RTOL)


def test_namelist_loop_sets_up_its_fields(runs):
    """A loop of the namelist starts with the reference's ozone profile,
    zero GFDL condensates and w = 0 with hydrostatic delz; from a restart
    that carries w it keeps the restart's w."""
    from fv3net_tpu.runtime.config import get_config as jget_config
    from fv3net_tpu.runtime.loop import TimeLoop as JTimeLoop
    from fv3net_torch.runtime.loop import TimeLoop

    _, tl, d = runs
    cfg = {"namelist": NAMELIST, "duration_seconds": 0.0}
    jloop = JTimeLoop(jget_config(cfg), dtype=jnp.float64)
    loop = TimeLoop(get_config(cfg), dtype=torch.float64, device="cpu")
    assert_states_close(loop.state.dycore, jloop.state.dycore, 1e-14)
    assert torch.equal(loop.state.dycore.w,
                       torch.zeros_like(loop.state.dycore.delp))
    for k in GFDL_TRACER_NAMES:
        assert not loop.state.dycore.tracers[k].any(), k
    again = TimeLoop(get_config(dict(
        cfg, initial_conditions=str(d / "torch" / "RESTART"))),
        dtype=torch.float64, device="cpu")
    assert torch.equal(again.state.dycore.w, tl.state.dycore.w)
    assert os.path.exists(d / "torch" / "RESTART" / "fv_core.res.tile1.nc")
