"""fv3net_torch's grid, halo, state and hydrostatic dynamics step held
against fv3net_tpu's on shared numpy inputs (JAX on the CPU, float64)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import assert_states_close, jax_state, make_state_numpy

from fv3net_torch.dycore import core as tc
from fv3net_torch.dycore.state import (
    add_nonhydrostatic_fields,
    state_from_numpy,
    state_to_numpy,
)
from fv3net_torch.grid.geometry import make_grid
from fv3net_torch.parallel.halo import halo_append, halo_append_numpy

jax.config.update("jax_enable_x64", True)

# one step at f64: the two packages differ only in summation order
STEP_RTOL = 1e-10
FLAGSHIP_KW = dict(
    dt=900.0, n_split=2, kord=9, advection_order=4, diff_coef=0.004,
    divergence_damp_coef=0.06, remap_te=True,
)


def test_geometry_copy_matches_reference():
    from fv3net_tpu.grid.geometry import make_grid as jmake_grid

    got, want = make_grid(6), jmake_grid(6)
    for f in dataclasses.fields(want):
        if f.name == "topology":
            assert got.topology.keys() == want.topology.keys()
            for k, m in want.topology.items():
                assert dataclasses.astuple(got.topology[k]) == dataclasses.astuple(m)
        else:
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name))


@pytest.mark.parametrize("h", [1, 3])
def test_halo_append_matches_numpy_and_reference(h):
    from fv3net_tpu.parallel.halo import halo_append as jhalo

    x = np.random.RandomState(h).randn(6, 2, 3, 8, 8)
    want = halo_append_numpy(x, h)
    got = halo_append(torch.tensor(x), h).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jhalo(jnp.asarray(x), h)))


def test_halo_append_rejects_non_cube():
    with pytest.raises(ValueError):
        halo_append(torch.zeros(6, 4, 5), 1)


def test_grid_arrays_match_reference_exactly():
    from fv3net_tpu.dycore.core import GridArrays as JGridArrays
    from fv3net_tpu.grid.geometry import make_grid as jmake_grid

    got = tc.GridArrays.from_grid(make_grid(8), dtype=torch.float64)
    want = JGridArrays.from_grid(jmake_grid(8), dtype=jnp.float64)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)


def test_init_state_matches_reference_exactly():
    from fv3net_tpu.dycore.state import init_state as jinit
    from fv3net_tpu.grid.geometry import make_grid as jmake_grid
    from fv3net_torch.dycore.state import init_state

    got, ak, bk = init_state(make_grid(6), 16, dtype=torch.float64,
                             perturbation=2.0)
    want, akj, bkj = jinit(jmake_grid(6), 16, dtype=jnp.float64,
                           perturbation=2.0)
    np.testing.assert_array_equal(ak, akj)
    np.testing.assert_array_equal(bk, bkj)
    assert_states_close(got, want, 0.0)
    # the numpy round trip is exact
    assert_states_close(state_from_numpy(state_to_numpy(got)), want, 0.0)


@pytest.mark.parametrize(
    "extra",
    [{}, dict(d2_bg_k1=0.12, d2_bg_k2=0.06, tau_rayleigh=5.0)],
    ids=["flagship", "sponge"],
)
def test_dynamics_step_matches_reference(extra):
    """One flagship dynamics step (C12, npz=16, f64) on a moving,
    perturbed state; the "sponge" case adds the d2_bg rows and the
    Rayleigh sponge of the production namelist."""
    from fv3net_tpu.dycore import core as jc
    from fv3net_tpu.grid.geometry import make_grid as jmake_grid

    st, grid, ak, bk = make_state_numpy(12, 16, seed=1)
    want = jc.dynamics_step(
        jax_state(st, jnp.float64),
        jc.GridArrays.from_grid(jmake_grid(12), dtype=jnp.float64),
        jnp.asarray(ak), jnp.asarray(bk),
        jc.DycoreConfig(**FLAGSHIP_KW, **extra),
    )
    got = tc.dynamics_step(
        state_from_numpy(st), tc.GridArrays.from_grid(grid, torch.float64),
        torch.tensor(ak), torch.tensor(bk),
        tc.DycoreConfig(**FLAGSHIP_KW, **extra),
    )
    assert_states_close(got, want, STEP_RTOL)


def test_unported_dycore_options_raise():
    """Every dycore option this test once held to a raise steps as the
    reference's does: advection order 2 (the reference's default
    DycoreConfig; tests/test_torch_dycore_options.py holds orders 1, 2
    and kord 7 against it) and the nonhydrostatic core, by its config
    and by a state with w and delz (tests/test_torch_nonhydro.py holds it
    over terrain).  What still raises is a nonhydrostatic step on a state
    without w and delz, and an advection order the reference lacks."""
    from fv3net_tpu.dycore import core as jc
    from fv3net_tpu.dycore.state import add_nonhydrostatic_fields as jadd
    from fv3net_tpu.grid.geometry import make_grid as jmake_grid

    st, grid, ak, bk = make_state_numpy(4, 8)
    g = tc.GridArrays.from_grid(grid, torch.float64)
    jg = jc.GridArrays.from_grid(jmake_grid(4), dtype=jnp.float64)
    args = (state_from_numpy(st), g, torch.tensor(ak), torch.tensor(bk))
    nh_kw = {**FLAGSHIP_KW, "hydrostatic": False}
    with pytest.raises(ValueError, match="w and delz"):
        tc.dynamics_step(*args, tc.DycoreConfig(**nh_kw))
    with pytest.raises(ValueError, match="advection_order"):
        tc.dynamics_step(*args, tc.DycoreConfig(**{**FLAGSHIP_KW,
                                                   "advection_order": 3}))
    kw = {**FLAGSHIP_KW, "advection_order": 2}
    want = jc.dynamics_step(
        jax_state(st, jnp.float64), jg,
        jnp.asarray(ak), jnp.asarray(bk), jc.DycoreConfig(**kw))
    assert_states_close(tc.dynamics_step(*args, tc.DycoreConfig(**kw)), want,
                        STEP_RTOL)
    nh = add_nonhydrostatic_fields(args[0])
    want = jc.dynamics_step(
        jadd(jax_state(st, jnp.float64)), jg, jnp.asarray(ak),
        jnp.asarray(bk), jc.DycoreConfig(**nh_kw))
    assert_states_close(tc.dynamics_step(nh, *args[1:],
                                         tc.DycoreConfig(**nh_kw)),
                        want, STEP_RTOL)
    w_state = state_from_numpy({**st, "w": np.zeros_like(st["delp"]),
                                "delz": np.ones_like(st["delp"])})
    assert torch.equal(w_state.w, torch.zeros_like(w_state.delp))
