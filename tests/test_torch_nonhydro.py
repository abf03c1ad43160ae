"""fv3net_torch's nonhydrostatic core (``dycore/nonhydro.py``, the
nonhydrostatic branches of ``dycore/core.py`` and
``state.add_nonhydrostatic_fields``) held against fv3net_tpu's on shared
numpy inputs (JAX on the CPU, float64), and the acoustic CFL check's
decision against the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (
    assert_states_close,
    jax_state,
    make_state_numpy,
    rel_diff,
)

from fv3net_torch.dycore import core as tc
from fv3net_torch.dycore import nonhydro as tn
from fv3net_torch.dycore.state import (
    add_nonhydrostatic_fields,
    state_from_numpy,
    state_to_numpy,
)

jax.config.update("jax_enable_x64", True)

# float64, the same operations: the solve's elimination and the sums
# differ from the reference's in order only
RTOL = 1e-12
NH_KW = dict(
    dt=900.0, n_split=3, kord=9, advection_order=4, diff_coef=0.004,
    divergence_damp_coef=0.06, remap_te=True, hydrostatic=False,
)


def _nh_state(npx=8, npz=12, seed=0):
    """A moving numpy state with terrain, w and a perturbed delz."""
    from fv3net_tpu.dycore import nonhydro as jn

    st, grid, ak, bk = make_state_numpy(npx, npz, seed=seed)
    rng = np.random.RandomState(seed + 1)
    st["phis"] = 9.8 * 400.0 * np.exp(
        -((grid.lon - 1.0) ** 2 + (grid.lat - 0.3) ** 2) / 0.1)
    dz = np.asarray(jn.hydrostatic_delz(jnp.asarray(st["delp"]),
                                        jnp.asarray(st["pt"]), 300.0))
    st["delz"] = dz * (1.0 + 1e-3 * rng.randn(*dz.shape))
    st["w"] = 0.05 * rng.randn(*dz.shape)
    return st, grid, ak, bk


def test_hydrostatic_delz_and_full_pressure_match_reference():
    from fv3net_tpu.dycore import nonhydro as jn

    st, _, _, _ = _nh_state()
    want = np.asarray(jn.hydrostatic_delz(jnp.asarray(st["delp"]),
                                          jnp.asarray(st["pt"]), 300.0))
    got = tn.hydrostatic_delz(torch.tensor(st["delp"]),
                              torch.tensor(st["pt"]), 300.0)
    assert rel_diff(got, want) <= RTOL
    want_p = jn.full_pressure(*(jnp.asarray(st[k])
                                for k in ("delp", "pt", "delz")))
    got_p = tn.full_pressure(*(torch.tensor(st[k])
                               for k in ("delp", "pt", "delz")))
    assert rel_diff(got_p, want_p) <= RTOL
    # add_nonhydrostatic_fields: w = 0 and the balanced delz
    st.pop("w"), st.pop("delz")
    nh = add_nonhydrostatic_fields(state_from_numpy(st), ptop=300.0)
    assert torch.equal(nh.w, torch.zeros_like(nh.delp))
    assert rel_diff(nh.delz, want) <= RTOL


@pytest.mark.parametrize("terrain", [False, True])
def test_vertical_solver_matches_reference(terrain):
    from fv3net_tpu.dycore import nonhydro as jn

    st, _, _, _ = _nh_state()
    w_surf = (0.1 * np.random.RandomState(3).randn(*st["phis"].shape)
              if terrain else None)
    args = [st[k] for k in ("w", "delz", "delp", "pt")]
    want = jax.jit(jn.vertical_solver, static_argnums=(4, 5))(
        *map(jnp.asarray, args), 450.0, 300.0,
        w_surf=None if w_surf is None else jnp.asarray(w_surf))
    got = tn.vertical_solver(
        *map(torch.tensor, args), 450.0, 300.0,
        w_surf=None if w_surf is None else torch.tensor(w_surf))
    for g, w, name in zip(got, want, ("w", "delz")):
        assert rel_diff(g, w) <= RTOL, name
    assert rel_diff(got[0], st["w"]) > 1e-3  # the solve moved w


def test_nonhydrostatic_dynamics_step_matches_reference():
    """One nonhydrostatic step (3 substeps with the acoustic solve over
    terrain, the remap with w among the winds and delz as specific
    volume, remap_te's geometric geopotential) and its round trip through
    numpy."""
    from fv3net_tpu.dycore import core as jc
    from fv3net_tpu.grid.geometry import make_grid as jmake_grid

    st, grid, ak, bk = _nh_state()
    want = jc.dynamics_step(
        jax_state(st, jnp.float64),
        jc.GridArrays.from_grid(jmake_grid(8), dtype=jnp.float64),
        jnp.asarray(ak), jnp.asarray(bk), jc.DycoreConfig(**NH_KW))
    got = tc.dynamics_step(
        state_from_numpy(st), tc.GridArrays.from_grid(grid, torch.float64),
        torch.tensor(ak), torch.tensor(bk), tc.DycoreConfig(**NH_KW))
    diffs = assert_states_close(got, want, RTOL)
    assert {"w", "delz"} <= set(diffs)
    assert (got.delz > 0).all()
    assert_states_close(state_from_numpy(state_to_numpy(got)), want, RTOL)


@pytest.mark.parametrize("npx,n_split", [(12, 1), (48, 2), (48, 3)])
def test_validate_acoustic_cfl_decides_as_reference(npx, n_split):
    """The same decision (and message) as the reference's: C12 steps
    with one substep at dt_atmos 900 s, C48 needs n_split >= 3."""
    from fv3net_tpu.dycore import core as jc
    from fv3net_tpu.grid.geometry import make_grid as jmake_grid
    from fv3net_torch.grid.geometry import make_grid

    kw = dict(dt=900.0, n_split=n_split, hydrostatic=False)

    def outcome(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    want = outcome(lambda: jc.validate_acoustic_cfl(
        jc.GridArrays.from_grid(jmake_grid(npx)), jc.DycoreConfig(**kw)))
    got = outcome(lambda: tc.validate_acoustic_cfl(
        tc.GridArrays.from_grid(make_grid(npx), torch.float32),
        tc.DycoreConfig(**kw)))
    assert got == want
    assert (got is None) == ((npx, n_split) != (48, 2))
    tc.validate_acoustic_cfl(None, tc.DycoreConfig(dt=900.0, n_split=1))
