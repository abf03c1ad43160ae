"""The dycore options of fv3net_torch held against fv3net_tpu's (float64,
JAX on the CPU): the kord <= 7 PPM profile, the iv=-2 cubic-spline
profile, the one-shot ``remap_ppm`` and ``interpolate_1d``; dynamics
steps at advection orders 1 and 2 and at kord 7; the gather-table halo;
the JW06 and mountain test-case states; and a run config whose namelist
asks for hord 2 and kord 7."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import assert_states_close, jax_state

from fv3net_torch.dycore import core as tc
from fv3net_torch.dycore import testcases as ttc
from fv3net_torch.dycore.state import DycoreState, init_state
from fv3net_torch.grid.geometry import make_grid
from fv3net_torch.ops import remap as tr
from fv3net_torch.parallel.halo import halo_append, halo_append_gather

jax.config.update("jax_enable_x64", True)

# float64: roundoff of reassociated sums (the remap tests' bound, and the
# dynamics step's: tests/test_torch_remap.py, tests/test_torch_dycore.py)
REMAP_RTOL = 1e-12
STEP_RTOL = 1e-10


def _scale_diff(got, want):
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape
    return np.abs(g - w).max() / np.abs(w).max()


def _columns(seed=0, C=(3, 4), km=24):
    """Edges, a perturbed target and a field with sign changes and
    extrema, float64."""
    rng = np.random.RandomState(seed)
    pe1 = np.cumsum(np.abs(rng.rand(*C, km + 1)) + 0.5, -1) * 400.0
    pe2 = pe1.copy()
    pe2[..., 1:-1] += 0.3 * np.diff(pe1, axis=-1)[..., :-1] * rng.randn(
        *C, km - 1)
    pe2.sort(-1)
    q = np.sin(np.linspace(0, 7, km)) + 0.4 * rng.randn(*C, km)
    return pe1, pe2, q, rng


# ------------------------------------------------------------------ remap
@pytest.mark.parametrize("iv", [-1, 0, 1, 2])
def test_ppm_profile_matches_reference(iv):
    """kord 4-7 (the Huynh constraint at 7; the limiters lmt 1-3 below),
    each iv, to float64 roundoff."""
    from fv3net_tpu.ops import remap as jr

    pe1, _, q, _ = _columns(seed=iv + 3)
    if iv == 0:
        q = np.abs(q) * (np.arange(q.shape[-1]) % 5 != 2)  # zeros too
    dp = np.diff(pe1, axis=-1)
    for kord in (4, 5, 6, 7):
        got = tr.ppm_profile(torch.tensor(q), torch.tensor(dp), iv, kord)
        want = jr.ppm_profile(jnp.asarray(q), jnp.asarray(dp), iv, kord)
        for g, w, name in zip(got, want, ("al", "ar", "a6")):
            assert _scale_diff(g.numpy(), w) <= REMAP_RTOL, (kord, name)


@pytest.mark.parametrize("kord", [9, 10, 17])
def test_cs_profile_iv_minus2_matches_reference(kord):
    """The vertical-velocity profile, its bottom edge pinned to a surface
    value per column (and to 0 without one)."""
    from fv3net_tpu.ops import remap as jr

    pe1, _, q, rng = _columns(seed=kord)
    dp = np.diff(pe1, axis=-1)
    qs = rng.randn(*q.shape[:-1])
    for s_t, s_j in ((torch.tensor(qs), jnp.asarray(qs)), (None, None)):
        got = tr.cs_profile(torch.tensor(q), torch.tensor(dp), -2, kord,
                            qs=s_t)
        want = jr.cs_profile(jnp.asarray(q), jnp.asarray(dp), -2, kord,
                             qs=s_j)
        for g, w in zip(got, want):
            assert _scale_diff(g.numpy(), w) <= REMAP_RTOL
    assert torch.equal(tr.cs_profile(torch.tensor(q), torch.tensor(dp), -2,
                                     17, qs=torch.tensor(qs))[1][..., -1],
                       torch.tensor(qs))


@pytest.mark.parametrize("kord,iv,window,kn", [
    (7, 2, None, 24), (5, 0, 2, 24), (9, -2, None, 24), (6, 1, None, 17),
])
def test_remap_ppm_matches_reference(kord, iv, window, kn):
    """The one-shot remap: its own layer search (a target grid of the
    same or another size) or the banded search with K1's application,
    against the reference's."""
    from fv3net_tpu.ops import remap as jr

    pe1, pe2, q, rng = _columns(seed=kn + kord)
    if kn != pe1.shape[-1] - 1:
        pe2 = np.sort(np.concatenate(
            [pe1[..., :1], rng.uniform(pe1[..., :1], pe1[..., -1:],
                                       pe1.shape[:-1] + (kn - 1,)),
             pe1[..., -1:] * 1.01], -1), -1)
    qs = rng.randn(*q.shape[:-1]) if iv == -2 else None
    got = tr.remap_ppm(torch.tensor(pe1), torch.tensor(q), torch.tensor(pe2),
                       iv=iv, kord=kord, window=window,
                       qs=None if qs is None else torch.tensor(qs))
    want = jr.remap_ppm(jnp.asarray(pe1), jnp.asarray(q), jnp.asarray(pe2),
                        iv=iv, kord=kord, window=window,
                        qs=None if qs is None else jnp.asarray(qs))
    assert got.shape == (3, 4, kn)
    assert _scale_diff(got.numpy(), want) <= REMAP_RTOL


def test_interpolate_1d_matches_reference():
    """Per-column linear interpolation, targets outside the source range
    filled, as a gather."""
    from fv3net_tpu.ops import remap as jr

    rng = np.random.RandomState(0)
    x = np.sort(rng.rand(5, 12), -1) * 100.0
    y = rng.randn(5, 12)
    xp = np.sort(rng.uniform(-10, 110, (5, 9)), -1)
    got = tr.interpolate_1d(torch.tensor(xp), torch.tensor(x),
                            torch.tensor(y))
    want = np.asarray(jr.interpolate_1d(jnp.asarray(xp), jnp.asarray(x),
                                        jnp.asarray(y)))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    inside = ~np.isnan(want)
    assert inside.sum() and (~inside).sum()
    np.testing.assert_allclose(got.numpy()[inside], want[inside],
                               rtol=REMAP_RTOL)


# --------------------------------------------------------------- dycore
@functools.lru_cache(maxsize=None)
def _blob_setup(nz=8):
    """The reference's transport-order test state (tests/test_dycore.py
    test_transport_orders_conserve_and_bound, there on C12 with 12
    levels): the gravity-wave start with a Gaussian tracer blob, on C8."""
    grid = make_grid(8)
    st, ak, bk = init_state(grid, nz, dtype=torch.float64, perturbation=3.0)
    lon, lat = grid.lon[:, None], grid.lat[:, None]
    blob = np.exp(-((lon - 1.0) ** 2 + lat ** 2) / 0.1) * np.ones(
        (6, nz, grid.n, grid.n))
    st = DycoreState(delp=st.delp, pt=st.pt, wind=st.wind,
                     tracers={"sphum": torch.tensor(blob)}, phis=st.phis)
    return grid, st, ak, bk


@pytest.mark.parametrize("cfg", [
    dict(advection_order=1), dict(advection_order=2),
    dict(advection_order=4, kord=7),
], ids=["order1", "order2", "kord7"])
def test_dynamics_step_option_matches_reference(cfg):
    """One dynamics step (3 substeps and the remap) at advection order 1,
    2 (the reference's default DycoreConfig) and PPM with kord 7, against
    ``fv3net_tpu.dycore.dynamics_step``; tracer mass kept and the blob
    within its bounds, as the reference's test holds its own."""
    from fv3net_tpu.dycore import core as jc
    from fv3net_tpu.grid.geometry import make_grid as jmake_grid

    grid, st, ak, bk = _blob_setup()
    kw = dict(dt=900.0, n_split=3, **cfg)
    want = jc.dynamics_step(
        jax_state({"delp": st.delp.numpy(), "pt": st.pt.numpy(),
                   "wind": st.wind.numpy(), "phis": st.phis.numpy(),
                   "tracers": {"sphum": st.tracers["sphum"].numpy()}},
                  jnp.float64),
        jc.GridArrays.from_grid(jmake_grid(8), dtype=jnp.float64),
        jnp.asarray(ak), jnp.asarray(bk), jc.DycoreConfig(**kw))
    got = tc.dynamics_step(st, tc.GridArrays.from_grid(grid, torch.float64),
                           torch.tensor(ak), torch.tensor(bk),
                           tc.DycoreConfig(**kw))
    assert_states_close(got, want, STEP_RTOL)
    area = torch.tensor(grid.area)[:, None]
    m0 = (st.tracers["sphum"] * st.delp * area).sum()
    m1 = (got.tracers["sphum"] * got.delp * area).sum()
    assert abs(float(m1 / m0) - 1.0) <= 1e-9
    q = got.tracers["sphum"]
    assert q.min() > -1e-9 and q.max() < 1.0 + 1e-6


def test_default_dycore_config_is_the_references():
    from fv3net_tpu.dycore import core as jc
    import dataclasses

    assert (dataclasses.asdict(tc.DycoreConfig())
            == dataclasses.asdict(jc.DycoreConfig()))
    assert tc.DycoreConfig().advection_order == 2
    with pytest.raises(ValueError, match="advection_order"):
        tc.validate_acoustic_cfl(
            tc.GridArrays.from_grid(make_grid(4), torch.float64),
            tc.DycoreConfig(advection_order=3))


# ------------------------------------------------------------------ halo
@pytest.mark.parametrize("h", [1, 2, 3])
def test_halo_append_gather_equals_halo_append(h):
    """The gather-table halo on tensors equals the static-slice one and
    the reference's gather form, corners included."""
    from fv3net_tpu.parallel.halo import halo_append_gather as jgather

    x = np.random.RandomState(h).randn(6, 2, 3, 8, 8)
    got = halo_append_gather(torch.tensor(x), h)
    assert torch.equal(got, halo_append(torch.tensor(x), h))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jgather(jnp.asarray(x), h)))
    assert halo_append_gather(torch.tensor(x[:, 0, 0]), h).shape == (
        6, 8 + 2 * h, 8 + 2 * h)


# ------------------------------------------------------------ test cases
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_testcase_states_equal_reference(dtype):
    """JW06 (perturbed and steady) and the mountain at rest, state and
    (ak, bk): equal to the reference's in float64 (its virtual potential
    temperature to roundoff of the power) and within float32 roundoff of
    it in float32."""
    from fv3net_tpu.dycore import testcases as jtc
    from fv3net_tpu.grid.geometry import make_grid as jmake_grid

    tdt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    jdt = {"float64": jnp.float64, "float32": jnp.float32}[dtype]
    rtol = {"float64": 1e-15, "float32": 1e-6}[dtype]
    grid, jgrid = make_grid(8), jmake_grid(8)
    cases = [
        (ttc.baroclinic_wave_state(grid, 12, True, tdt, device="cpu"),
         jtc.baroclinic_wave_state(jgrid, 12, True, jdt)),
        (ttc.baroclinic_wave_state(grid, 10, False, tdt, device="cpu"),
         jtc.baroclinic_wave_state(jgrid, 10, False, jdt)),
        (ttc.mountain_rest_state(grid, 12, dtype=tdt, device="cpu"),
         jtc.mountain_rest_state(jgrid, 12, dtype=jdt)),
    ]
    for (got, ak, bk), (want, akj, bkj) in cases:
        np.testing.assert_array_equal(ak, akj)
        np.testing.assert_array_equal(bk, bkj)
        assert got.pt.dtype == tdt
        assert_states_close(got, want, rtol)
        assert np.array_equal(got.delp.numpy(), np.asarray(want.delp))


# ------------------------------------------------------------ run config
def test_run_config_hord2_kord7_steps_as_reference():
    """A fv3config whose fv_core_nml asks for hord_mt 2 and kord_tm -7
    (advection order 2, PPM remap kord 7) builds a TimeLoop that takes a
    step equal to the reference's."""
    from fv3net_tpu.runtime.config import get_config as jget_config
    from fv3net_tpu.runtime.loop import TimeLoop as JTimeLoop

    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop

    cfg = {"namelist": {"fv_core_nml": {"npx": 7, "npz": 8, "hord_mt": 2,
                                        "kord_tm": -7}},
           "duration_seconds": 900.0}
    tl = TimeLoop(get_config(cfg), dtype=torch.float64, device="cpu")
    jl = JTimeLoop(jget_config(cfg), dtype=jnp.float64)
    assert tl._dyn_cfg.advection_order == 2
    assert tl._dyn_cfg.kord == 7
    steps = [(tt, jt) for (tt, _), (jt, _) in zip(tl, jl)]
    assert len(steps) == 1 and steps[0][0] == steps[0][1]
    assert_states_close(tl.state.dycore, jl.state.dycore, 1e-8)
