"""fv3net_torch's surface models, orographic gravity-wave drag, the
Monin-Obukhov surface layer with a land fraction and an evaporation
factor, and ``physics_step`` with the production chunk's surface
couplings, each held against fv3net_tpu on shared seeded numpy inputs
(float64)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import assert_states_close, jax_state, make_state_numpy

from fv3net_torch.dycore.state import state_from_numpy
from fv3net_torch.physics import PhysicsConfig, physics_step
from fv3net_torch.physics import gravity_wave_drag as tgwd
from fv3net_torch.physics import land as tland
from fv3net_torch.physics import sea_ice as tice
from fv3net_torch.physics import slab_ocean as tslab
from fv3net_torch.physics import soil as tsoil
from fv3net_torch.physics import surface as tsfc
from fv3net_torch.physics import surface_layer as tsl

jax.config.update("jax_enable_x64", True)

# float64: the same formulas, so roundoff of reassociated sums only
RTOL = 1e-12
# one float64 physics step: roundoff grown through the column schemes
# (the flagship step tests' bound)
STEP_RTOL = 1e-8
SHAPE = (6, 5, 5)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _close(got, want, rtol=RTOL, name=""):
    """Each output (tensor, array or dict of them) within ``rtol`` of its
    scale."""
    if isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            _close(got[k], want[k], rtol, f"{name}{k}")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, rtol, f"{name}[{i}]")
        return
    if torch.is_tensor(got):
        got = got.numpy()
    assert np.shape(got) == np.shape(want), (name, np.shape(got))
    assert _rel(got, want) <= rtol, (name, _rel(got, want))


def _pair(x):
    """(torch tensor, jax array) of one numpy array."""
    return torch.tensor(x), jnp.asarray(x)


def _flux_diags(rng, ghflx=False):
    d = {
        "DSWRFsfc": 300 * rng.rand(*SHAPE),
        "USWRFsfc": 30 * rng.rand(*SHAPE),
        "DLWRFsfc": 250 + 100 * rng.rand(*SHAPE),
        "ULWRFsfc": 300 + 150 * rng.rand(*SHAPE),
        "SHTFLsfc": 40 * rng.randn(*SHAPE),
        "LHTFLsfc": 150 * rng.rand(*SHAPE),
    }
    if ghflx:
        d["GHFLXsfc"] = 20 * rng.randn(*SHAPE)
    return d


def _mask(rng):
    return (rng.rand(*SHAPE) > 0.6).astype(np.float64)


@pytest.mark.parametrize("with_mask", [False, True])
def test_slab_ocean_matches_reference(with_mask):
    from fv3net_tpu.physics import slab_ocean as jslab

    rng = np.random.RandomState(0)
    # around freezing, so that the floor acts on some points
    t = 271.0 + 2.0 * rng.rand(*SHAPE)
    diags = _flux_diags(rng, ghflx=with_mask)
    diags["LHTFLsfc"] = diags["LHTFLsfc"] + 300.0  # strong cooling
    mask = _mask(rng) if with_mask else None
    tm, jm = _pair(mask) if with_mask else (None, None)
    dt = 900.0 * 40
    got = tslab.slab_ocean_update(torch.tensor(t), {
        k: torch.tensor(v) for k, v in diags.items()}, dt, land_mask=tm)
    want = jslab.slab_ocean_update(jnp.asarray(t), {
        k: jnp.asarray(v) for k, v in diags.items()}, dt, land_mask=jm)
    _close(got, want)
    _close(tslab.net_surface_flux({k: torch.tensor(v)
                                   for k, v in diags.items()}),
           jslab.net_surface_flux({k: jnp.asarray(v)
                                   for k, v in diags.items()}))
    assert (np.asarray(want) == jslab.SlabOceanParams().t_min).any()


@pytest.mark.parametrize("with_mask", [False, True])
def test_sea_ice_matches_reference(with_mask):
    from fv3net_tpu.physics import sea_ice as jice

    rng = np.random.RandomState(1)
    t = 270.5 + 2.0 * rng.rand(*SHAPE)  # both sides of freezing
    h = 0.4 * rng.rand(*SHAPE) * (rng.rand(*SHAPE) > 0.4)
    diags = _flux_diags(rng)
    mask = _mask(rng) if with_mask else None
    tm, jm = _pair(mask) if with_mask else (None, None)
    dt = 900.0 * 20
    got = tice.slab_ocean_seaice_update(
        torch.tensor(t), torch.tensor(h),
        {k: torch.tensor(v) for k, v in diags.items()}, dt, land_mask=tm)
    want = jice.slab_ocean_seaice_update(
        jnp.asarray(t), jnp.asarray(h),
        {k: jnp.asarray(v) for k, v in diags.items()}, dt, land_mask=jm)
    _close(got, want)
    _close(tice.ice_fraction(torch.tensor(h)), jice.ice_fraction(
        jnp.asarray(h)))
    cap = 4.0e6 * (1.0 + rng.rand(*SHAPE))
    _close(tice.slab_ice_exchange(torch.tensor(t), torch.tensor(h),
                                  torch.tensor(cap)),
           jice.slab_ice_exchange(jnp.asarray(t), jnp.asarray(h),
                                  jnp.asarray(cap)))
    h_new = np.asarray(want[1])
    assert (h_new > h).any() and (h_new < h).any()  # growth and melt


def test_bucket_land_matches_reference():
    from fv3net_tpu.physics import land as jland

    rng = np.random.RandomState(2)
    w = 0.16 * rng.rand(*SHAPE)
    p = 1e-3 * rng.rand(*SHAPE)
    e = 1e-4 * rng.rand(*SHAPE)
    _close(tland.evaporation_efficiency(torch.tensor(w)),
           jland.evaporation_efficiency(jnp.asarray(w)))
    got = tland.bucket_hydrology_update(*map(torch.tensor, (w, p, e)), 900.0)
    want = jland.bucket_hydrology_update(*map(jnp.asarray, (w, p, e)), 900.0)
    _close(got, want)
    assert (np.asarray(want[1]) > 0).any()  # the bucket overflows


def test_noah_soil_matches_reference():
    from fv3net_tpu.physics import soil as jsoil

    rng = np.random.RandomState(3)
    nl = 4
    stc = 270.0 + 15.0 * rng.rand(nl, *SHAPE)
    smc = 0.05 + 0.38 * rng.rand(nl, *SHAPE)
    swe = 0.02 * rng.rand(*SHAPE)
    tg3 = 275.0 + 5.0 * rng.rand(*SHAPE)
    t_skin = 268.0 + 14.0 * rng.rand(*SHAPE)  # melting on some points
    rain = 2e-4 * rng.rand(*SHAPE)
    snow = 1e-4 * rng.rand(*SHAPE)
    evap = 5e-5 * rng.rand(*SHAPE)
    args = (stc, smc, swe, tg3, t_skin, rain, snow, evap)
    got = tsoil.noah_land_step(*map(torch.tensor, args), 900.0)
    want = jsoil.noah_land_step(*map(jnp.asarray, args), 900.0)
    _close(got, want)
    _close(tsoil.evaporation_efficiency(torch.tensor(smc)),
           jsoil.evaporation_efficiency(jnp.asarray(smc)))
    _close(tsoil.snow_cover_fraction(torch.tensor(swe)),
           jsoil.snow_cover_fraction(jnp.asarray(swe)))
    flux = 30.0 * rng.randn(*SHAPE)
    _close(tsoil.soil_thermal_step(*map(torch.tensor, (stc, tg3, flux, smc)),
                                   900.0),
           jsoil.soil_thermal_step(*map(jnp.asarray, (stc, tg3, flux, smc)),
                                   900.0))
    assert (np.asarray(want[3]["snow_melt_heat"]) > 0).any()


def _gwd_inputs(C=40, nz=20, seed=4):
    """Columns with a westerly jet that reverses aloft in half of them
    (a critical level), a stable lapse rate and seeded sgh > 0."""
    from fv3net_torch.dycore.vertical import hybrid_coordinate

    rng = np.random.RandomState(seed)
    ak, bk = hybrid_coordinate(nz)
    pe = ak[None] + bk[None] * (1e5 + 2000 * rng.randn(C))[:, None]
    delp = np.diff(pe, axis=1)
    pmid = delp / np.diff(np.log(pe), axis=1)
    T = np.maximum(290 * (pmid / 1e5) ** 0.19, 210) + rng.randn(C, nz)
    z = np.linspace(1.0, 0.0, nz)[None]  # 1 at the top
    u0 = 5.0 + 15.0 * rng.rand(C, 1)
    reverse = (np.arange(C) % 2 == 0)[:, None]
    u = u0 * np.where(reverse, 1.0 - 2.5 * z, 1.0 + z)
    v = 3.0 * rng.randn(C, 1) + rng.randn(C, nz)
    wind = np.stack([u, v, 0.1 * rng.randn(C, nz)])
    sgh = 50.0 + 400.0 * rng.rand(C)
    return wind, T, delp, pmid, sgh


def test_gravity_wave_drag_matches_reference():
    """The cummin sweep against the reference's reversed scan; the
    columns that reverse aloft deposit all their stress below the
    critical level."""
    from fv3net_tpu.physics import gravity_wave_drag as jgwd

    args = _gwd_inputs()
    got = tgwd.orographic_gwd(*map(torch.tensor, args), 900.0)
    want = jgwd.orographic_gwd(*map(jnp.asarray, args), 900.0)
    _close(got, want)
    tau0 = np.asarray(want[1])
    dwind = np.asarray(want[0])
    assert (tau0 > 0).all() and np.abs(dwind).max() > 0
    # a critical level: some layer of a reversing column takes no drag
    # above where the parallel wind turns negative
    assert (np.abs(dwind[:, ::2, :3]) == 0).any()


@pytest.mark.parametrize("scheme", ["monin_obukhov", "bulk"])
def test_surface_fluxes_with_land_and_evaporation_factor(scheme):
    from fv3net_tpu.physics import surface as jsfc
    from fv3net_tpu.physics import surface_layer as jsl

    rng = np.random.RandomState(5)
    t_air = 285 + 10 * rng.rand(*SHAPE)
    q_air = 0.012 * rng.rand(*SHAPE)
    p_sfc = 1e5 + 1000 * rng.randn(*SHAPE)
    delp = 1500 + 200 * rng.rand(*SHAPE)
    speed = 12 * rng.rand(*SHAPE)
    t_s = t_air + 4 * rng.randn(*SHAPE)
    land = rng.rand(*SHAPE) * (rng.rand(*SHAPE) > 0.5)
    beta = rng.rand(*SHAPE)
    args = (t_air, q_air, p_sfc, delp, speed, t_s)
    if scheme == "monin_obukhov":
        got = tsl.monin_obukhov_fluxes(
            *map(torch.tensor, args), land_frac=torch.tensor(land),
            evap_factor=torch.tensor(beta))
        want = jsl.monin_obukhov_fluxes(
            *map(jnp.asarray, args), land_frac=jnp.asarray(land),
            evap_factor=jnp.asarray(beta))
        # without the two the port skips the blends: the same numbers
        _close(tsl.monin_obukhov_fluxes(*map(torch.tensor, args)),
               jsl.monin_obukhov_fluxes(*map(jnp.asarray, args)))
    else:
        got = tsfc.bulk_surface_fluxes(*map(torch.tensor, args),
                                       evap_factor=torch.tensor(beta))
        want = jsfc.bulk_surface_fluxes(*map(jnp.asarray, args),
                                        evap_factor=jnp.asarray(beta))
    _close(got, want)


# ------------------------------------------------------------ physics_step
NPX, NPZ = 4, 16


@functools.lru_cache(maxsize=None)
def _step_inputs():
    """A moist C4 state with a surface: tile 0 land with seeded sgh, sea
    ice on part of the ocean, a bucket-style evaporation factor."""
    st, grid, ak, bk = make_state_numpy(NPX, NPZ, seed=6, moist=True)
    st["tracers"]["cloud_water"] *= 10.0
    rng = np.random.RandomState(6)
    shape = grid.lat.shape
    land = np.zeros(shape)
    land[0] = 1.0
    sfc = {
        "t_surface": 300.15 - 30.0 * np.sin(grid.lat) ** 2,
        "cosz": np.cos(grid.lat) * np.cos(grid.lon),
        "lat": grid.lat,
        "sgh": land * (100.0 + 300.0 * rng.rand(*shape)),
        "evap_factor": np.where(land > 0.5, rng.rand(*shape), 1.0),
        "land_frac": land,
        "ice_frac": (1.0 - land) * np.clip(rng.rand(*shape) - 0.5, 0, 1),
    }
    return st, sfc


@pytest.mark.parametrize("radiation", ["gray", "rrtmg"])
def test_physics_step_with_surface_couplings_matches_reference(
        radiation, monkeypatch):
    """One float64 physics step with evap_factor, land_frac, ice_frac and
    sgh: the gray scheme with its ice-albedo blend, or RRTMG (both drivers
    in float64, the reference's McICA draws) reading the land mask and
    the ice fraction."""
    from test_torch_rrtmg import jax_mcica_draws

    from fv3net_tpu.physics import PhysicsConfig as JPhysicsConfig
    from fv3net_tpu.physics import physics_step as jphysics_step
    from fv3net_tpu.physics.radiation.rrtmg import driver as jdrv
    from fv3net_tpu.runtime import fused as jfused

    from fv3net_torch.physics.radiation.rrtmg import driver as tdrv
    from fv3net_torch.runtime import fused as tfused

    st, sfc = _step_inputs()
    jcfg = JPhysicsConfig(radiation_scheme=radiation)
    tcfg = PhysicsConfig(radiation_scheme=radiation)
    j_rad = t_rad = None
    if radiation == "rrtmg":
        monkeypatch.setattr(jdrv, "RRTMGDriver", functools.partial(
            jdrv.RRTMGDriver, dtype=jnp.float64))
        monkeypatch.setattr(tdrv.RRTMGDriver, "draw_mcica",
                            jax_mcica_draws(torch.float64))
        j_rad = jfused._build_radiation_fn(jcfg)
        t_rad = tfused._build_radiation_fn(tcfg, "cpu", torch.float64)

    def jstep(state, s):
        return jphysics_step(
            state, s["t_surface"], s["cosz"], s["lat"], 900.0, jcfg,
            radiation_fn=j_rad, sgh=s["sgh"], evap_factor=s["evap_factor"],
            land_frac=s["land_frac"], ice_frac=s["ice_frac"])

    want_state, want = jax.jit(jstep)(
        jax_state(st, jnp.float64),
        {k: jnp.asarray(v) for k, v in sfc.items()})
    ts = {k: torch.tensor(v) for k, v in sfc.items()}
    got_state, got = physics_step(
        state_from_numpy(st), ts["t_surface"], ts["cosz"], ts["lat"], 900.0,
        tcfg, radiation_fn=t_rad, sgh=ts["sgh"],
        evap_factor=ts["evap_factor"], land_frac=ts["land_frac"],
        ice_frac=ts["ice_frac"])
    assert_states_close(got_state, want_state, STEP_RTOL)
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    # the precipitation rates' scale is the total's: the convective and
    # frozen parts are roundoff-level (~1e-19) where nothing triggers
    rate_scale = np.abs(np.asarray(want["PRATEsfc"])).max()
    rels = {
        k: (np.abs(got[k].numpy() - np.asarray(want[k])).max()
            / max(np.abs(np.asarray(want[k])).max(),
                  rate_scale if k in ("CPRATsfc", "SNOWsfc") else 1e-300))
        for k in want
    }
    bad = {k: r for k, r in rels.items() if not r <= STEP_RTOL}
    assert not bad, bad
    tau = np.asarray(want["taugwd"])
    assert (tau[0] > 0).all() and (tau[1:] == 0).all()
