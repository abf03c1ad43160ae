"""fv3net_torch's synthetic band radiation and Held-Suarez forcing held
against fv3net_tpu's (on the CPU): the numpy copies of ``params`` and
``spectra``, the optics, ``lw_transfer`` and ``sw_transfer``, the
``RadiationDriver`` with the reference's McICA draws handed in, the
``Radiation`` wrapper on its three schemes, a synthband ``physics_step``
and ``held_suarez_forcing``.

The synthband model computes in float32 in both packages (the
reference's driver casts its inputs to float32 whatever their dtype), so
its comparisons are float32 against float32.  The two level sweeps of
each solver (LW down and up, the SW adding method's up and down passes)
accumulate float32 roundoff over the layers, and the two packages sum in
other orders; the bound for each quantity is set from the reference's
own float64 run of the same call (its solvers on float64 inputs; its
driver with its float32 casts read as float64 and its McICA masks kept):
the port's float32 result parts from the reference's float32 result, and
from the reference's float64 result, by at most SWEEP_FACTOR times what
the reference's float32 errs against its float64 there, plus SWEEP_FLOOR
of the quantity's scale.  On the 40 seeded columns of the driver test
that float32 error is 6e-8 to 2.3e-4 of scale (clear-sky SW heating the
largest; the cos zenith exact), and the port's 1.2e-7 to 1.9e-4.  The
port's solvers in float64 are held to the reference's in float64 within
F64_RTOL, so an error of the port's own cannot hide in a float32
bound."""
import datetime
import functools
import inspect

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

from fv3net_torch.physics.radiation import (
    DriverConfig,
    Radiation,
    RadiationConfig,
    RadiationDriver,
)
from fv3net_torch.physics.radiation import lw, optics, params, spectra, sw

jax.config.update("jax_enable_x64", True)

SWEEP_FACTOR = 3.0
SWEEP_FLOOR = 1e-6
# the solvers in float64: both packages sum the same terms in other orders
F64_RTOL = 1e-12
# single float32 operations against the reference's: a few ulps
F32_RTOL = 1e-6
TIME = datetime.datetime(2016, 8, 1, 6)


def _f32(x):
    return torch.tensor(np.asarray(x, np.float32))


def _columns(C=40, L=16, seed=0):
    """Seeded columns (z index 0 = model top) with cloud in a third of
    the layers, land, sea ice near the poles, and a cosz with night."""
    rng = np.random.RandomState(seed)
    ps = 1e5 + 1000 * rng.randn(C)
    pe = 300.0 + (ps[:, None] - 300.0) * np.linspace(0, 1, L + 1) ** 1.5
    pm = 0.5 * (pe[:, 1:] + pe[:, :-1])
    T = np.maximum(290 * (pm / 1e5) ** 0.2, 210) + rng.randn(C, L)
    lat = np.deg2rad(rng.uniform(-80, 80, C))
    lon = np.deg2rad(rng.uniform(0, 360, C))
    state = {
        "air_temperature": T,
        "pressure_thickness_of_atmospheric_layer": np.diff(pe, axis=1),
        "specific_humidity": 0.01 * (pm / 1e5) ** 3 * rng.rand(C, L),
        "cloud_water_mixing_ratio": np.where(rng.rand(C, L) < 0.3,
                                             2e-4 * rng.rand(C, L), 0.0),
        "surface_temperature": T[:, -1] + 2,
        "latitude": lat,
        "longitude": lon,
        "land_sea_mask": (rng.rand(C) < 0.3).astype(float),
        "ice_fraction": np.where(np.abs(lat) > 1.1, 0.5, 0.0),
    }
    cosz = np.clip(np.cos(lat) * np.cos(lon), 0, 1) * (rng.rand(C) > 0.2)
    return state, cosz


def reference_draws(monkeypatch, seed=42):
    """Hand the reference's McICA draws to the port's synthband driver:
    its fold of the float32 columns (the sum) and its threefry uniforms
    keyed on it."""
    from fv3net_tpu.physics.radiation import params as JP

    def fold(self, T):
        t = jnp.asarray(T.numpy(), jnp.float32)
        return int(((jnp.abs(t).sum() * 16.0) % 1000003.0).astype(jnp.int32))

    def draw(self, fold, ncol, nlay):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
        a = jax.random.uniform(key, (nlay, ncol, JP.NGPT_LW), jnp.float32)
        b = jax.random.uniform(jax.random.fold_in(key, 1),
                               (nlay, ncol, JP.NGPT_SW), jnp.float32)
        return tuple(torch.tensor(np.asarray(x), dtype=self.dtype,
                                  device=self.device) for x in (a, b))

    monkeypatch.setattr(RadiationDriver, "mcica_fold", fold)
    monkeypatch.setattr(RadiationDriver, "draw_mcica", draw)


def _within_control(got, want, want64):
    """Per quantity, each relative to its scale: the port's float32
    result within SWEEP_FACTOR |ref32 - ref64| + SWEEP_FLOOR of the
    reference's float32 result ``want`` and of its float64 result
    ``want64``."""
    bad = {}
    for k in want:
        g, w = got[k].double().numpy(), np.asarray(want[k], np.float64)
        c = np.asarray(want64[k], np.float64)
        bound = SWEEP_FACTOR * rel_diff(w, c) + SWEEP_FLOOR
        d, d64 = rel_diff(g, w), rel_diff(g, c)
        if not (d <= bound and d64 <= bound):
            bad[k] = (d, d64, bound)
    assert not bad, bad


def _equal_within(got, want, rtol):
    bad = {k: rel_diff(got[k].numpy(), np.asarray(want[k]))
           for k in want}
    assert all(v <= rtol for v in bad.values()), bad


# ------------------------------------------------------------ the copies
def test_params_and_spectra_copies_equal_the_originals():
    from fv3net_tpu.physics.radiation import params as jparams
    from fv3net_tpu.physics.radiation import spectra as jspectra

    def body(module):
        src = inspect.getsource(module)
        return src[src.index("from __future__"):]

    assert body(params) == body(jparams)
    allowed = {
        ("from fv3net_tpu.physics.radiation import params as P",
         "from fv3net_torch.physics.radiation import params as P"),
        ("from scipy.special import erfinv  # scipy is in the image via "
         "jax deps", "from scipy.special import erfinv"),
        ("return np.trapezoid(b, nu, axis=1)",
         "trapezoid = getattr(np, \"trapezoid\", None) or np.trapz\n"
         "    return trapezoid(b, nu, axis=1)"),
    }
    mine = body(spectra)
    theirs = body(jspectra)
    for a, b in allowed:
        theirs = theirs.replace(a, b)
    assert mine == theirs
    for name in ("lw_kdist", "sw_kdist"):
        a, b = getattr(spectra, name)(), getattr(jspectra, name)()
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for name in ("planck_band_coefs", "solar_band_fraction",
                 "rayleigh_band_coeff"):
        np.testing.assert_array_equal(getattr(spectra, name)(),
                                      getattr(jspectra, name)())


# ------------------------------------------------------------ optics
def test_optics_match_reference():
    from fv3net_tpu.physics.radiation import optics as joptics
    from fv3net_tpu.physics.radiation import spectra as jspectra

    state, cosz = _columns()
    rng = np.random.RandomState(4)
    T = state["air_temperature"]
    dp = state["pressure_thickness_of_atmospheric_layer"]
    play = 300.0 + np.cumsum(dp, axis=1) - 0.5 * dp
    q = state["specific_humidity"]
    mmr = {"h2o": q, "co2": 5e-4 + 0 * q, "o3": 1e-6 + 0 * q,
           "ch4": 1e-6 + 0 * q, "n2o": 5e-7 + 0 * q, "o2": 0.23 + 0 * q}
    for kd, nb in ((spectra.lw_kdist(), 16), (spectra.sw_kdist(), 14)):
        go = optics.build_gas_optics(kd, nb, device="cpu")
        jgo = joptics.build_gas_optics(
            jspectra.lw_kdist() if nb == 16 else jspectra.sw_kdist(), nb)
        got = optics.gas_optical_depth(go, _f32(play), _f32(T), _f32(dp),
                                       {k: _f32(v) for k, v in mmr.items()})
        want = jax.jit(functools.partial(joptics.gas_optical_depth, jgo))(
            jnp.asarray(play, jnp.float32), jnp.asarray(T, jnp.float32),
            jnp.asarray(dp, jnp.float32),
            {k: jnp.asarray(v, jnp.float32) for k, v in mmr.items()})
        assert rel_diff(got.numpy(), np.asarray(want)) <= F32_RTOL
    assert rel_diff(optics.rayleigh_tau(_f32(dp)).numpy(), np.asarray(
        jax.jit(joptics.rayleigh_tau)(jnp.asarray(dp, jnp.float32)))) <= \
        F32_RTOL
    land = state["land_sea_mask"]
    for got, want in zip(
            optics.aerosol_optics(_f32(play), _f32(dp), _f32(land)),
            jax.jit(joptics.aerosol_optics)(*(jnp.asarray(x, jnp.float32)
                                              for x in (play, dp, land)))):
        assert rel_diff(got.numpy(), np.asarray(want)) <= F32_RTOL
    lwp, iwp = 100 * rng.rand(40, 16), 50 * rng.rand(40, 16)
    rel, rei = 10 + 4 * rng.rand(40, 16), 20 + 100 * rng.rand(40, 16)
    cf = rng.rand(40, 16) * (rng.rand(40, 16) > 0.4)
    got = optics.cloud_optics(*map(_f32, (lwp, iwp, rel, rei, cf)))
    want = jax.jit(joptics.cloud_optics)(*(jnp.asarray(x, jnp.float32)
                                           for x in (lwp, iwp, rel, rei, cf)))
    for g, w in zip(got, want):
        assert rel_diff(g.numpy(), np.asarray(w)) <= F32_RTOL
    # McICA subcolumns from the reference's uniforms, both overlaps
    key = jax.random.PRNGKey(3)
    u = jax.random.uniform(key, (16, 40, 140), jnp.float32)
    for iovr in (0, 1):
        want = joptics.mcica_subcolumns(jnp.asarray(cf, jnp.float32), 140,
                                        key, iovr=iovr)
        got = optics.mcica_subcolumns(_f32(cf), torch.tensor(np.asarray(u)),
                                      iovr=iovr)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    alb = optics.surface_albedo(_f32(cosz), _f32(land), _f32(0.3 + 0 * land))
    jalb = jax.jit(joptics.surface_albedo)(*(
        jnp.asarray(x, jnp.float32) for x in (cosz, land, 0.3 + 0 * land)))
    for g, w in zip(alb, jalb):
        assert rel_diff(g.numpy(), np.asarray(w)) <= F32_RTOL


# ------------------------------------------------------------ the solvers
def test_lw_and_sw_transfer_match_reference():
    """The two solvers alone on seeded optical properties: in float32
    against the reference's, with the reference's float64 run as the
    control, and in float64 against the reference's float64 run."""
    from fv3net_tpu.physics.radiation import lw as jlw
    from fv3net_tpu.physics.radiation import sw as jsw

    rng = np.random.RandomState(5)
    C, G, L = 24, 20, 16
    tau = 10 ** rng.uniform(-4, 1.5, (C, G, L))
    e_lev = 50 + 100 * rng.rand(C, G, L + 1)
    e_sfc = 60 + 100 * rng.rand(C, G)
    emis = 0.95 + 0.04 * rng.rand(C)
    dp = 2000 + 3000 * rng.rand(C, L)
    f32 = [np.asarray(x, np.float32) for x in (tau, e_lev, e_sfc, emis, dp)]
    jlw_ = jax.jit(lambda a, b, *c: jlw.lw_transfer(a, b, None, *c))
    want = jlw_(*map(jnp.asarray, f32))._asdict()
    want64 = jlw_(*(jnp.asarray(x, jnp.float64) for x in f32))._asdict()
    got = lw.lw_transfer(*map(torch.tensor, f32[:2]), None,
                         *map(torch.tensor, f32[2:]))
    _within_control(got._asdict(), want, want64)
    got64 = lw.lw_transfer(*(torch.tensor(x, dtype=torch.float64)
                             for x in f32[:2]), None,
                           *(torch.tensor(x, dtype=torch.float64)
                             for x in f32[2:]))
    _equal_within(got64._asdict(), want64, F64_RTOL)

    ssa = rng.rand(C, G, L)
    g = 0.9 * rng.rand(C, G, L)
    mu0 = np.where(rng.rand(C) > 0.2, rng.rand(C), 0.0)
    src = 10 + 50 * rng.rand(C, G)
    alb_dir, alb_dif = 0.5 * rng.rand(C, G), 0.5 * rng.rand(C, G)
    f32 = [np.asarray(x, np.float32)
           for x in (tau, ssa, g, mu0, src, alb_dir, alb_dif, dp)]
    jsw_ = jax.jit(jsw.sw_transfer)
    want = jsw_(*map(jnp.asarray, f32))._asdict()
    want64 = jsw_(*(jnp.asarray(x, jnp.float64) for x in f32))._asdict()
    got = sw.sw_transfer(*map(torch.tensor, f32))
    _within_control(got._asdict(), want, want64)
    got64 = sw.sw_transfer(*(torch.tensor(x, dtype=torch.float64)
                             for x in f32))
    _equal_within(got64._asdict(), want64, F64_RTOL)


# ------------------------------------------------------------ the driver
class _Float64Numpy:
    """jax.numpy with its ``float32`` read as float64: the reference's
    driver and optics modules under it run their float32 casts in
    float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module")
def reference_call():
    """The reference driver's jitted float32 call on the seeded columns,
    and its float64 control: the same call on the same (float32-valued)
    inputs with its float32 casts read as float64 and the float32 call's
    McICA masks handed back, so that only the arithmetic's precision
    differs."""
    from fv3net_tpu.physics.radiation import DriverConfig as JDriverConfig
    from fv3net_tpu.physics.radiation import RadiationDriver as JDriver
    from fv3net_tpu.physics.radiation import driver as jdriver
    from fv3net_tpu.physics.radiation import optics as joptics

    state, cosz = _columns()
    s32 = {k: jnp.asarray(v, jnp.float32) for k, v in state.items()}
    c32 = jnp.asarray(cosz, jnp.float32)
    draw = joptics.mcica_subcolumns
    masks = []

    def keep(*a, **k):
        masks.append(draw(*a, **k))
        return masks[-1]

    def call32(s, c):
        masks.clear()
        return jd(TIME, s, cosz=c), tuple(masks)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(joptics, "mcica_subcolumns", keep)
        jd = JDriver(JDriverConfig())
        want, kept = jax.jit(call32)(s32, c32)
    with pytest.MonkeyPatch.context() as mp:
        handed = iter(kept)
        mp.setattr(joptics, "mcica_subcolumns", lambda *a, **k: next(handed))
        mp.setattr(jdriver, "jnp", _Float64Numpy())
        mp.setattr(joptics, "jnp", _Float64Numpy())
        jd64 = JDriver(JDriverConfig())
        want64 = jax.jit(lambda s, c: jd64(TIME, s, cosz=c))(
            {k: v.astype(jnp.float64) for k, v in s32.items()},
            c32.astype(jnp.float64))
    assert all(v.dtype == jnp.float64 for v in want64.values())
    return state, cosz, want, want64


def test_radiation_driver_matches_reference(reference_call, monkeypatch):
    """The float32 driver with the reference's McICA draws, every output,
    against the reference's float32 call within the bound its float64
    control sets."""
    state, cosz, want, want64 = reference_call
    reference_draws(monkeypatch)
    inputs = {k: torch.tensor(v) for k, v in state.items()}
    got = RadiationDriver(DriverConfig(), device="cpu")(
        TIME, inputs, cosz=torch.tensor(cosz))
    assert set(got) == set(want)
    assert all(v.dtype == torch.float32 for v in got.values())
    _within_control(got, want, want64)
    heat = got["tendency_of_air_temperature_due_to_radiation"]
    assert torch.isfinite(heat).all() and (heat != 0).any()


def test_radiation_driver_draws_from_a_generator():
    """Without the reference's draws the driver's own: the same state
    draws the same subcolumns, another state others."""
    state, cosz = _columns(C=8)
    d = RadiationDriver(DriverConfig(), device="cpu")
    inputs = {k: torch.tensor(v) for k, v in state.items()}
    a = d(TIME, inputs, cosz=torch.tensor(cosz))
    b = d(TIME, inputs, cosz=torch.tensor(cosz))
    key = "total_sky_longwave_heating_rate_python"
    assert torch.equal(a[key], b[key])
    fold = d.mcica_fold(inputs["air_temperature"])
    u = d.draw_mcica(fold, 8, 16)
    assert u[0].shape == (16, 8, 140) and u[1].shape == (16, 8, 112)
    assert not torch.equal(d.draw_mcica(fold + 1, 8, 16)[0], u[0])


def test_radiation_wrapper_schemes_match_reference(reference_call,
                                                   monkeypatch):
    """The wrapper's gray (float64) and synthband schemes against the
    reference's wrapper; its rrtmg scheme against the port's RRTMGDriver
    called directly (tests/test_torch_gfs_radiation.py holds the rrtmg
    wrapper, through the radiation stepper, against the reference)."""
    from fv3net_tpu.physics.radiation import Radiation as JRadiation
    from fv3net_tpu.physics.radiation import RadiationConfig as JConfig

    from fv3net_torch.physics.radiation.rrtmg.driver import (
        RRTMGConfig,
        RRTMGDriver,
    )

    state, cosz, want_sb, _ = reference_call
    reference_draws(monkeypatch)
    gray_state = {k: state[k] for k in (
        "air_temperature", "pressure_thickness_of_atmospheric_layer",
        "surface_temperature", "latitude", "longitude")}
    got = Radiation(RadiationConfig(scheme="gray"), 900.0, device="cpu")(
        TIME, {k: torch.tensor(v) for k, v in gray_state.items()})
    jgray = JRadiation(JConfig(scheme="gray"), 900.0)
    want = jax.jit(lambda x: jgray(TIME, x))(
        {k: jnp.asarray(v) for k, v in gray_state.items()})
    assert set(got) == set(want)
    for k in want:
        assert rel_diff(got[k].numpy(), np.asarray(want[k])) <= 1e-12, k
    # the synthband wrapper computes its own cosz from lat/lon
    sb = {k: torch.tensor(v) for k, v in state.items()}
    got = Radiation(RadiationConfig(scheme="synthband"), 900.0,
                    device="cpu")(TIME, sb)
    direct = RadiationDriver(DriverConfig(), device="cpu")(TIME, sb)
    assert set(got) == set(want_sb)
    for k in got:
        assert torch.equal(got[k], direct[k]), k
    with pytest.raises(ValueError, match="unknown radiation scheme"):
        Radiation(RadiationConfig(scheme="x"), 900.0, device="cpu")(TIME, sb)
    with pytest.raises(ValueError, match="unknown radiation scheme"):
        JRadiation(JConfig(scheme="x"), 900.0)(TIME, {})
    few = {k: v[:8] for k, v in sb.items()}
    got = Radiation(RadiationConfig(scheme="rrtmg"), 900.0,
                    dtype=torch.float64, device="cpu")(TIME, few)
    direct = RRTMGDriver(RRTMGConfig(), dtype=torch.float64,
                         device="cpu")(TIME, few)
    assert set(got) == set(direct)
    for k in got:
        assert torch.equal(got[k], direct[k]), k


# ------------------------------------------------------------ the step
def test_synthband_physics_step_matches_reference(monkeypatch):
    """One float64 physics step of a moist C4 state with the synthband
    radiation (float32 in both packages, the reference's draws handed
    in) against the reference's jitted step.  The radiation's float32
    roundoff (up to ~2e-4 of the SW heating's scale in either package,
    see test_radiation_driver_matches_reference) reaches T through
    dt * heating, and the condensation, at saturation, amplifies it in
    the cloud water (6.8e-7 of its scale here, T 3e-8): the state is
    held within 2e-6 of each field's scale, the four radiation
    diagnostics within 1e-3."""
    from fv3net_tpu.physics import PhysicsConfig as JPhysicsConfig
    from fv3net_tpu.physics import physics_step as jphysics_step
    from fv3net_tpu.runtime import fused as jfused

    from fv3net_torch.physics import PhysicsConfig, physics_step
    from fv3net_torch.runtime import fused

    reference_draws(monkeypatch)
    st, grid, _, _ = make_state_numpy(4, 8, seed=2, moist=True)
    st["tracers"]["cloud_water"] = np.where(
        np.random.RandomState(1).rand(*st["delp"].shape) < 0.3, 1e-4, 0.0)
    sst = 300.15 - 30 * np.sin(grid.lat) ** 2
    cosz = np.clip(np.cos(grid.lat) * np.cos(grid.lon), 0, 1)
    jcfg = JPhysicsConfig(radiation_scheme="synthband")
    jrad = jfused._build_radiation_fn(jcfg)
    want, dj = jax.jit(lambda s, *a: jphysics_step(
        s, *a, 900.0, jcfg, radiation_fn=jrad))(
        jax_state(st, jnp.float64), jnp.asarray(sst), jnp.asarray(cosz),
        jnp.asarray(grid.lat))
    cfg = PhysicsConfig(radiation_scheme="synthband")
    rad = fused._build_radiation_fn(cfg, "cpu", torch.float64)
    from fv3net_torch.dycore.state import state_from_numpy

    t = torch.tensor
    got, dt_ = physics_step(state_from_numpy(st), t(sst), t(cosz),
                            t(grid.lat), 900.0, cfg, radiation_fn=rad)
    assert_states_close(got, want, 2e-6)
    for k in ("ULWRFtoa", "USWRFtoa", "DSWRFsfc", "DLWRFsfc"):
        assert rel_diff(dt_[k].numpy(), np.asarray(dj[k])) <= 1e-3, k
    with pytest.raises(ValueError, match="radiation_fn"):
        physics_step(state_from_numpy(st), t(sst), t(cosz), t(grid.lat),
                     900.0, cfg)


# ------------------------------------------------------------ Held-Suarez
def test_held_suarez_matches_reference():
    from fv3net_tpu.physics import held_suarez as jhs

    from fv3net_torch.physics import held_suarez as hs

    rng = np.random.RandomState(6)
    st, grid, _, _ = make_state_numpy(4, 8, seed=1)
    delp = np.moveaxis(st["delp"], 1, -1)
    pe = 300.0 + np.cumsum(delp, axis=-1)
    pmid = pe - 0.5 * delp
    T = 250 + 40 * rng.rand(*pmid.shape)
    wind = np.stack([np.moveaxis(st["wind"][c], 1, -1) for c in range(3)])
    args = (T, wind, pmid, pe[..., -1], grid.lat)
    for p, jp in ((hs.HeldSuarezParams(), jhs.HeldSuarezParams()),
                  (hs.HeldSuarezParams(sigma_b=0.8, T_min=190.0),
                   jhs.HeldSuarezParams(sigma_b=0.8, T_min=190.0))):
        got = hs.held_suarez_forcing(*map(torch.tensor, args), 900.0, p)
        want = jax.jit(lambda *a: jhs.held_suarez_forcing(*a, 900.0, jp))(
            *map(jnp.asarray, args))
        for g, w in zip(got, want):
            assert rel_diff(g.numpy(), np.asarray(w)) <= 1e-14
        teq = hs.equilibrium_temperature(torch.tensor(pmid),
                                         torch.tensor(grid.lat)[..., None], p)
        jteq = jax.jit(lambda *a: jhs.equilibrium_temperature(*a, jp))(
            jnp.asarray(pmid), jnp.asarray(grid.lat)[..., None])
        assert rel_diff(teq.numpy(), np.asarray(jteq)) <= 1e-14
