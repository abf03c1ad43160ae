"""fv3net_torch's GFS radiation-driver chain and Python radiation stepper
held against fv3net_tpu's (float64, on the CPU): the chain's stages
(``fpvs``, ``julian_day``, ``Astronomy``, ``getgases``, ``progcld4``,
``setalb``, ``setemis``), the whole ``GFSRadiationDriver`` on seeded
columns that straddle day and night over land, sea and sea ice (the
same McICA uniforms handed to both), and the ``RadiationStepper`` on
RRTMG (both drivers in float64), with the port's per-step ``TimeLoop``
running it beside the model's own gray radiation.

The reference's chain and its stepper's driver call are compiled; each
reference run is shared between tests by a module-scoped fixture (the
reference's per-step TimeLoop, ~20 s to compile, is held against the
port's by tests/test_torch_segmented_run.py)."""
import datetime
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import make_state_numpy, rel_diff

from fv3net_torch.physics.radiation import gfs_driver as tg
from fv3net_torch.physics.radiation.rrtmg import tables

jax.config.update("jax_enable_x64", True)

C, L = 24, 16
JDATE = (2016, 7, 3, 12, 30, 0)
SOLHR = 12.5
# float64, one radiation call: roundoff of reassociated sums (the RRTMG
# tests' bound; the SW fluxes read 1.1e-12 of their scale here)
RTOL = 1e-10


def gfs_columns(seed=11):
    """Seeded GFS-layout columns (layer 0 at the surface): a tropopause
    bump, GFDL condensate and cloud amount in the free troposphere,
    slmsk cycling over sea, land and sea ice, longitudes all round the
    globe (day and night), snow on land and ice."""
    rng = np.random.default_rng(seed)
    prsi = np.linspace(101325.0, 30.0, L + 1)[None] * (
        1 + 0.02 * rng.standard_normal((C, 1)))
    prsi[:, -1] = 30.0
    prsl = 0.5 * (prsi[:, :-1] + prsi[:, 1:])
    tsfc = 270 + 30 * rng.random(C)
    tgrs = tsfc[:, None] + 16.0 * np.log(prsl / prsl[:, :1])
    tgrs += 12.0 * np.exp(-((np.log(prsl * 0.01) - np.log(2.0)) ** 2))
    tgrs = np.clip(tgrs + rng.normal(0, 0.3, tgrs.shape), 175.0, 315.0)
    q = 0.012 * (prsl / 101325.0) ** 2.5 * (0.3 + 1.3 * rng.random((C, 1)))
    o3 = 1.0e-6 * np.exp(-((np.log(prsl * 0.01) - np.log(20.0)) ** 2)
                         / 1.3) + 3.0e-8
    liq = np.where((prsl > 4.0e4) & (prsl < 9.0e4),
                   2.0e-5 * rng.random((C, L)), 0.0)
    ice = np.where((prsl > 1.5e4) & (prsl < 4.5e4),
                   1.2e-5 * rng.random((C, L)), 0.0)
    cldamt = np.clip(np.where(liq + ice > 1e-7,
                              0.3 + 0.7 * rng.random((C, L)), 0.0), 0, 1)
    qgrs = np.stack([q, o3, liq, ice, 0.2 * liq, 0.3 * ice, 0.1 * ice,
                     cldamt], -1)
    slmsk = (np.arange(C) % 3).astype(np.float64)
    sfcprop = {
        "tsfc": tsfc, "slmsk": slmsk,
        "snowd": np.where(slmsk > 0.5, 20.0 * rng.random(C), 0.0),
        "zorl": 10.0 + 90.0 * rng.random(C),
        "hprime": 200.0 * rng.random(C),
        "alvsf": 0.2 + 0.1 * rng.random(C),
        "alnsf": 0.3 + 0.1 * rng.random(C),
        "alvwf": 0.18 + 0.1 * rng.random(C),
        "alnwf": 0.28 + 0.1 * rng.random(C),
        "facsf": 0.5 * np.ones(C), "facwf": 0.5 * np.ones(C),
        "fice": np.where(slmsk > 1.5, 0.6 + 0.4 * rng.random(C), 0.0),
        "tisfc": np.where(slmsk > 1.5, 260.0 + 10.0 * rng.random(C), tsfc),
    }
    grid = {"xlat": np.deg2rad(rng.uniform(-80, 80, C)),
            "xlon": np.deg2rad(np.linspace(0, 360, C, endpoint=False))}
    statein = {"prsi": prsi, "prsl": prsl, "tgrs": tgrs, "qgrs": qgrs}
    return (statein, sfcprop, grid, rng.random((C, 140 * L)),
            rng.random((C, 112 * L)), rng.integers(1, 9, size=(360, 180)))


@pytest.fixture(scope="module")
def chains():
    """The reference's chain (compiled) and the port's on the same
    columns, tables and uniforms."""
    from fv3net_tpu.physics.radiation import gfs_driver as jg
    from fv3net_tpu.physics.radiation.rrtmg import tables as jtables

    statein, sfcprop, grid, rand_lw, rand_sw, idxems = gfs_columns()
    jd = jg.GFSRadiationDriver(jg.GFSDriverConfig(levs=L),
                               jtables.make_lw_tables(seed=0),
                               jtables.make_sw_tables(seed=1), idxems)
    jd.radupdate(JDATE, 900.0)
    want = jax.jit(lambda *a: jd(*a[:3], SOLHR, *a[3:]))(
        statein, sfcprop, grid, rand_lw, rand_sw)
    td = tg.GFSRadiationDriver(tg.GFSDriverConfig(levs=L),
                               tables.make_lw_tables(seed=0),
                               tables.make_sw_tables(seed=1), idxems,
                               device="cpu")
    td.radupdate(JDATE, 900.0)
    got = td(statein, sfcprop, grid, SOLHR, rand_lw, rand_sw)
    return want, got, (statein, sfcprop, grid, idxems)


def test_gfs_chain_stages_match_reference(chains):
    from fv3net_tpu.physics.radiation import gfs_driver as jg

    _, _, (statein, sfcprop, grid, idxems) = chains
    t = torch.tensor
    temps = np.linspace(170.0, 340.0, 997)  # beyond both table ends
    # the compiled reference contracts the table index's multiply-add
    assert rel_diff(tg.fpvs(t(temps)).numpy(),
                    np.asarray(jax.jit(jg.fpvs)(jnp.asarray(temps)))) <= 1e-14
    for ymd in ((2016, 7, 3), (1999, 12, 31), (2000, 2, 29), (1850, 1, 1)):
        assert tg.julian_day(*ymd) == jg.julian_day(*ymd)
    for jdate in (JDATE, (2016, 1, 1, 3, 0, 0), (2020, 12, 21, 18, 45, 0)):
        a = tg.Astronomy.update(jdate, 3600.0, 900.0)
        b = jg.Astronomy.update(jdate, 3600.0, 900.0)
        assert vars(a) == pytest.approx(vars(b), rel=1e-15, abs=1e-15)
        xlon, xlat = grid["xlon"], grid["xlat"]
        for got, want in zip(
                a.coszmn(t(xlon), t(np.sin(xlat)), t(np.cos(xlat)), SOLHR),
                jax.jit(b.coszmn, static_argnums=3)(
                    jnp.asarray(xlon), jnp.asarray(np.sin(xlat)),
                    jnp.asarray(np.cos(xlat)), SOLHR)):
            assert rel_diff(got.numpy(), np.asarray(want)) <= 1e-14
    np.testing.assert_array_equal(tg.getgases((C, L)).numpy(),
                                  np.asarray(jg.getgases((C, L))))
    rng = np.random.RandomState(0)
    prsl = statein["prsl"]
    plyr, tlyr = prsl * 0.01, statein["tgrs"]
    tvly = tlyr * (1 + 0.6 * statein["qgrs"][..., 0])
    delp = -np.diff(statein["prsi"] * 0.01, axis=1)
    clw = 1e-4 * rng.rand(C, L) * (rng.rand(C, L) > 0.3)
    cld = rng.rand(C, L) * (clw > 0)
    for lcnorm in (False, True):
        args = (plyr, tlyr, tvly, clw, 0 * clw, cld, grid["xlat"],
                sfcprop["slmsk"], delp)
        got = tg.progcld4(*map(t, args), lcnorm=lcnorm)
        want = jax.jit(functools.partial(jg.progcld4, lcnorm=lcnorm))(
            *map(jnp.asarray, args))
        assert rel_diff(got.numpy(), np.asarray(want)) <= 1e-14
    names = ("slmsk", "snowd", "zorl", "tsfc", "hprime", "alvsf", "alnsf",
             "alvwf", "alnwf", "facsf", "facwf", "fice", "tisfc")
    s = {k: sfcprop[k] for k in names}
    for cosz in (np.linspace(-0.2, 1.0, C), np.full(C, 0.3)):
        args = (s["slmsk"], s["snowd"], s["zorl"], cosz, s["tsfc"],
                s["hprime"], s["alvsf"], s["alnsf"], s["alvwf"],
                s["alnwf"], s["facsf"], s["facwf"], s["fice"], s["tisfc"])
        got = tg.setalb(*map(t, args))
        want = jax.jit(jg.setalb)(*map(jnp.asarray, args))
        assert rel_diff(got.numpy(), np.asarray(want)) <= 1e-15
    lon = np.deg2rad(np.linspace(-180, 360, C))  # box edges included
    lat = np.deg2rad(np.linspace(-90, 90, C))
    args = (lon, lat, s["slmsk"], s["snowd"], s["zorl"], s["tsfc"],
            s["hprime"])
    got = tg.setemis(*map(t, args), t(idxems))
    want = jax.jit(jg.setemis)(*map(jnp.asarray, args), jnp.asarray(idxems))
    # one ulp: the compiled snow blend may contract to a multiply-add (a
    # wrong 1-degree box would part by 0.01 or more)
    assert rel_diff(got.numpy(), np.asarray(want)) <= 1e-15


def test_gfs_radiation_driver_matches_reference(chains):
    """Every output of the chain within RTOL of its scale; the columns
    hold day and night, sea, land and sea ice."""
    want, got, (_, sfcprop, _, _) = chains
    assert set(got) == set(want)
    day = want["coszen"] > 1e-4
    assert 0 < int(day.sum()) < C
    assert {0.0, 1.0, 2.0} <= set(sfcprop["slmsk"])
    bad = {}
    for k in want:
        g, w = got[k], want[k]
        if not torch.is_tensor(g):  # solcon
            assert g == pytest.approx(float(w), rel=1e-15), k
            continue
        d = rel_diff(g.numpy(), np.asarray(w))
        if not d <= RTOL:
            bad[k] = d
    assert not bad, bad
    assert (got["htrsw"][~torch.tensor(np.asarray(day))] == 0).all()
    assert (got["htrlw"] != 0).all()


# ------------------------------------------------------------ the stepper
def _moist_state(npx=6, npz=8):
    """A moist seeded state with cloud in a third of the layers, a land
    cap north of 30 degrees and an aquaplanet surface temperature."""
    st, grid, _, _ = make_state_numpy(npx, npz, seed=5, moist=True)
    st["tracers"]["cloud_water"] = np.where(
        np.random.RandomState(2).rand(*st["delp"].shape) < 0.3, 5e-5, 0.0)
    sst = 300.15 - 30.0 * np.sin(grid.lat) ** 2
    return st, grid, {"surface_temperature": sst,
                      "ocean_surface_temperature": sst,
                      "land_sea_mask": (grid.lat > 0.5) * 1.0}


@pytest.fixture(scope="module")
def stepper_calls():
    """One call of each package's RadiationStepper (rrtmg, apply_heating)
    on the same moist C6 state: both RRTMG drivers in float64, the
    reference's call compiled, the port taking the reference's McICA
    draws."""
    from test_torch_rrtmg import jax_mcica_draws

    from fv3net_tpu.dycore.core import GridArrays as JGridArrays
    from fv3net_tpu.grid.geometry import make_grid as jmake_grid
    from fv3net_tpu.physics.radiation import Radiation as JRadiation
    from fv3net_tpu.physics.radiation import RadiationConfig as JConfig
    from fv3net_tpu.physics.radiation.rrtmg import driver as jdrv
    from fv3net_tpu.runtime.derived_state import DerivedState as JDerived
    from fv3net_tpu.runtime.derived_state import ModelState as JModelState
    from fv3net_tpu.runtime.steppers.radiation import (
        RadiationStepper as JRadiationStepper,
    )
    from torch_port_util import jax_state

    from fv3net_torch.dycore.core import GridArrays
    from fv3net_torch.dycore.state import state_from_numpy
    from fv3net_torch.grid.geometry import make_grid
    from fv3net_torch.physics.radiation import Radiation, RadiationConfig
    from fv3net_torch.physics.radiation.rrtmg import driver as tdrv
    from fv3net_torch.runtime.derived_state import DerivedState, ModelState
    from fv3net_torch.runtime.steppers.radiation import RadiationStepper

    st, _, sfc = _moist_state()
    time = datetime.datetime(2016, 8, 1, 6)
    jrad = JRadiation(JConfig(scheme="rrtmg"), 900.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdrv, "RRTMGDriver", functools.partial(
            jdrv.RRTMGDriver, dtype=jnp.float64))
        jrad.init_driver()
    driver = jrad._driver
    jrad._driver = lambda t, s: jax.jit(lambda x: driver(t, x))(s)
    jstate = JDerived(JModelState(
        dycore=jax_state(st, jnp.float64),
        surface={k: jnp.asarray(v) for k, v in sfc.items()}),
        JGridArrays.from_grid(jmake_grid(6), dtype=jnp.float64))
    want = JRadiationStepper(jrad, apply_heating=True)(time, jstate)
    tstate = DerivedState(ModelState(
        dycore=state_from_numpy(st),
        surface={k: torch.tensor(v) for k, v in sfc.items()}),
        GridArrays.from_grid(make_grid(6), dtype=torch.float64))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdrv.RRTMGDriver, "draw_mcica",
                   jax_mcica_draws(torch.float64))
        got = RadiationStepper(Radiation(
            RadiationConfig(scheme="rrtmg"), 900.0, dtype=torch.float64,
            device="cpu"), apply_heating=True)(time, tstate)
    return want, got


def test_radiation_stepper_matches_reference(stepper_calls):
    """The stepper's tendencies (dQ1), diagnostics (every flux and
    heating rate of the RRTMG wrapper, named as the reference's) and
    state updates, each within RTOL of its scale, with dims."""
    want, got = stepper_calls
    for g, w in zip(got, want):
        assert set(g) == set(w), sorted(set(g) ^ set(w))
        for k in w:
            assert g[k].dims == w[k].dims, k
            assert rel_diff(g[k].data.numpy(),
                            np.asarray(w[k].data)) <= RTOL, k
    tendencies, diags, _ = got
    assert torch.equal(tendencies["dQ1"].data, diags[
        "tendency_of_air_temperature_due_to_radiation"].data)
    for k in ("total_sky_upward_longwave_flux_at_top_of_atmosphere_python",
              "total_sky_downward_shortwave_flux_at_surface_python"):
        assert torch.isfinite(diags[k].data).all() and (
            diags[k].data > 0).any(), k


def test_radiation_stepper_in_the_per_step_loop(tmp_path, monkeypatch):
    """The loop runs the stepper (rrtmg, apply_heating) after the
    dynamics, beside the model's gray radiation, on the per-step path:
    its diagnostics reach the step's, its dQ1 is applied (the monitor's
    radiation tendency is dQ1 up to the cancellation of T + dt dQ1 - T),
    and the reference's stepper call is held by
    test_radiation_stepper_matches_reference."""
    from fv3net_torch.dycore.state import state_from_numpy
    from fv3net_torch.runtime import checkpoint, names
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.derived_state import ModelState
    from fv3net_torch.runtime.loop import TimeLoop
    from fv3net_torch.runtime.steppers.radiation import RadiationStepper

    st, _, sfc = _moist_state(4)
    checkpoint.save_state(ModelState(
        dycore=state_from_numpy(st),
        surface={k: torch.tensor(v) for k, v in sfc.items()}),
        datetime.datetime(2016, 8, 1), str(tmp_path / "ic"))
    cfg = get_config({
        "namelist": {"npx": 4, "npz": 8}, "duration_seconds": 900.0,
        "fused_chunk_steps": 4, "initial_conditions": str(tmp_path / "ic"),
        "radiation_scheme": {"kind": "python", "scheme": "rrtmg",
                             "apply_heating": True}})
    loop = TimeLoop(cfg, dtype=torch.float64, device="cpu")
    assert not loop.fusable() and loop._radiation_fn is None
    calls = []
    orig = RadiationStepper.__call__

    def record(self, time, state):
        out = orig(self, time, state)
        calls.append(out)
        return out

    monkeypatch.setattr(RadiationStepper, "__call__", record)
    (_, diags), = list(loop)
    (tendencies, sdiags, _), = calls
    for k, q in sdiags.items():
        if k != "tendency_of_air_temperature_due_to_radiation":
            assert torch.equal(diags[k].data, q.data), k
    dq1 = diags["dQ1_radiation"].data
    assert torch.equal(dq1, tendencies["dQ1"].data)
    assert rel_diff(diags["tendency_of_air_temperature_due_to_radiation"]
                    .data.numpy(), dq1.numpy()) <= 1e-9
    assert names.TEMP in diags and torch.isfinite(loop.state.dycore.pt).all()


def test_radiation_stepper_diagnostics_only_without_heating():
    """Without apply_heating the stepper returns no tendency, and the
    loop's per-step path runs it beside the model's radiation."""
    from fv3net_torch.runtime import factories
    from fv3net_torch.runtime.config import get_config
    from fv3net_torch.runtime.loop import TimeLoop

    cfg = get_config({"namelist": {"npx": 4, "npz": 8},
                      "duration_seconds": 900.0, "fused_chunk_steps": 4,
                      "radiation_scheme": {"kind": "python",
                                           "scheme": "synthband"}})
    stepper = factories.get_radiation_stepper(cfg, 900.0, device="cpu")
    assert not stepper.apply_heating
    loop = TimeLoop(cfg, dtype=torch.float64, device="cpu")
    assert not loop.fusable()
    (_, diags), = list(loop)
    assert "dQ1_radiation" not in diags
    assert "total_sky_upward_longwave_flux_at_top_of_atmosphere_python" in \
        diags
    with pytest.raises(ValueError, match="radiation stepper kind"):
        factories.get_radiation_stepper(get_config({
            "radiation_scheme": {"kind": "fortran"}}), 900.0)
