"""fv3net_torch's RRTMG band solvers and driver held against fv3net_tpu's
on shared numpy inputs: ``lwrad`` / ``swrad`` against both of the
reference's k-table routes (its XLA form and its Pallas kernels in
interpret mode), the gas optics alone, and ``RRTMGDriver`` with the
reference's McICA draws handed to the port.  The float32 SW test on the
card's columns is in ``test_torch_rrtmg_sw_float32.py``."""
import datetime
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (torch threads under xdist)

from test_rrtmg_oracle import _profiles

from fv3net_torch.physics.radiation.rrtmg import driver as tdrv
from fv3net_torch.physics.radiation.rrtmg import lw as tlw
from fv3net_torch.physics.radiation.rrtmg import params as P
from fv3net_torch.physics.radiation.rrtmg import sw as tsw
from fv3net_torch.physics.radiation.rrtmg import tables as ttab

jax.config.update("jax_enable_x64", True)

TORCH = {"float64": torch.float64, "float32": torch.float32}
ROUTES = ["off", "interpret"]  # the reference's set_pallas_ktable modes
# (dtype, route) of the whole-solver comparisons: the interpret route
# differs from the XLA one only inside the gas optics, so it runs at
# float64 alone (it is slow on the CPU)
CASES = [("float64", "off"), ("float32", "off"), ("float64", "interpret")]
LW_KEYS = ("hlwc", "hlw0", "upfxc_t", "upfx0_t", "upfxc_s", "upfx0_s",
           "dnfxc_s", "dnfx0_s")
SW_KEYS = ("hswc", "hsw0", "ftoauc", "ftoau0", "fsfcdc", "fsfcd0",
           "fsfcuc", "fsfcu0")
# float64: roundoff of reassociated sums, grown through the layer
# recurrences; float32: the bounds the reference holds its own k-table
# routes to (tests/test_pallas_ktable.py), as (rtol, atol in W/m2)
F64_RTOL = 1e-9
F32_TOL = {"lw": (3e-5, 3e-4), "sw": (5e-5, 5e-4)}
TAUMOL_RTOL = 1e-10
DRIVER_RTOL = 1e-9
LW_ARGS = ("plyr", "plvl", "tlyr", "tlvl", "qlyr", "olyr", "gasvmr",
           "clouds", "aerosols", "sfemis", "sfgtmp", "delp", "rand2d")


def _lw_inputs():
    return [_profiles()[k] for k in LW_ARGS]


def _sw_inputs():
    """The reference's SW route-test inputs (tests/test_pallas_ktable.py):
    the oracle battery with cosz (0.82, 0.47, 0.21, 0), so the last
    column is night."""
    pr = _profiles()
    C, L = pr["plyr"].shape
    rand2d = np.random.default_rng(11).random((C, P.NGPT_SW * L))
    cosz = np.array([0.82, 0.47, 0.21, 0.0])[:C]
    sfcalb = np.tile(np.array([[0.23, 0.21, 0.09, 0.07]]), (C, 1)) * (
        np.array([1.0, 0.6, 1.3, 0.4])[:C, None])
    aer = np.zeros((C, L, P.NBANDS_SW, 3))
    aer[..., 0] = 0.015 * (pr["plyr"] / 1013.0)[..., None]
    aer[..., 1] = 0.88
    aer[..., 2] = 0.66
    return ([pr["plyr"], pr["plvl"], pr["tlyr"], pr["tlvl"], pr["qlyr"],
             pr["olyr"], pr["gasvmr"], pr["clouds"], aer, sfcalb,
             pr["delp"], cosz], 1360.8, rand2d)


def _jax_route(route, fn, *args):
    """``fn(*args)`` on one of the reference's k-table routes, run eagerly
    as the reference's own route tests run it (tests/test_pallas_ktable):
    compiling ``lwrad`` whole on these 4-column inputs, more than once in
    a process, corrupts the heap of jaxlib 0.9.0's CPU client (the driver,
    compiled whole at 96 columns, does not)."""
    from fv3net_tpu.physics.radiation.rrtmg import lw as jlw

    jlw.set_pallas_ktable(route)
    try:
        return fn(*args)
    finally:
        jlw.set_pallas_ktable("auto")


def _capture(module, name, call):
    """Run ``call()`` with ``module.name`` wrapped; returns (its result,
    the first call's positional arguments, that call's result)."""
    orig = getattr(module, name)
    seen = []

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append((args, out))
        return out

    setattr(module, name, wrapped)
    try:
        result = call()
    finally:
        setattr(module, name, orig)
    return (result,) + seen[0]


@functools.lru_cache(maxsize=None)
def _jax_lw(dtype, route):
    """The reference's ``lwrad`` outputs on one k-table route, with the
    arguments and result of the ``taumol_lw`` call it made (each route
    and dtype runs once per process: the eager run is slow)."""
    from fv3net_tpu.physics.radiation.rrtmg import lw as jlw

    T = jlw.prep_lw_tables(ttab.make_lw_tables(seed=0), dtype=dtype)
    args = [jnp.asarray(x, dtype) for x in _lw_inputs()]
    out, targs, tout = _jax_route(route, lambda a: _capture(
        jlw, "taumol_lw", lambda: jlw.lwrad(*a, T, fast_exp=True)), args)
    return {k: np.asarray(v) for k, v in out.items()}, targs, tout


@functools.lru_cache(maxsize=None)
def _jax_sw(dtype, route):
    """As :func:`_jax_lw` for ``swrad`` and ``taumol_sw``."""
    from fv3net_tpu.physics.radiation.rrtmg import sw as jsw

    T = jsw.prep_sw_tables(ttab.make_sw_tables(seed=1), dtype=dtype)
    args, solcon, rand2d = _sw_inputs()
    args = [jnp.asarray(x, dtype) for x in args]
    out, targs, tout = _jax_route(route, lambda a, r: _capture(
        jsw, "taumol_sw", lambda: jsw.swrad(
            *a, solcon, r, T, fast_exp=True, compress_daylight=False)),
        args, jnp.asarray(rand2d, dtype))
    return {k: np.asarray(v) for k, v in out.items()}, targs, tout


@functools.lru_cache(maxsize=None)
def _port_lw(dtype):
    tdt = TORCH[dtype]
    T = tlw.prep_lw_tables(ttab.make_lw_tables(seed=0), dtype=tdt)
    out = tlw.lwrad(*[torch.tensor(x, dtype=tdt) for x in _lw_inputs()], T)
    return {k: v.numpy() for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _port_sw(dtype):
    tdt = TORCH[dtype]
    T = tsw.prep_sw_tables(ttab.make_sw_tables(seed=1), dtype=tdt)
    args, solcon, rand2d = _sw_inputs()
    out = tsw.swrad(*[torch.tensor(x, dtype=tdt) for x in args], solcon,
                    torch.tensor(rand2d, dtype=tdt), T)
    return {k: v.numpy() for k, v in out.items()}


def _compare(got, want, keys, dtype, kind):
    for k in keys:
        g, w = got[k], want[k]
        assert g.shape == w.shape, k
        if dtype == "float64":
            err = np.abs(g - w).max()
            assert err <= F64_RTOL * np.abs(w).max(), (k, err)
        else:
            rtol, atol = F32_TOL[kind]
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=k)


@pytest.mark.parametrize("dtype,route", CASES)
def test_lwrad_matches_reference(dtype, route):
    got, want = _port_lw(dtype), _jax_lw(dtype, route)[0]
    _compare(got, want, LW_KEYS, dtype, "lw")
    assert np.isfinite(got["totuflux"]).all()


@pytest.mark.parametrize("dtype,route", CASES)
def test_swrad_matches_reference(dtype, route):
    got, want = _port_sw(dtype), _jax_sw(dtype, route)[0]
    _compare(got, want, SW_KEYS, dtype, "sw")


def test_swrad_night_columns_are_zero():
    """cosz = 0 (the last column): every flux and heating rate is 0."""
    out = _port_sw("float64")
    for k in SW_KEYS + ("flxuc", "flxdc", "flxu0", "flxd0", "sfbmc",
                        "sfdfc", "suvbfc"):
        assert np.all(out[k][-1] == 0.0), k
        assert np.abs(out[k][:-1]).max() > 0.0, k


def _to_torch(x):
    """A reference input (array, or dict of arrays) as port tensors;
    integer arrays as int64."""
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    a = np.asarray(x)
    return torch.tensor(a.astype(np.int64) if a.dtype.kind in "iu" else a)


def _assert_rel(got, want, name, rtol=TAUMOL_RTOL):
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape, name
    err = np.abs(g - w).max()
    assert err <= rtol * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("route", ROUTES)
def test_taumol_lw_matches_reference(route):
    """(fracs, tautot) of the port's gas optics on the reference's own
    setcoef inputs, float64, against the reference's ``taumol_lw`` call
    inside its ``lwrad`` on that route."""
    _, (c, colamt, coldry, colbrd, wx, tauaer, _), want = _jax_lw(
        "float64", route)
    Tt = tlw.prep_lw_tables(ttab.make_lw_tables(seed=0), dtype=torch.float64)
    got = tlw.taumol_lw(_to_torch(c), *map(_to_torch, (colamt, coldry,
                                                       colbrd, wx, tauaer)),
                        Tt)
    for g, w, n in zip(got, want, ("fracs", "tautot")):
        _assert_rel(g, w, n)


@pytest.mark.parametrize("route", ROUTES)
def test_taumol_sw_matches_reference(route):
    """(sfluxzen, taug, taur) of the port's SW gas optics on the
    reference's own setcoef inputs, float64, against the reference's
    ``taumol_sw`` call inside its ``swrad`` on that route."""
    _, (c, colamt, colmol, _), want = _jax_sw("float64", route)
    Tt = tsw.prep_sw_tables(ttab.make_sw_tables(seed=1), dtype=torch.float64)
    got = tsw.taumol_sw(_to_torch(c), _to_torch(colamt), _to_torch(colmol),
                        Tt)
    for g, w, n in zip(got, want, ("sfluxzen", "taug", "taur")):
        _assert_rel(g, w, n)


def test_unported_options_raise():
    """Every RRTMG option this test once held to a raise runs
    (tests/test_torch_rrtmg_options.py holds them against the reference,
    tests/test_torch_taumol.py K2 under bf16 storage): daylight
    compression equals the full-width call here (4 columns, all solved),
    the lookup tables part from the direct exponentials within the
    reference's quantization bounds, a driver takes ``fast_exp=False``
    and a column block, and the LW megakernel route (K2) runs under bf16
    storage, within 0.05 W/m2 (and 1e-3) of the k-table route's fluxes:
    the two routes round the species taus differently, as the
    reference's do."""
    args, solcon, rand2d = _sw_inputs()
    targs = [torch.tensor(x) for x in args]
    T = tsw.prep_sw_tables(ttab.make_sw_tables(seed=1), dtype=torch.float64)
    full = tsw.swrad(*targs, solcon, torch.tensor(rand2d), T)
    packed = tsw.swrad(*targs, solcon, torch.tensor(rand2d), T,
                       compress_daylight=True)
    tables = tsw.swrad(*targs, solcon, torch.tensor(rand2d), T,
                       fast_exp=False)
    for k in SW_KEYS:
        assert torch.equal(full[k], packed[k]), k
        if not k.startswith("h"):
            np.testing.assert_allclose(tables[k], full[k], rtol=1e-3,
                                       atol=0.5, err_msg=k)
    Tl = tlw.prep_lw_tables(ttab.make_lw_tables(seed=0))
    lw_args = [torch.tensor(x) for x in _lw_inputs()]
    lw_fast = tlw.lwrad(*lw_args, Tl)
    lw_tables = tlw.lwrad(*lw_args, Tl, fast_exp=False)
    for k in LW_KEYS[2:]:
        np.testing.assert_allclose(lw_tables[k], lw_fast[k], rtol=5e-4,
                                   atol=0.2, err_msg=k)
    Tl32 = tlw.prep_lw_tables(ttab.make_lw_tables(seed=0), torch.float32)
    lw32 = [x.float() for x in lw_args]
    routes = {route: tlw.lwrad(*lw32, Tl32, taumol=route,
                               storage="bfloat16")
              for route in ("mega", "ktable")}
    for k in LW_KEYS[2:]:
        assert torch.isfinite(routes["mega"][k]).all(), k
        np.testing.assert_allclose(routes["mega"][k], routes["ktable"][k],
                                   rtol=1e-3, atol=0.05, err_msg=k)
    assert tdrv.RRTMGDriver(tdrv.RRTMGConfig(storage_dtype="bfloat16"),
                            device="cpu", lw_taumol="mega").lw_taumol == "mega"
    state, cosz = driver_state(C=6, L=8)
    when = datetime.datetime(2016, 7, 1)
    outs = [tdrv.RRTMGDriver(cfg, dtype=torch.float64, device="cpu")(
        when, {k: torch.tensor(v) for k, v in state.items()},
        cosz=torch.tensor(cosz))
        for cfg in (tdrv.RRTMGConfig(fast_exp=False),
                    tdrv.RRTMGConfig(fast_exp=False, column_block=4096),
                    tdrv.RRTMGConfig(fast_exp=False, column_block=4))]
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
        err = (outs[0][k] - outs[2][k]).abs().max()
        assert err <= 1e-12 * outs[0][k].abs().max(), k


# ---------------------------------------------------------------- driver
def jax_mcica_draws(dtype, seed=42):
    """A ``draw_mcica`` for the port that returns the reference driver's
    threefry uniforms (float32 runs draw in bfloat16, as the reference
    does)."""

    def draw(self, fold, ncol, nz):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
        jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
        rdt = jnp.bfloat16 if dtype == torch.float32 else jdt
        a = jax.random.uniform(key, (ncol, P.NGPT_LW * nz), dtype=rdt)
        b = jax.random.uniform(jax.random.fold_in(key, 1),
                               (ncol, P.NGPT_SW * nz), dtype=rdt)
        return tuple(torch.tensor(np.asarray(x.astype(jdt)),
                                  device=self.device) for x in (a, b))

    return draw


def driver_state(C=96, L=16, seed=0):
    """Columns on the hybrid coordinate (z index 0 = model top) with
    clouds in half the layers, and a cosz with night columns."""
    from fv3net_torch.dycore.vertical import hybrid_coordinate

    rng = np.random.RandomState(seed)
    ak, bk = hybrid_coordinate(L)
    pe = ak[None] + bk[None] * (1e5 + 1000 * rng.randn(C))[:, None]
    pmid = 0.5 * (pe[:, 1:] + pe[:, :-1])
    T = np.maximum(290 * (pmid / 1e5) ** 0.2, 200) + rng.randn(C, L)
    lat = rng.uniform(-1.4, 1.4, C)
    lon = rng.uniform(0, 6.28, C)
    state = {
        "air_temperature": T,
        "pressure_thickness_of_atmospheric_layer": np.diff(pe, axis=1),
        "specific_humidity": 0.01 * (pmid / 1e5) ** 3 * rng.rand(C, L),
        "cloud_water_mixing_ratio": 1e-4 * rng.rand(C, L) * (
            rng.rand(C, L) > 0.5),
        "surface_temperature": T[:, -1] + 1,
        "latitude": lat,
        "longitude": lon,
        "land_sea_mask": (rng.rand(C) > 0.7).astype(np.float64),
    }
    return state, np.clip(np.cos(lat) * np.cos(lon), -0.3, 1)


def test_driver_matches_reference(monkeypatch):
    """RRTMGDriver at float64, 96 columns x 16 levels: every output key
    against the reference, with the reference's McICA draws."""
    from fv3net_tpu.physics.radiation.rrtmg import driver as jdrv

    state, cosz = driver_state()
    when = datetime.datetime(2016, 7, 1)
    jd = jdrv.RRTMGDriver(jdrv.RRTMGConfig(), dtype=jnp.float64)
    want = jax.jit(lambda s, c: jd(when, s, cosz=c))(
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(cosz))
    monkeypatch.setattr(tdrv.RRTMGDriver, "draw_mcica",
                        jax_mcica_draws(torch.float64))
    td = tdrv.RRTMGDriver(tdrv.RRTMGConfig(), dtype=torch.float64,
                          device="cpu")
    got = td(when, {k: torch.tensor(v) for k, v in state.items()},
             cosz=torch.tensor(cosz))
    assert set(got) == set(want)
    for k in sorted(want):
        w = np.asarray(want[k])
        err = np.abs(got[k].numpy() - w).max()
        assert err <= DRIVER_RTOL * np.abs(w).max(), (k, err)
    assert (got["total_sky_downward_shortwave_flux_at_surface_python"]
            [torch.tensor(cosz) <= 1e-4] == 0).all()


def test_driver_default_draws():
    """The port's own draws: uniforms in [0, 1) of the compute dtype and
    the documented shapes, the same for the same fold, different for
    another."""
    td = tdrv.RRTMGDriver(tdrv.RRTMGConfig(), dtype=torch.float64,
                          device="cpu")
    lw, sw = td.draw_mcica(17, 5, 3)
    assert lw.shape == (5, P.NGPT_LW * 3) and sw.shape == (5, P.NGPT_SW * 3)
    assert lw.dtype == torch.float64
    assert 0.0 <= float(lw.min()) and float(lw.max()) < 1.0
    again = td.draw_mcica(17, 5, 3)
    assert torch.equal(lw, again[0]) and torch.equal(sw, again[1])
    assert not torch.equal(lw, td.draw_mcica(18, 5, 3)[0])


def test_driver_refuses_tensors_on_another_device():
    """A driver built on the CPU raises on state tensors (or a cosz) that
    lie on another device, rather than copying them to its own."""
    state, cosz = driver_state(C=4, L=4)
    td = tdrv.RRTMGDriver(tdrv.RRTMGConfig(), dtype=torch.float64,
                          device="cpu")
    when = datetime.datetime(2016, 7, 1)
    cpu = {k: torch.tensor(v) for k, v in state.items()}
    for name in ("air_temperature", "latitude"):
        moved = dict(cpu, **{name: cpu[name].to("meta")})
        with pytest.raises(ValueError, match=name):
            td(when, moved, cosz=torch.tensor(cosz))
    with pytest.raises(ValueError, match="cosz"):
        td(when, cpu, cosz=torch.tensor(cosz, device="meta"))
