"""fv3net_torch's RRTMG band solvers and driver held against fv3net_tpu's
on shared numpy inputs: ``lwrad`` / ``swrad`` against both of the
reference's k-table routes (its XLA form and its Pallas kernels in
interpret mode), the gas optics alone, and ``RRTMGDriver`` with the
reference's McICA draws handed to the port."""
import datetime
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    args, solcon, rand2d = _sw_inputs()
    targs = [torch.tensor(x) for x in args]
    T = tsw.prep_sw_tables(ttab.make_sw_tables(seed=1), dtype=torch.float64)
    for kw in (dict(compress_daylight=True), dict(fast_exp=False)):
        with pytest.raises(NotImplementedError):
            tsw.swrad(*targs, solcon, torch.tensor(rand2d), T, **kw)
    Tl = tlw.prep_lw_tables(ttab.make_lw_tables(seed=0))
    with pytest.raises(NotImplementedError):
        tlw.lwrad(*[torch.tensor(x) for x in _lw_inputs()], Tl,
                  fast_exp=False)
    for cfg in (tdrv.RRTMGConfig(fast_exp=False),
                tdrv.RRTMGConfig(column_block=4096)):
        with pytest.raises(NotImplementedError):
            tdrv.RRTMGDriver(cfg)


# ------------------------------------------------ float32 SW on the card
# swrad's arguments on the 8 columns where the float32 SW heating of the
# C48 RRTMG chunk (the state after 1 + 2 chunks of chip_smoke.py's phase
# 5) parts most from the float64 control, McICA draws included, as
# ``python3 chip_smoke.py --sw-columns PATH`` saved them on an NVIDIA H100
SW_COLUMNS_FILE = os.path.join(os.path.dirname(__file__), "data",
                               "sw_float32_columns.npz")
SW_COLUMN_ARGS = ("plyr", "plvl", "tlyr", "tlvl", "qlyr", "olyr", "gasvmr",
                  "clouds", "aerosols", "sfcalb", "delpin", "cosz")
# the float32 SW error the card showed there (K/day), to which the CPU's
# float32 solvers must come: the error is of the arithmetic, not of a
# rare input
SW_F32_ERR_MIN = 0.05
# each column's float32 SW heating error over its error with the layers'
# two-stream in float64 (the least the CPU shows is 14, in the reference)
SW_TWOSTREAM_SHARE = 8.0


def _sw_columns():
    d = np.load(SW_COLUMNS_FILE)
    tables = ttab.make_sw_tables()
    kw = dict(iovrsw=int(d["f32_iovrsw"]))
    rand = d["f32_rand2d"]
    return d, tables, int(d["nbase_hi"]), kw, rand


def _port_sw_columns(tag, dtype, twostream64=False):
    """The port's swrad on the file's ``tag`` ("f32" or "f64") arguments
    in ``dtype``; ``twostream64``: the layers' two-stream properties in
    float64, cast back."""
    d, tables, nbh, kw, rand = _sw_columns()
    T = tsw.prep_sw_tables(tables, dtype, nbase_hi=nbh)
    args = [torch.tensor(d[f"{tag}_{n}"], dtype=dtype)
            for n in SW_COLUMN_ARGS]
    orig = tsw._twostream

    def twostream(*a, **k):
        out = orig(*[x.double() if torch.is_tensor(x) else x for x in a],
                   **k)
        return tuple(x.to(dtype) for x in out)

    if twostream64:
        tsw._twostream = twostream
    try:
        out = tsw.swrad(*args, float(d[f"{tag}_solcon"]),
                        torch.tensor(rand, dtype=dtype), T, **kw)
    finally:
        tsw._twostream = orig
    return {k: v.double().numpy() for k, v in out.items()}


def _jax_sw_columns(twostream64=False):
    """The reference's float32 swrad on the file's float32 arguments, run
    eagerly; ``twostream64``: its layers' two-stream properties in
    float64, cast back (as ``_port_sw_columns`` does for the port)."""
    from fv3net_tpu.physics.radiation.rrtmg import sw as jsw

    d, tables, nbh, kw, rand = _sw_columns()
    T = jsw.prep_sw_tables(tables, dtype=jnp.float32, nbase_hi=nbh)
    orig = jsw._twostream

    def twostream(ztau0, zssa0, zasy0, cosz, sntz, *a, **k):
        out = orig(*[jnp.asarray(x, jnp.float64)
                     for x in (ztau0, zssa0, zasy0, cosz, sntz)], *a, **k)
        return tuple(x.astype(ztau0.dtype) for x in out)

    if twostream64:
        jsw._twostream = twostream
    try:
        out = _jax_route("off", lambda: jsw.swrad(
            *[jnp.asarray(d[f"f32_{n}"]) for n in SW_COLUMN_ARGS],
            float(d["f32_solcon"]), jnp.asarray(rand), T, fast_exp=True,
            compress_daylight=False, **kw))
    finally:
        jsw._twostream = orig
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def test_float32_sw_error_is_the_two_stream_and_inherited():
    """The float32 SW heating error of the card's C48 chunk (0.07-0.19
    K/day against float64, a 663-ulp flux divergence at level 3) on its
    worst columns: the reference's float32 swrad errs by the same order
    there, float64 on the float32 arguments reproduces the card's float64
    call, and with the layers' two-stream properties alone taken in
    float64 the error falls in every column, in both packages, and the
    two packages then agree within the float32 bound.  So the error is
    the float32 cancellation of the two-stream formula that both packages
    take from the reference (radsw_main.py:279-424; the thin top layers
    difference exponentials near 1), not a fault of the port.  The two
    float32 results part from each other by as much as each errs: two
    roundings of an ill-conditioned expression, the reference's fused in
    its layer scans."""
    d = _sw_columns()[0]
    exact = _port_sw_columns("f32", torch.float64)
    # the float64 call on the card, reproduced from its own arguments
    f64 = _port_sw_columns("f64", torch.float64)
    assert np.abs(f64["hswc"] - d["f64_out_hswc"]).max() <= (
        F64_RTOL * np.abs(d["f64_out_hswc"]).max())
    # float64 on the float32 arguments: what rounding the inputs moves
    assert np.abs(exact["hswc"] - f64["hswc"]).max() * 86400.0 <= 1e-4

    port = _port_sw_columns("f32", torch.float32)
    ref = _jax_sw_columns()

    def col_err(out, key="hswc", scale=86400.0):
        """Each column's largest error from ``exact``."""
        return np.abs(out[key] - exact[key]).max(axis=-1) * scale

    def err(out, key="hswc", scale=86400.0):
        return col_err(out, key, scale).max()

    e_port, e_ref = err(port), err(ref)
    assert e_port >= SW_F32_ERR_MIN and e_ref >= SW_F32_ERR_MIN, (
        e_port, e_ref)
    assert 0.25 <= e_ref / e_port <= 4.0, (e_port, e_ref)
    # the flux at the surface errs alike in both; each float32 TOA
    # up-flux within the float32 control's reading on the card (phase 6:
    # 0.282 W/m2)
    assert 0.25 <= err(ref, "fsfcdc", 1.0) / err(port, "fsfcdc", 1.0) <= 4
    assert max(err(port, "ftoauc", 1.0), err(ref, "ftoauc", 1.0)) <= 0.3
    # the two-stream in float64, in each package: the float32 error is
    # gone from every column, and each column's float32 error is at
    # least SW_TWOSTREAM_SHARE times what is left of it
    mixed = _port_sw_columns("f32", torch.float32, twostream64=True)
    ref_mixed = _jax_sw_columns(twostream64=True)
    for f32, m in ((port, mixed), (ref, ref_mixed)):
        assert err(m) <= 1e-3 and err(m, "ftoauc", 1.0) <= 1e-3
        assert (col_err(f32) >= SW_TWOSTREAM_SHARE * col_err(m)).all(), (
            col_err(f32), col_err(m))
    # and the two packages then agree, within the float32 bound and
    # column by column within 1e-3 K/day
    _compare(mixed, ref_mixed, SW_KEYS, "float32", "sw")
    assert (np.abs(mixed["hswc"] - ref_mixed["hswc"]).max(axis=-1)
            * 86400.0 <= 1e-3).all()


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
