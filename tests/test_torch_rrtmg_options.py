"""The RRTMG options of fv3net_torch held against fv3net_tpu's: the table
files (``rrtmg/io.py``), the lookup-table transmittances
(``fast_exp=False``), column blocking, SW daylight compression and the
bf16 storage mode (K4 and K3 in bfloat16), through ``RRTMGDriver`` on the
CPU with the reference's McICA draws handed to the port.

Each reference driver call is compiled once per process (``_ref``) and
shared between the tests that read it."""
import datetime
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (torch threads under xdist)

from test_rrtmg import NOON, profile
from test_torch_rrtmg import driver_state, jax_mcica_draws

from fv3net_torch.ops import ktable
from fv3net_torch.physics.radiation import aerosols as taer
from fv3net_torch.physics.radiation.rrtmg import driver as tdrv
from fv3net_torch.physics.radiation.rrtmg import io as tio
from fv3net_torch.physics.radiation.rrtmg import lw as tlw
from fv3net_torch.physics.radiation.rrtmg import sw as tsw
from fv3net_torch.physics.radiation.rrtmg import tables as ttab

jax.config.update("jax_enable_x64", True)

NCOL, NZ = 20, 24
WHEN = datetime.datetime(2016, 7, 1)
TORCH = {"float32": torch.float32, "float64": torch.float64}
# float64: roundoff of reassociated sums through the layer recurrences;
# float32: fluxes as the port's float32 solvers part from the reference's
# (tests/test_torch_rrtmg.py F32_TOL, its rtol doubled for the driver's
# longer chain), heating rates in K/day
F64_RTOL = 1e-9
F32_FLUX = (1e-4, 5e-4)
F32_HEATING_K_DAY = 5e-3
# the reference's bounds (tests/test_rrtmg.py): bf16 storage against
# float32 storage, blocked against unblocked
BF16_FLUX, BF16_HEATING_K_DAY = 1.0, 0.5
BLOCK_FLUX, BLOCK_HEATING = 0.01, 1e-6
# the reference's quantization bounds of its lookup tables against the
# direct exponentials (tests/test_rrtmg_oracle.py), (rtol, atol W/m2)
LUT_TOL = {"lw": (5e-4, 0.2), "sw": (1e-3, 0.5)}


def _is_heating(key):
    return "heating" in key or "tendency" in key


def _columns(kind):
    """(state, cosz) of the driver comparisons: "battery" is the columns of
    tests/test_torch_rrtmg.py (night columns, clouds in half the layers,
    land and sea), "profile" the reference's own bf16-storage test
    columns (tests/test_rrtmg.py, all lit at noon)."""
    if kind == "battery":
        return driver_state(C=NCOL, L=NZ)
    st = {k: np.asarray(v) for k, v in
          profile(ncol=NCOL, nz=NZ, qc_level=16).items()}
    return st, None


def _when(kind):
    return WHEN if kind == "battery" else NOON


@functools.lru_cache(maxsize=None)
def _ref(kind, dtype, compress=False, **cfg):
    """The reference driver's outputs, compiled whole; ``compress`` turns
    its SW daylight compression on (its FV3NET_SW_DAYLIGHT switch, read
    when the call is traced)."""
    from fv3net_tpu.physics.radiation.rrtmg import driver as jdrv
    from fv3net_tpu.physics.radiation.rrtmg import lw as jlw

    state, cosz = _columns(kind)
    jdt = jnp.float32 if dtype == "float32" else jnp.float64
    old = os.environ.get("FV3NET_SW_DAYLIGHT")
    os.environ["FV3NET_SW_DAYLIGHT"] = "on" if compress else "off"
    try:
        jd = jdrv.RRTMGDriver(jdrv.RRTMGConfig(**cfg), dtype=jdt)
        c = None if cosz is None else jnp.asarray(cosz, jdt)
        out = jax.jit(lambda s, c: jd(_when(kind), s, cosz=c))(
            {k: jnp.asarray(v, jdt) for k, v in state.items()}, c)
        return {k: np.asarray(v, np.float64) for k, v in out.items()}
    finally:
        # the reference's storage switch is process-wide
        jlw.set_storage_dtype("auto")
        if old is None:
            del os.environ["FV3NET_SW_DAYLIGHT"]
        else:
            os.environ["FV3NET_SW_DAYLIGHT"] = old


def _port(kind, dtype, **cfg):
    """The port's driver outputs on the CPU with the reference's draws."""
    tdt = TORCH[dtype]
    state, cosz = _columns(kind)
    orig = tdrv.RRTMGDriver.draw_mcica
    tdrv.RRTMGDriver.draw_mcica = jax_mcica_draws(tdt)
    try:
        td = tdrv.RRTMGDriver(tdrv.RRTMGConfig(**cfg), dtype=tdt,
                              device="cpu")
        c = None if cosz is None else torch.tensor(cosz, dtype=tdt)
        out = td(_when(kind), {k: torch.tensor(v, dtype=tdt)
                               for k, v in state.items()}, cosz=c)
    finally:
        tdrv.RRTMGDriver.draw_mcica = orig
    for v in out.values():
        assert v.dtype == tdt  # outputs stay in the compute dtype
    return {k: v.double().numpy() for k, v in out.items()}


def _rad_keys(out):
    return [k for k in sorted(out) if k.endswith("_python")
            or _is_heating(k)]


def _scaled(key, x):
    return x * 86400.0 if _is_heating(key) else x


def _assert_close(got, want, dtype, keys=None):
    for k in keys or sorted(want):
        g, w = got[k], want[k]
        assert g.shape == w.shape, k
        if dtype == "float64":
            err = np.abs(g - w).max()
            assert err <= F64_RTOL * np.abs(w).max(), (k, err)
        elif _is_heating(k):
            err = np.abs(g - w).max() * 86400.0
            assert err <= F32_HEATING_K_DAY, (k, err)
        elif k.endswith("_python"):
            np.testing.assert_allclose(g, w, rtol=F32_FLUX[0],
                                       atol=F32_FLUX[1], err_msg=k)


# ------------------------------------------------------------------- io
def test_table_files_read_by_both_packages(tmp_path):
    """Tables and McICA draws written by either package are read by the
    other unchanged, and a driver built on the loaded tables gives what
    it gives on the tables in memory."""
    from fv3net_tpu.physics.radiation.rrtmg import io as jio

    lw, sw = ttab.make_lw_tables(), ttab.make_sw_tables()
    for src, dst, name in ((tio, jio, "port"), (jio, tio, "reference")):
        d = str(tmp_path / name)
        src.dump_lw(lw, d)
        src.dump_sw(sw, d)
        rng = np.random.default_rng(3)
        lw_rand, sw_rand = rng.random((4, 140 * 8)), rng.random((4, 112 * 8))
        src.dump_random_numbers(d, 1, lw_rand, sw_rand)
        for want, got in ((lw, dst.load_lw(d)), (sw, dst.load_sw(d))):
            assert set(got) == set(want)
            for k in want:
                if isinstance(want[k], dict):
                    assert set(got[k]) == set(want[k]), k
                    for kk in want[k]:
                        np.testing.assert_array_equal(got[k][kk],
                                                      want[k][kk])
                else:
                    np.testing.assert_array_equal(got[k], want[k])
        back = dst.load_random_numbers(d, 1)
        np.testing.assert_array_equal(back["lw_rand"], lw_rand)
        np.testing.assert_array_equal(back["sw_rand"], sw_rand)

    state, cosz = driver_state(C=4, L=8)
    d = str(tmp_path / "reference")
    args = (WHEN, {k: torch.tensor(v) for k, v in state.items()})
    kw = dict(cosz=torch.tensor(cosz))
    mem = tdrv.RRTMGDriver(tdrv.RRTMGConfig(), dtype=torch.float64,
                           device="cpu")(*args, **kw)
    loaded = tdrv.RRTMGDriver(tdrv.RRTMGConfig(), lw_tables=tio.load_lw(d),
                              sw_tables=tio.load_sw(d), dtype=torch.float64,
                              device="cpu")(*args, **kw)
    for k in mem:
        assert torch.equal(mem[k], loaded[k]), k


# ------------------------------------------------- lookup-table transfer
# the reference's float64 lookup-table call with its daylight compression
# on, shared by the two tests it serves: its solved columns are its
# full-width ones (tests below), and the rest are night
REF_LUT64 = dict(compress=True, fast_exp=False)


@pytest.mark.parametrize("dtype,cfg,ref_cfg", [
    ("float64", dict(fast_exp=False), REF_LUT64),
    ("float32", dict(fast_exp=False, column_block=8),
     dict(fast_exp=False, column_block=8)),
])
def test_lookup_tables_match_reference(dtype, cfg, ref_cfg):
    """``fast_exp=False`` (the reference's quantized transmittance and
    exponential tables, LW and SW) against the reference's driver: float64
    to roundoff; float32 blocked in 8-column blocks (20 columns: a ragged
    tail of 4) within the float32 bound.  The tables part from the direct
    exponentials within the reference's own quantization bounds."""
    got = _port("battery", dtype, **cfg)
    _assert_close(got, _ref("battery", dtype, **ref_cfg), dtype,
                  _rad_keys(got))
    fast = _port("battery", dtype)
    for k in _rad_keys(got):
        if _is_heating(k) or "cos_zenith" in k:
            continue
        rtol, atol = LUT_TOL["lw" if "longwave" in k else "sw"]
        np.testing.assert_allclose(got[k], fast[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    assert any(not np.array_equal(got[k], fast[k]) for k in got)


def test_rtrnmc_and_twostream_take_the_reference_tables():
    """The LW transfer's and the SW two-stream's tables are the
    reference's, value for value."""
    from fv3net_tpu.physics.radiation.rrtmg import lw as jlw
    from fv3net_tpu.physics.radiation.rrtmg import sw as jsw

    for got, want in zip(tlw.make_rt_tables(torch.float64),
                         jlw._make_rt_tables(jnp.float64)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tsw.exp_table(torch.float64).numpy(),
                                  np.asarray(jsw._exp_tbl(jnp.float64)))


# ------------------------------------------------------- column blocking
def test_column_blocking_matches_reference_and_unblocked():
    """``column_block=8`` at 20 columns (blocks 8, 8 and a ragged 4): the
    port's blocked call against the reference's blocked driver within the
    float32 bound, and against the port's unblocked call within the
    reference's blocked-vs-unblocked bounds (0.01 W/m2, 1e-6 K/s)."""
    cfg = dict(fast_exp=False)
    blocked = _port("battery", "float32", column_block=8, **cfg)
    whole = _port("battery", "float32", column_block=0, **cfg)
    want = _ref("battery", "float32", fast_exp=False, column_block=8)
    _assert_close(blocked, want, "float32", _rad_keys(blocked))
    for k in blocked:
        err = np.abs(blocked[k] - whole[k]).max()
        assert err < (BLOCK_HEATING if _is_heating(k) else BLOCK_FLUX), (
            k, err)


# --------------------------------------------------- daylight compression
def test_compress_daylight_matches_reference_and_full_width():
    """SW on the daylit columns only (top-K of cosz, K = 16 of 20 columns,
    9 lit) against the reference's compressed driver (float64, lookup
    tables) to roundoff, and against the port's full-width call bit for
    bit: every column's arithmetic is its own."""
    assert tsw.daylight_k(NCOL) == 16
    got = _port("battery", "float64", compress_daylight=True, fast_exp=False)
    _assert_close(got, _ref("battery", "float64", **REF_LUT64), "float64",
                  _rad_keys(got))
    full = _port("battery", "float64", fast_exp=False)
    for k in got:
        assert np.array_equal(got[k], full[k]), k


def test_compress_daylight_keeps_every_lit_column():
    """More lit columns than the reference's fixed K: the port widens K
    and solves them all, where a fixed K would zero the last lit ones."""
    args, solcon, rand = _sw_args(ncol=20)
    cosz = torch.linspace(0.9, 0.05, 20, dtype=torch.float64)  # all lit
    T = tsw.prep_sw_tables(ttab.make_sw_tables(seed=1), torch.float64)
    full = tsw.swrad(*args, cosz, solcon, rand, T)
    packed = tsw.swrad(*args, cosz, solcon, rand, T, compress_daylight=True)
    for k in full:
        assert torch.equal(full[k], packed[k]), k


def _sw_args(ncol):
    """swrad's arguments but cosz on ``ncol`` columns of the battery."""
    from test_torch_rrtmg import _sw_inputs

    args, solcon, rand2d = _sw_inputs()
    reps = -(-ncol // args[0].shape[0])

    def tile(x):
        return torch.tensor(np.concatenate([x] * reps)[:ncol])

    return ([tile(x) for x in args[:-1]], solcon,
            tile(np.asarray(rand2d)))


# ------------------------------------------------------- bf16 storage
def test_setaer_bf16_equals_reference_op_by_op():
    """The aerosol optics in the bf16 storage mode round where the
    reference's do: equal bit for bit to the reference's ``setaer`` run op
    by op under ``set_storage_dtype("bfloat16")``."""
    from fv3net_tpu.physics.radiation import aerosols as jaer
    from fv3net_tpu.physics.radiation.rrtmg import lw as jlw

    args, tables = _setaer_args()
    jlw.set_storage_dtype("bfloat16")
    try:
        want = jaer.setaer(*[jnp.asarray(a, jnp.float32) for a in args],
                           tables, 14, month=7.0)
    finally:
        jlw.set_storage_dtype("auto")
    got = taer.setaer(*[torch.tensor(a, dtype=torch.float32) for a in args],
                      tables, 14, month=7.0, storage=torch.bfloat16)
    for g, w in zip(got, want):
        assert str(w.dtype) == str(g.dtype).replace("torch.", "")
        np.testing.assert_array_equal(g.double().numpy(),
                                      np.asarray(w, np.float64))


def _setaer_args():
    rng = np.random.default_rng(0)
    plyr = np.sort(rng.uniform(5, 1000, (NCOL, NZ)), axis=1)[:, ::-1]
    delz = rng.uniform(0.05, 2.0, (NCOL, NZ))
    rh = rng.uniform(0, 1, (NCOL, NZ))
    land = (rng.random(NCOL) > 0.5) * 1.0
    lat = rng.uniform(-1.4, 1.4, NCOL)
    return ((plyr.copy(), delz, rh, land, lat),
            taer.make_aerosol_tables(tdrv._SW_LAM_UM, tdrv._LW_LAM_UM))


def _reference_aerosols(monkeypatch):
    """Hand the port's driver the reference's compiled bf16 aerosol optics
    (of the port's own arguments): compiled, the reference rounds fewer of
    its bf16 intermediates than it does op by op (XLA keeps some in
    float32 within a fusion), which the port cannot follow; the test
    above holds the port to the op-by-op form."""
    from fv3net_tpu.physics.radiation import aerosols as jaer
    from fv3net_tpu.physics.radiation.rrtmg import lw as jlw

    orig = taer.setaer

    def setaer(*args, storage=None, **kw):
        if storage is None:
            return orig(*args, storage=storage, **kw)
        jlw.set_storage_dtype("bfloat16")
        try:
            out = jax.jit(lambda *a: jaer.setaer(*a, args[5], args[6], **kw))(
                *[jnp.asarray(a.numpy()) for a in args[:5]])
        finally:
            jlw.set_storage_dtype("auto")
        return tuple(torch.tensor(np.asarray(o, np.float32)).to(
            torch.bfloat16 if o.dtype == jnp.bfloat16 else torch.float32)
            for o in out)

    monkeypatch.setattr(taer, "setaer", setaer)


def test_bf16_storage_matches_reference(monkeypatch):
    """``storage_dtype="bfloat16"`` against the reference's bf16 storage
    mode on the reference's own test columns: the port's bf16 call parts
    from the reference's by no more than the reference's parts from its
    own float32 call (plus what the two float32 calls part by), with the
    reference's aerosol optics in both (see ``_reference_aerosols``); and
    the port's bf16 call, with its own aerosol optics, within the
    reference's bounds of its float32 call (1 W/m2, 0.5 K/day), as the
    reference's is of its own."""
    r32 = _ref("profile", "float32")
    r16 = _ref("profile", "float32", storage_dtype="bfloat16")
    p32 = _port("profile", "float32")
    p16 = _port("profile", "float32", storage_dtype="bfloat16")
    _reference_aerosols(monkeypatch)
    p16_ref_aer = _port("profile", "float32", storage_dtype="bfloat16")
    for k in _rad_keys(r16):
        ref_part = np.abs(r16[k] - r32[k]).max()
        f32_part = np.abs(p32[k] - r32[k]).max()
        assert np.abs(p16_ref_aer[k] - r16[k]).max() <= ref_part + f32_part, k
        bound = BF16_HEATING_K_DAY if _is_heating(k) else BF16_FLUX
        for a, b in ((r16, r32), (p16, p32), (p16, r32)):
            assert _scaled(k, np.abs(a[k] - b[k]).max()) < bound, k
    # the mode is on: the bf16 call parts from the float32 one
    assert any(np.abs(p16[k] - p32[k]).max() > 0 for k in _rad_keys(p16))


def test_bf16_storage_selections_run_the_bf16_instances():
    """In the bf16 storage mode every k-table selection reads a bfloat16
    table with bfloat16 weights (the kernels' bfloat16 instances on the
    card), and a float64 driver is never degraded."""
    seen = []
    orig_sel, orig_spec = ktable.weighted_select_dot, ktable.spec_band_dot

    def sel(terms, tab, impl=None):
        seen.append(("K4", tab.dtype, {w.dtype for _, w in terms
                                       if w is not None}))
        return orig_sel(terms, tab, impl)

    def spec(w_paths, s_paths, tab, nspa, impl=None):
        seen.append(("K3", tab.dtype, {w.dtype for p in w_paths + s_paths
                                       for _, w in p if w is not None}))
        return orig_spec(w_paths, s_paths, tab, nspa, impl)

    state, cosz = driver_state(C=4, L=8)
    ktable.weighted_select_dot, ktable.spec_band_dot = sel, spec
    try:
        for dtype, want in ((torch.float32, torch.bfloat16),
                            (torch.float64, torch.float64)):
            seen.clear()
            d = tdrv.RRTMGDriver(tdrv.RRTMGConfig(storage_dtype="bf16"),
                                 dtype=dtype, device="cpu")
            d(WHEN, {k: torch.tensor(v, dtype=dtype)
                     for k, v in state.items()},
              cosz=torch.tensor(cosz, dtype=dtype))
            calls = [c for c in seen if c[1] == want]
            # the solar source's lerps stay exact, as the reference's
            assert len(calls) == len(seen) - 7 * (dtype == torch.float32)
            assert all(ws <= {want} for _, _, ws in calls)
            n3 = sum(c[0] == "K3" for c in calls)
            assert n3 == (35 if want == torch.bfloat16 else 23)
    finally:
        ktable.weighted_select_dot, ktable.spec_band_dot = orig_sel, orig_spec


# ---------------------------------------------------------------- config
def test_config_takes_the_reference_fields():
    """Every field of the reference's RRTMGConfig, with its names; the
    ones without effect here validated as the reference validates them;
    the storage names and "auto" resolved as the reference's."""
    from fv3net_tpu.physics.radiation.rrtmg import driver as jdrv
    import dataclasses

    names = {f.name for f in dataclasses.fields(tdrv.RRTMGConfig)}
    assert {f.name for f in dataclasses.fields(jdrv.RRTMGConfig)} <= names
    tdrv.RRTMGDriver(tdrv.RRTMGConfig(
        matmul_precision="highest", scan_unroll=0), device="cpu")
    # the reference's options together run, blocked as unblocked
    state, cosz = driver_state(C=12, L=8)
    args = (WHEN, {k: torch.tensor(v, dtype=torch.float32)
                   for k, v in state.items()})
    kw = dict(cosz=torch.tensor(cosz, dtype=torch.float32))
    outs = [tdrv.RRTMGDriver(tdrv.RRTMGConfig(
        fast_exp=False, storage_dtype="bfloat16", column_block=blk),
        device="cpu")(*args, **kw) for blk in (8, 0)]
    for k in outs[0]:
        assert torch.isfinite(outs[0][k]).all(), k
        err = (outs[0][k] - outs[1][k]).abs().max().item()
        assert err <= (BLOCK_HEATING if _is_heating(k) else BLOCK_FLUX), k
    with pytest.raises(ValueError, match="matmul_precision"):
        tdrv.RRTMGDriver(tdrv.RRTMGConfig(matmul_precision="fast"),
                         device="cpu")
    with pytest.raises(ValueError):
        tdrv.RRTMGDriver(tdrv.RRTMGConfig(scan_unroll="full"), device="cpu")
    with pytest.raises(ValueError, match="storage_dtype"):
        tdrv.RRTMGDriver(tdrv.RRTMGConfig(storage_dtype="fp8"),
                         device="cpu")
    res = tlw.resolve_storage
    f32, f64, bf = torch.float32, torch.float64, torch.bfloat16
    for name in ("float32", "f32", "none", None):
        assert res(name, f32, "cuda") is None
    for name in ("bfloat16", "bf16", "BF16", bf):
        assert res(name, f32, "cpu") is bf
        assert res(name, f64, "cpu") is None  # float64 never degraded
    for name in ("auto", ""):
        assert res(name, f32, "cpu") is None
        assert res(name, f32, "cuda") is bf
        assert res(name, f64, "cuda") is None
    # the port's default stays float32 storage, per driver
    assert tdrv.RRTMGDriver(device="cpu").storage is None
