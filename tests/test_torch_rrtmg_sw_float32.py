"""The float32 SW heating error of the card's C48 chunk, held on the
worst columns the card saved (``tests/data/sw_float32_columns.npz``,
written by ``python3 chip_smoke.py --sw-columns PATH``): the port's and
the reference's float32 ``swrad`` err alike, and the two-stream in
float64 takes the error away in both (split from
``test_torch_rrtmg.py`` so that pytest-xdist's ``--dist loadfile`` can
give the two files to two workers)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_port_util  # noqa: F401  (torch threads under xdist)

from test_torch_rrtmg import F64_RTOL, SW_KEYS, _compare, _jax_route

from fv3net_torch.physics.radiation.rrtmg import sw as tsw
from fv3net_torch.physics.radiation.rrtmg import tables as ttab

jax.config.update("jax_enable_x64", True)


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
