"""fv3net_torch's offline ops held against fv3net_tpu's on shared seeded
numpy inputs: the thermodynamics that ``ops/thermo.py`` gained, the wind
helpers, the vertical flux fit, the statistics, the vertical regrid to
coarse pressure levels (area and edge weighted, with and without
extrapolation), the interpolation to pressure levels, the lat-lon regrid
(``CubeToLatLon``, ``conservative_sum``, ``sample_points``,
``interpolate_unstructured``) and the spherical roundtrip filter on its
three grids; and the vertical search of ``remap_ppm``/``interpolate_1d``
against the comparison it replaced.

Float64 outputs agree within 1e-12 of each output's scale, float32
within 1e-5, with NaN at the same positions; tables built with numpy in
both packages agree bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

import torch_port_util  # noqa: F401,E402  (torch threads under xdist)

from fv3net_torch.grid.geometry import make_grid  # noqa: E402
from fv3net_torch.ops import regrid_latlon as tll  # noqa: E402
from fv3net_torch.ops import regridz as trz  # noqa: E402
from fv3net_torch.ops import remap as tremap  # noqa: E402
from fv3net_torch.ops import spherical as tsph  # noqa: E402
from fv3net_torch.ops import statistics as tstat  # noqa: E402
from fv3net_torch.ops import thermo as tth  # noqa: E402
from fv3net_torch.ops import vertical_flux as tvf  # noqa: E402
from fv3net_torch.ops import winds as twinds  # noqa: E402
from fv3net_tpu.ops import regrid_latlon as jll  # noqa: E402
from fv3net_tpu.ops import regridz as jrz  # noqa: E402
from fv3net_tpu.ops import spherical as jsph  # noqa: E402
from fv3net_tpu.ops import statistics as jstat  # noqa: E402
from fv3net_tpu.ops import thermo as jth  # noqa: E402
from fv3net_tpu.ops import vertical_flux as jvf  # noqa: E402
from fv3net_tpu.ops import winds as jwinds  # noqa: E402

RTOL = {"float64": 1e-12, "float32": 1e-5}
DTYPES = {"float64": (torch.float64, jnp.float64),
          "float32": (torch.float32, jnp.float32)}


def assert_close(got, want, rtol, label=""):
    """NaN at the same positions, and the other values within ``rtol`` of
    the output's scale (its largest finite magnitude)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), f"{label}: NaN positions"
    if (~nan).any():
        scale = max(np.abs(want[~nan]).max(), 1e-300)
        err = np.abs(got[~nan] - want[~nan]).max() / scale
        assert err <= rtol, f"{label}: {err} > {rtol} of scale"


def _pair(arrays, dtype):
    """The same numpy arrays as torch tensors and as jax arrays."""
    tdt, jdt = DTYPES[dtype]
    return ([torch.tensor(a, dtype=tdt) if isinstance(a, np.ndarray) else a
             for a in arrays],
            [jnp.asarray(a, jdt) if isinstance(a, np.ndarray) else a
             for a in arrays])


def _outputs(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


# ------------------------------------------------------------ thermo
def _thermo_cases():
    rng = np.random.default_rng(0)
    shape = (3, 4, 8)

    def u(lo, hi, s=shape):
        return lo + (hi - lo) * rng.random(s)

    T, q, p = u(220, 300), u(1e-4, 2e-2), u(5e3, 1e5)
    delp, delz = u(100, 2000), u(-800, -50)
    rho, rh = u(0.2, 1.2), u(0.1, 1.0)
    flux = [u(0, 400, shape[:-1]) for _ in range(8)]
    cond = [u(0, 1e-3) for _ in range(5)]
    v = rng.standard_normal((5, 8))
    return {
        "potential_temperature": (p, T),
        "temperature_from_potential_temperature": (p, T),
        "relative_humidity": (T, q, rho),
        "relative_humidity_from_pressure": (T, q, p),
        "specific_humidity_from_rh": (T, rh, rho),
        "density": (delp, delz),
        "pressure_thickness": (rho, delz),
        "internal_energy": (T,),
        "net_heating": tuple(flux) + (u(0, 1e-3, shape[:-1]),),
        "latent_heat_flux_to_evaporation": (flux[0],),
        "surface_evaporation_mm_day_from_latent_heat_flux": (flux[1],),
        "net_precipitation": (flux[2], u(0, 1e-3, shape[:-1])),
        "total_water": (q,) + tuple(cond),
        "liquid_ice_temperature": (T,) + tuple(cond),
        "mass_cumsum": (q, delp),
        "mass_divergence": (u(-1, 1, shape[:-1] + (9,)), delp),
        "pressure_at_midpoint": (delp,),
        "height_at_interface": (delz, u(0, 3e4, shape[:-1])),
        "height_at_midpoint": (delz, u(0, 3e4, shape[:-1])),
        "dz_and_top_to_phis": (u(2e4, 4e4, shape[:-1]), delz),
        "surface_pressure_from_delp": (delp,),
        "column_integrated_liquid_water_equivalent": (q, delp),
        "minus_column_integrated_moistening": (u(-1e-7, 1e-7), delp),
        "mass_streamfunction": (v, np.linspace(1e3, 1e5, 8),
                                np.linspace(-80, 80, 5)[:, None]),
        "_interface_to_midpoint": (u(0, 1, shape[:-1] + (9,)),),
    }


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(_thermo_cases()))
def test_thermo_matches_reference(name, dtype):
    args = _thermo_cases()[name]
    if name == "mass_streamfunction":  # the coordinates stay numpy
        t_args, j_args = _pair(args[:1], dtype)
        t_args, j_args = t_args + list(args[1:]), j_args + list(args[1:])
    else:
        t_args, j_args = _pair(args, dtype)
    got = getattr(tth, name)(*t_args)
    want = getattr(jth, name)(*j_args)
    assert got.dtype == DTYPES[dtype][0]
    assert_close(got, want, RTOL[dtype], name)


# ------------------------------------------------------------ winds, flux
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_winds_match_reference(dtype):
    rng = np.random.default_rng(1)
    xw, yw = rng.standard_normal((6, 5, 9, 8)), rng.standard_normal((6, 5, 8,
                                                                        9))
    coeffs = {k: rng.standard_normal((6, 1, 8, 8)) for k in (
        "eastward_wind_u_coeff", "eastward_wind_v_coeff",
        "northward_wind_u_coeff", "northward_wind_v_coeff")}
    east, north = rng.standard_normal((3, 6, 8, 8)), rng.standard_normal(
        (3, 6, 8, 8))
    wind = rng.standard_normal((3, 6, 8, 8))
    u, v = rng.standard_normal((6, 8, 8)), rng.standard_normal((6, 8, 8))
    (txw, tyw, te, tn, tw, tu, tv), (jxw, jyw, je, jn, jw, ju, jv) = _pair(
        [xw, yw, east, north, wind, u, v], dtype)
    tc = dict(zip(coeffs, _pair(list(coeffs.values()), dtype)[0]))
    jc = dict(zip(coeffs, _pair(list(coeffs.values()), dtype)[1]))
    calls = {
        "center_d_grid_winds": (lambda m, a: m.center_d_grid_winds(*a[:2])),
        "center_and_rotate_xy_winds": (
            lambda m, a: m.center_and_rotate_xy_winds(a[7], *a[:2])),
        "cartesian_to_local": (lambda m, a: m.cartesian_to_local(*a[4:5],
                                                                 *a[2:4])),
        "local_to_cartesian": (lambda m, a: m.local_to_cartesian(
            a[5], a[6], a[2], a[3])),
    }
    for name, call in calls.items():
        got = call(twinds, [txw, tyw, te, tn, tw, tu, tv, tc])
        want = call(jwinds, [jxw, jyw, je, jn, jw, ju, jv, jc])
        for i, (g, w) in enumerate(zip(_outputs(got), _outputs(want))):
            assert_close(g, w, RTOL[dtype], f"{name}[{i}]")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_vertical_flux_matches_reference(dtype):
    rng = np.random.default_rng(2)
    nz = 12
    field = rng.standard_normal((4, 5, nz)) * 1e-5
    delp = 500 + 1000 * rng.random((4, 5, nz))
    flux = rng.standard_normal((4, 5, nz + 1))
    first, last = rng.standard_normal((4, 5)), rng.standard_normal((4, 5))
    (tf, td, tfl, t0, t1), (jf, jd, jfl, j0, j1) = _pair(
        [field, delp, flux, first, last], dtype)
    assert_close(tvf.convergence_cell_center(tf, td),
                 jvf.convergence_cell_center(jf, jd), RTOL[dtype], "center")
    assert_close(tvf.convergence_cell_interface(tfl, td),
                 jvf.convergence_cell_interface(jfl, jd), RTOL[dtype],
                 "interface")
    got = tvf.fit_field_as_flux(tf, td, t0, t1)
    want = jvf.fit_field_as_flux(jf, jd, j0, j1)
    assert got.dtype == DTYPES[dtype][0]
    assert_close(got, want, RTOL[dtype], "fit_field_as_flux")
    # the fit's table is the reference's, bit for bit
    np.testing.assert_array_equal(tvf._interior_flux_pinv(nz, dtype),
                                  jvf._interior_flux_pinv(nz, dtype))


# ------------------------------------------------------------ statistics
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_statistics_match_reference(dtype):
    rng = np.random.default_rng(3)
    truth, pred = rng.standard_normal((6, 8, 8)), rng.standard_normal((6, 8,
                                                                       8))
    weights = rng.random((6, 8, 8))
    grid = make_grid(8)
    lat, lon, area = np.rad2deg(grid.lat), np.rad2deg(grid.lon), grid.area
    mask = rng.integers(0, 3, (6, 8, 8)).astype(np.float64)
    bt, bp = rng.random((6, 8, 8)) > 0.4, rng.random((6, 8, 8)) > 0.5
    (tt, tp, tw, tlat, tlon, tarea, tmask), (jt, jp, jw, jlat, jlon, jarea,
                                             jmask) = _pair(
        [truth, pred, weights, lat, lon, area, mask], dtype)
    bins = np.linspace(-2.0, 2.0, 9)
    box = jstat.RegionOfInterest((-30, 45), (300, 40)), tstat.RegionOfInterest(
        (-30, 45), (300, 40))
    calls = {
        "mse": lambda m, a: m.mean_squared_error(a[0], a[1]),
        "mse_axis_w": lambda m, a: m.mean_squared_error(a[0], a[1], -1, a[2]),
        "rmse": lambda m, a: m.root_mean_squared_error(a[0], a[1], (1, 2)),
        "bias": lambda m, a: m.bias(a[0], a[1], 0, a[2]),
        "r2": lambda m, a: m.r2_score(a[0], a[1], -1),
        "r2_all": lambda m, a: m.r2_score(a[0], a[1]),
        "weighted_mean": lambda m, a: m.weighted_mean(a[0], a[2], (-2, -1)),
        "weighted_average": lambda m, a: m.weighted_average(
            a[0], m.mask_to_surface_type(a[2], a[6], "land"), (-2, -1)),
        "local_time": lambda m, a: m.local_time(7.5, a[4]),
        "histogram": lambda m, a: m.histogram(a[0], bins),
        "histogram2d": lambda m, a: m.histogram2d(a[0], a[1], bins,
                                                  bins[::2]),
        "zonal": lambda m, a: m.zonal_average_approximate(a[0], a[3], a[5]),
        "zonal_bins": lambda m, a: m.zonal_average_approximate(
            a[0][None].expand(2, 6, 8, 8) if m is tstat else
            jnp.broadcast_to(a[0], (2, 6, 8, 8)), a[3], a[5],
            np.arange(-90, 91, 15.0)),
        "meridional": lambda m, a: m.meridional_average_approximate(
            a[0], a[4], a[5], np.arange(0, 361, 30.0)),
        "mask_sea": lambda m, a: m.mask_to_surface_type(a[0], a[6], "sea"),
        "mask_global": lambda m, a: m.mask_to_surface_type(a[0], a[6],
                                                           "global"),
        "region": lambda m, a: box[m is tstat].average(a[0], a[3], a[4],
                                                       a[5]),
        "region_mask": lambda m, a: box[m is tstat].mask(a[3], a[4]),
    }
    # the reference's calls compiled as one program: op by op, or one
    # program a call, they cost seconds here
    wants = jax.jit(lambda *a: {name: call(jstat, list(a))
                                for name, call in calls.items()})(
        jt, jp, jw, jlat, jlon, jarea, jmask)
    for name, call in calls.items():
        got = call(tstat, [tt, tp, tw, tlat, tlon, tarea, tmask])
        want = wants[name]
        for i, (g, w) in enumerate(zip(_outputs(got), _outputs(want))):
            if torch.is_tensor(g) and not g.is_floating_point():
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=name)
            else:
                assert_close(g, w, RTOL[dtype], f"{name}[{i}]")
    tb, jb = torch.tensor(bt), jnp.asarray(bt)
    tq, jq = torch.tensor(bp), jnp.asarray(bp)
    for name in ("accuracy", "precision", "recall", "true_positive_rate",
                 "false_positive_rate", "f1_score"):
        for axis in (None, -1):
            assert_close(getattr(tstat, name)(tb, tq, axis),
                         getattr(jstat, name)(jb, jq, axis), 1e-12,
                         f"{name} axis {axis}")


# ------------------------------------------------------------ regridz
def _columns(n=8, nz=12, seed=4, dtype="float64"):
    """Fine columns (6, y, x, z) on hybrid-like levels with a surface
    pressure that varies by some hPa from cell to cell, and a field."""
    rng = np.random.default_rng(seed)
    ps = 1.0e5 + 3000.0 * rng.standard_normal((6, n, n))
    frac = np.diff(np.linspace(0.0, 1.0, nz + 1) ** 1.5)
    delp = (ps[..., None] - 300.0) * frac
    field = 250.0 + 30.0 * rng.random((6, n, n, nz))
    area = make_grid(n).area * (1 + 0.3 * rng.random((6, n, n)))
    return delp, field, area


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("factor,extrapolate", [(2, False), (4, True)])
def test_regrid_area_weighted_matches_reference(factor, extrapolate, dtype):
    delp, field, area = _columns()
    (td, tf, ta), (jd, jf, ja) = _pair([delp, field, area], dtype)
    got, got_w = trz.regrid_to_area_weighted_pressure(
        {"f": tf}, td, ta, factor, extrapolate=extrapolate)
    want, want_w = jax.jit(lambda f, d, a: jrz.regrid_to_area_weighted_pressure(
        {"f": f}, d, a, factor, extrapolate=extrapolate))(jf, jd, ja)
    assert_close(got["f"], want["f"], RTOL[dtype], "regridded")
    np.testing.assert_array_equal(got_w.numpy() == 0,
                                  np.asarray(want_w) == 0)
    assert_close(got_w, want_w, RTOL[dtype], "masked weights")
    assert (got_w.numpy() == 0).any(), "no weight masked below the surface"


@pytest.mark.parametrize("edge,axis,dtype", [("x", -2, "float64"),
                                             ("y", -3, "float32")])
def test_regrid_edge_weighted_matches_reference(edge, axis, dtype):
    delp, field, area = _columns(seed=5)
    (td, tf, ta), (jd, jf, ja) = _pair([delp, field, area], dtype)
    t_st, j_st = trz.stagger_center_to_edge(td, axis), \
        jrz.stagger_center_to_edge(jd, axis)
    assert_close(t_st, j_st, RTOL[dtype], "staggered delp")
    got, got_w = trz.regrid_to_edge_weighted_pressure(
        {"f": tf}, td, ta, 2, edge=edge, extrapolate=True)
    want, want_w = jax.jit(lambda f, d, a: jrz.regrid_to_edge_weighted_pressure(
        {"f": f}, d, a, 2, edge=edge, extrapolate=True))(jf, jd, ja)
    assert_close(got["f"], want["f"], RTOL[dtype], "regridded")
    assert_close(got_w, want_w, RTOL[dtype], "masked weights")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_interpolate_to_pressure_levels_matches_reference(dtype):
    delp, field, _ = _columns(n=4, nz=16, seed=6)
    (td, tf), (jd, jf) = _pair([delp, field], dtype)
    got = trz.interpolate_to_pressure_levels(tf, td)
    want = jax.jit(jrz.interpolate_to_pressure_levels)(jf, jd)
    assert np.isnan(np.asarray(want)).any()  # levels outside the column
    assert_close(got, want, RTOL[dtype], "interpolated")
    levels = np.array([1000.0, 2.0e4, 5.0e4, 9.0e4, 1.2e5])
    got = trz.interpolate_to_pressure_levels(
        tf, td, torch.tensor(levels, dtype=tf.dtype), ptop=200.0)
    want = jax.jit(lambda f, d, lev: jrz.interpolate_to_pressure_levels(
        f, d, lev, ptop=200.0))(jf, jd, jnp.asarray(levels, jf.dtype))
    assert_close(got, want, RTOL[dtype], "interpolated, own levels")


# ------------------------------------------------------------ the search
def test_source_layer_equals_the_count_it_replaced():
    """``remap.source_layer`` (a binary search) against the comparison it
    replaced, at equal edges, targets equal to an edge and targets above
    and below the column: the same indices, and so remap_ppm's and
    interpolate_1d's results bit for bit."""
    rng = np.random.default_rng(7)
    edges = np.cumsum(rng.random((5, 3, 13)), axis=-1)
    edges[:, :, 4] = edges[:, :, 3]  # a layer of zero thickness
    targets = np.concatenate([
        edges[..., ::3],  # on an edge (also the doubled one)
        edges[..., :1] - 1.0,  # above the column
        edges[..., -1:] + 1.0,  # below it
        edges[..., :1] + (edges[..., -1:] - edges[..., :1])
        * rng.random((5, 3, 7)),
    ], axis=-1)
    te, tt = torch.tensor(edges), torch.tensor(targets)
    count = (te[..., None, :] <= tt[..., :, None]).sum(-1) - 1
    assert torch.equal(tremap.source_layer(te, tt), count)

    def count_remap(pe1, q1, pe2):
        orig = tremap.source_layer
        tremap.source_layer = lambda e, t: (
            e[..., None, :] <= t[..., :, None]).sum(-1) - 1
        try:
            return (tremap.remap_ppm(pe1, q1, pe2, iv=1, kord=1),
                    tremap.interpolate_1d(pe2, pe1, torch.cat(
                        [q1, q1[..., -1:]], -1)))
        finally:
            tremap.source_layer = orig

    q1 = torch.tensor(rng.standard_normal((5, 3, 12)))
    pe2 = torch.sort(tt[..., :13], dim=-1).values
    want = count_remap(te, q1, pe2)
    got = (tremap.remap_ppm(te, q1, pe2, iv=1, kord=1),
           tremap.interpolate_1d(pe2, te, torch.cat([q1, q1[..., -1:]], -1)))
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))


# ------------------------------------------------------------ lat-lon
@pytest.fixture(scope="module")
def latlon():
    grid = make_grid(8)
    return (grid, tll.CubeToLatLon(grid, 18, 36, device="cpu"),
            jll.CubeToLatLon(grid, 18, 36))


def test_latlon_tables_equal_the_reference(latlon):
    _, mine, ref = latlon
    for name in ("_box", "_w", "_fb_flat"):
        np.testing.assert_array_equal(getattr(mine, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(mine.lat, ref.lat)
    np.testing.assert_array_equal(mine.lon, ref.lon)
    assert_close(mine._den, ref._den, 1e-15, "_den")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_latlon_regrid_matches_reference(latlon, dtype):
    grid, mine, ref = latlon
    rng = np.random.default_rng(8)
    field = 280 + 10 * rng.standard_normal((3, 6, 8, 8))
    (tf,), (jf,) = _pair([field], dtype)
    assert_close(mine(tf), ref(jf), RTOL[dtype], "regrid")
    got, want = mine.conservative_sum(tf), ref.conservative_sum(jf)
    assert_close(got, want, RTOL[dtype], "conservative_sum")
    total = (field * grid.area).sum(axis=(-3, -2, -1))
    np.testing.assert_allclose(got.double().sum((-2, -1)).numpy(), total,
                               rtol=RTOL[dtype])
    lat, lon = rng.uniform(-89, 89, (4, 5)), rng.uniform(0, 360, (4, 5))
    assert_close(mine.sample_points(tf, lat, lon),
                 ref.sample_points(jf, lat, lon), 0.0, "sample_points")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_interpolate_unstructured_matches_reference(dtype):
    rng = np.random.default_rng(9)
    src = (rng.uniform(-90, 90, (6, 5)), rng.uniform(0, 360, (6, 5)))
    tgt = (rng.uniform(-90, 90, (7,)), rng.uniform(0, 360, (7,)))
    field = rng.standard_normal((2, 6, 5))
    (tf,), (jf,) = _pair([field], dtype)
    assert_close(tll.interpolate_unstructured(tf, src, tgt),
                 jll.interpolate_unstructured(jf, src, tgt), 0.0,
                 "interpolate_unstructured")


# ------------------------------------------------------------ spherical
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("grid,options", [
    ("equiangular", {}), ("legendre-gauss", {"lmax": 5}),
    ("lobatto", {"fraction_modes_kept": 0.5})])
def test_roundtrip_filter_matches_reference(grid, options, dtype):
    nlat, nlon = 12, 24
    mine = tsph.RoundTripFilter(nlat, nlon, grid=grid, device="cpu",
                                **options)
    ref = jsph.RoundTripFilter(nlat, nlon, grid=grid, **options)
    assert mine.lmax == ref.lmax
    np.testing.assert_array_equal(mine.x, ref.x)
    np.testing.assert_array_equal(mine.P.numpy(), np.asarray(ref._P))
    np.testing.assert_array_equal(mine.G.numpy(), np.asarray(ref._G))
    field = np.random.default_rng(10).standard_normal((2, nlat, nlon))
    (tf,), (jf,) = _pair([field], dtype)
    got = mine(tf)
    assert got.dtype == DTYPES[dtype][0]
    # the tables are float32 in both packages
    assert_close(got, ref(jf), 1e-5, "filtered")
    assert_close(tsph.roundtrip_filter(tf, grid=grid, **options),
                 jsph.roundtrip_filter(jf, grid=grid, **options), 1e-5,
                 "roundtrip_filter")
