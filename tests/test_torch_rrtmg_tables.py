"""The RRTMG data of fv3net_torch held against fv3net_tpu's: the copied
numpy modules (spectral constants, synthetic k-tables, aerosol tables)
bitwise, and the radiation's input modules (gases, surface optics,
aerosols, solar geometry, the Sundqvist cloud fraction) on shared numpy
inputs at float64."""
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_torch.ops import zenith as tzen
from fv3net_torch.physics import microphysics as tmp
from fv3net_torch.physics.radiation import aerosols as taer
from fv3net_torch.physics.radiation import gases as tgas
from fv3net_torch.physics.radiation import optics as topt
from fv3net_torch.physics.radiation.rrtmg import driver as tdrv
from fv3net_torch.physics.radiation.rrtmg import params as tparams
from fv3net_torch.physics.radiation.rrtmg import tables as ttables

jax.config.update("jax_enable_x64", True)

# float64 on both sides; the remaining differences are libm roundoff
F64_RTOL = 1e-12


def _assert_tree_equal(got, want, path="tables"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}[{k!r}]")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, path
    np.testing.assert_array_equal(g, w, err_msg=path)


def test_params_equal_reference():
    from fv3net_tpu.physics.radiation.rrtmg import params as jparams

    names = sorted(k for k in vars(jparams) if k.isupper())
    assert names and names == sorted(k for k in vars(tparams) if k.isupper())
    for k in names:
        _assert_tree_equal(getattr(tparams, k), getattr(jparams, k), k)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["lw", "sw"])
def test_ktables_bitwise_equal_reference(kind, seed):
    from fv3net_tpu.physics.radiation.rrtmg import tables as jtables

    name = f"make_{kind}_tables"
    _assert_tree_equal(getattr(ttables, name)(seed=seed),
                       getattr(jtables, name)(seed=seed))


def test_aerosol_tables_bitwise_equal_reference():
    from fv3net_tpu.physics.radiation import aerosols as jaer
    from fv3net_tpu.physics.radiation.rrtmg import driver as jdrv

    np.testing.assert_array_equal(tdrv._SW_LAM_UM, jdrv._SW_LAM_UM)
    np.testing.assert_array_equal(tdrv._LW_LAM_UM, jdrv._LW_LAM_UM)
    _assert_tree_equal(
        taer.make_aerosol_tables(tdrv._SW_LAM_UM, tdrv._LW_LAM_UM),
        jaer.make_aerosol_tables(jdrv._SW_LAM_UM, jdrv._LW_LAM_UM),
    )


def _close(got, want, name):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= F64_RTOL * max(np.abs(want).max(), 1e-300), (name, err)


def _columns(C=40, L=12, seed=2):
    rng = np.random.default_rng(seed)
    plyr = np.sort(rng.uniform(3.0, 1000.0, (C, L)), axis=1)[:, ::-1].copy()
    T = 200.0 + 100.0 * rng.random((C, L))
    q = 0.02 * rng.random((C, L)) * (plyr / 1000.0) ** 2
    qc = 1e-4 * rng.random((C, L)) * (rng.random((C, L)) > 0.4)
    lat = rng.uniform(-1.5, 1.5, C)
    land = (rng.random(C) > 0.6).astype(np.float64) * rng.random(C)
    cosz = rng.uniform(-0.4, 1.0, C)
    return dict(plyr=plyr, T=T, q=q, qc=qc, lat=lat, land=land, cosz=cosz,
                rh=rng.random((C, L)), dz=rng.uniform(0.05, 2.0, (C, L)),
                ice=rng.random(C))


def test_radiation_inputs_match_reference():
    """gases, surface optics, solar geometry, the Sundqvist fraction and
    the aerosol optics (setaer) at float64."""
    from fv3net_tpu.ops import zenith as jzen
    from fv3net_tpu.physics import microphysics as jmp
    from fv3net_tpu.physics.radiation import aerosols as jaer
    from fv3net_tpu.physics.radiation import gases as jgas
    from fv3net_tpu.physics.radiation import optics as jopt
    from fv3net_tpu.physics.radiation.rrtmg import driver as jdrv

    c = _columns()
    t = {k: torch.tensor(v) for k, v in c.items()}
    j = {k: jnp.asarray(v) for k, v in c.items()}
    for year, ico2 in ((2016, 0), (2016, 1), (1990, 2)):
        assert tgas.co2vmr(year, ico2) == jgas.co2vmr(year, ico2)
    for k in ("CO2VMR_DEF", "CH4VMR_DEF", "N2OVMR_DEF", "O2VMR_DEF"):
        assert getattr(tgas, k) == getattr(jgas, k), k
    _close(tgas.ozone_profile(t["plyr"] * 100.0, t["lat"]),
           jgas.ozone_profile(j["plyr"] * 100.0, j["lat"]), "ozone")
    _close(topt.surface_emissivity(t["land"]),
           jopt.surface_emissivity(j["land"]), "emissivity")
    for ice in (None, "ice"):
        got = topt.surface_albedo(t["cosz"], t["land"],
                                  ice_frac=t[ice] if ice else None)
        want = jopt.surface_albedo(j["cosz"], j["land"],
                                   ice_frac=j[ice] if ice else None)
        for a, b, n in zip(got, want, ("direct", "diffuse")):
            _close(a, b, f"albedo {n} {ice}")
    _close(tmp.sundqvist_cloud_fraction(t["T"], t["q"], t["qc"],
                                        t["plyr"] * 100.0),
           jmp.sundqvist_cloud_fraction(j["T"], j["q"], j["qc"],
                                        j["plyr"] * 100.0), "sundqvist")

    for when in (datetime.datetime(2016, 7, 1),
                 datetime.datetime(2021, 1, 17, 5, 30)):
        days = tzen.days_from_2000(when)
        assert days == jzen.days_from_2000(when)
        assert tzen.solar_distance_factor(days) == pytest.approx(
            float(jzen.solar_distance_factor(days)), rel=1e-15)
        lon_deg = np.linspace(0.0, 359.0, c["lat"].shape[0])
        _close(tzen.cos_zenith_angle(days, torch.tensor(lon_deg),
                                     torch.rad2deg(t["lat"])),
               jzen.cos_zenith_angle(days, jnp.asarray(lon_deg),
                                     jnp.rad2deg(j["lat"])), "cosz")

    tab_t = taer.make_aerosol_tables(tdrv._SW_LAM_UM, tdrv._LW_LAM_UM)
    tab_j = jaer.make_aerosol_tables(jdrv._SW_LAM_UM, jdrv._LW_LAM_UM)
    for month in (1.0, 6.5, 11.7):
        _close(taer.component_mixing(t["land"], t["lat"], month),
               jaer.component_mixing(j["land"], j["lat"], month),
               f"mixing {month}")
        got = taer.setaer(t["plyr"], t["dz"], t["rh"], t["land"], t["lat"],
                          tab_t, 14, month=month)
        want = jaer.setaer(j["plyr"], j["dz"], j["rh"], j["land"], j["lat"],
                           tab_j, 14, month=month)
        for a, b, n in zip(got, want, ("aer_sw", "aer_lw", "aerodp")):
            _close(a, b, f"{n} {month}")
