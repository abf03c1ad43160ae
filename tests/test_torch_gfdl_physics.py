"""fv3net_torch's GFDL six-category microphysics, ozone photochemistry and
stratospheric water (``physics/microphysics_gfdl.py``, ``ozone.py``,
``h2ophys.py``) and ``physics_step`` with all three on a nonhydrostatic
state, held against fv3net_tpu's on shared numpy inputs (JAX on the
CPU, float64)."""
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

from fv3net_torch.dycore.state import state_from_numpy
from fv3net_torch.physics import PhysicsConfig, physics_step
from fv3net_torch.physics import h2ophys, ozone
from fv3net_torch.physics import microphysics_gfdl as tg

jax.config.update("jax_enable_x64", True)

# float64, the same operations in the same order: roundoff only
RTOL = 1e-12
SPECIES = ("qv", "ql", "qi", "qr", "qs", "qg")


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    # values that are zero up to roundoff in both compare absolutely
    assert rel_diff(got, want) <= rtol or np.abs(got - want).max() < 1e-18


def _columns(seed=0, n=48, nz=16):
    """Columns from 300 K (or, every other one, 255 K) at the surface to
    200 K aloft with all six water species, so that every warm and ice
    process acts and snow reaches the ground."""
    rng = np.random.RandomState(seed)
    ps = 1.0e5 + 2000.0 * rng.randn(n)
    sig = np.linspace(0.0, 1.0, nz + 1) ** 1.5
    pe = 300.0 + (ps[:, None] - 300.0) * sig[None]
    delp = np.diff(pe, axis=-1)
    pmid = delp / np.diff(np.log(pe), axis=-1)
    t0 = np.where(np.arange(n) % 2 == 0, 302.0, 257.0)[:, None]
    T = np.maximum(t0 * (pmid / 1.0e5) ** 0.2, 200.0) + 2 * rng.randn(n, nz)
    es = 610.94 * np.exp(17.625 * (T - 273.15) / (T - 273.15 + 243.04))
    qsat = 0.622 * es / (pmid - 0.378 * es)
    out = dict(T=T, qv=np.minimum(qsat * (0.7 + 0.5 * rng.rand(n, nz)), 0.03),
               p=pmid, delp=delp)
    for k, scale in zip(SPECIES[1:], (5e-4, 3e-4, 8e-4, 9e-4, 1e-3)):
        out[k] = scale * rng.rand(n, nz) * (rng.rand(n, nz) > 0.3)
    return out


def test_gfdl_microphysics_step_matches_reference():
    """Two subcycles of every process and the sedimentation of ice, rain,
    snow and graupel; the surface rain and frozen rates too."""
    from fv3net_tpu.physics import microphysics_gfdl as jg

    c = _columns()
    names = ("T",) + SPECIES + ("p", "delp")
    want = jg.gfdl_microphysics_step(*(jnp.asarray(c[k]) for k in names),
                                     900.0)
    got = tg.gfdl_microphysics_step(*(torch.tensor(c[k]) for k in names),
                                    900.0)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        _close(g, w)
    assert float(np.asarray(want[7]).max()) > 0  # it rains
    assert float(np.asarray(want[8]).max()) > 0  # and snows
    assert tg.GFDL_TRACER_NAMES == jg.GFDL_TRACER_NAMES


def test_ozone_and_h2o_tendencies_match_reference():
    from fv3net_tpu.physics import h2ophys as jh
    from fv3net_tpu.physics import ozone as jo

    c = _columns(seed=1)
    lat = np.random.RandomState(2).uniform(-1.5, 1.5, c["p"].shape[0])
    o3 = 5e-6 * np.random.RandomState(3).rand(*c["p"].shape)
    want = jo.ozone_tendency(jnp.asarray(o3), jnp.asarray(c["p"]),
                             jnp.asarray(lat))
    got = ozone.ozone_tendency(torch.tensor(o3), torch.tensor(c["p"]),
                               torch.tensor(lat))
    _close(got, want)
    want = jh.h2o_tendency(jnp.asarray(c["qv"]), jnp.asarray(c["p"]))
    got = h2ophys.h2o_tendency(torch.tensor(c["qv"]), torch.tensor(c["p"]))
    _close(got, want)
    assert float(np.abs(np.asarray(want)).max()) > 0


def _gfdl_state(npx=12, npz=16):
    """A convecting C12 state with the four GFDL tracers, o3mr and the
    nonhydrostatic w and delz."""
    from fv3net_tpu.dycore import nonhydro as jn
    from fv3net_tpu.physics.radiation import gases

    st, grid, _, _ = make_state_numpy(npx, npz, seed=2, moist=True)
    rng = np.random.RandomState(5)
    shape = st["delp"].shape
    for k, scale in zip(tg.GFDL_TRACER_NAMES, (2e-4, 3e-4, 4e-4, 2e-4)):
        st["tracers"][k] = scale * rng.rand(*shape)
    pe = 300.0 + np.concatenate([np.zeros_like(st["delp"][:, :1]),
                                 np.cumsum(st["delp"], axis=1)], axis=1)
    pmid = st["delp"] / np.diff(np.log(pe), axis=1)
    o3 = np.asarray(gases.ozone_profile(
        jnp.asarray(np.moveaxis(pmid, 1, -1)), jnp.asarray(grid.lat)))
    st["tracers"]["o3mr"] = np.moveaxis(o3, -1, 1) * (
        1.0 + 0.2 * rng.randn(*shape))
    st["delz"] = np.asarray(jn.hydrostatic_delz(
        jnp.asarray(st["delp"]), jnp.asarray(st["pt"]), 300.0))
    st["w"] = 0.1 * rng.randn(*shape)
    sst = 300.15 - 30.0 * np.sin(grid.lat) ** 2
    cosz = np.cos(grid.lat) * np.cos(grid.lon)
    return st, sst, cosz, grid.lat


def test_physics_step_gfdl_ozone_h2o_nonhydrostatic_matches_reference():
    """``physics_step`` with GFDL microphysics, stratospheric water, an
    o3mr tracer and a nonhydrostatic state, its radiation handed in as a
    ``radiation_fn`` that records what it is given: the liquid + ice
    condensate and the ozone.  The state (w passed through, delz
    expanded), every diagnostic and the recorded inputs agree."""
    from fv3net_tpu.physics import PhysicsConfig as JPhysicsConfig
    from fv3net_tpu.physics import physics_step as jphysics_step

    st, sst, cosz, lat = _gfdl_state()
    kw = dict(microphysics_scheme="gfdl", stratospheric_h2o=True,
              radiation_scheme="rrtmg")

    def radiation(xp):
        # its inputs come back among the step's diagnostics
        def fn(T, delp, q, qc, t_surface, cos_zenith, lat, o3=None,
               land=None, ice=None):
            heating = 1e-5 * (T / 250.0 - 1.0) + 0.05 * qc
            return heating, {"ULWRFtoa": xp.ones_like(t_surface),
                             "seen_qc": qc, "seen_o3": o3}
        return fn

    cfg = JPhysicsConfig(**kw)
    want, dj = jax.jit(lambda s, *a: jphysics_step(
        s, *a, 900.0, cfg, radiation_fn=radiation(jnp)))(
        jax_state(st, jnp.float64), jnp.asarray(sst), jnp.asarray(cosz),
        jnp.asarray(lat))
    got, dt_ = physics_step(
        state_from_numpy(st), torch.tensor(sst), torch.tensor(cosz),
        torch.tensor(lat), 900.0, PhysicsConfig(**kw),
        radiation_fn=radiation(torch))
    diffs = assert_states_close(got, want, RTOL)
    assert {"w", "delz", "o3mr", *tg.GFDL_TRACER_NAMES} <= set(diffs)
    assert dt_.keys() == dj.keys()
    for k in dj:
        _close(dt_[k], dj[k])
    ql = np.moveaxis(st["tracers"]["cloud_water"], 1, -1)
    qi = np.moveaxis(st["tracers"]["ice_wat"], 1, -1)
    _close(dt_["seen_qc"], ql + qi)
    _close(dt_["seen_o3"], np.moveaxis(st["tracers"]["o3mr"], 1, -1))
    assert not torch.equal(got.delz, torch.tensor(st["delz"]))
    assert torch.equal(got.w, torch.tensor(st["w"]))


def test_gfdl_mode_needs_its_tracers():
    st, sst, cosz, lat = _gfdl_state(npx=4, npz=8)
    del st["tracers"]["graupel"]
    args = (torch.tensor(sst), torch.tensor(cosz), torch.tensor(lat), 900.0)
    with pytest.raises(ValueError, match="graupel"):
        physics_step(state_from_numpy(st), *args,
                     PhysicsConfig(microphysics_scheme="gfdl"))
    with pytest.raises(ValueError, match="microphysics_scheme"):
        physics_step(state_from_numpy(st), *args,
                     PhysicsConfig(microphysics_scheme="thompson"))
