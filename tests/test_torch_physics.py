"""fv3net_torch's column physics held against fv3net_tpu's on shared numpy
inputs (JAX on the CPU, float64): each scheme on random columns, and the
whole ``physics_step`` on a convecting C12 state."""
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
from fv3net_torch.ops import thermo as tt
from fv3net_torch.physics import PhysicsConfig, physics_step

jax.config.update("jax_enable_x64", True)

# f64: the packages differ only in summation order and in gathers written
# as one-hot sums in the reference
RTOL = 1e-10


def _columns(seed=0, n=40, nz=16):
    """Random but physical columns: T, q, qc, delp, pmid (z last)."""
    rng = np.random.RandomState(seed)
    ps = 1.0e5 + 2000.0 * rng.randn(n)
    sig = np.linspace(0.0, 1.0, nz + 1) ** 1.5
    pe = 300.0 + (ps[:, None] - 300.0) * sig[None]
    delp = np.diff(pe, axis=-1)
    pmid = delp / np.diff(np.log(pe), axis=-1)
    T = np.maximum(300.0 * (pmid / 1.0e5) ** 0.22, 205.0) + rng.randn(n, nz)
    es = 610.94 * np.exp(17.625 * (T - 273.15) / (T - 273.15 + 243.04))
    qsat = 0.622 * es / (pmid - 0.378 * es)
    q = np.minimum(qsat * (0.6 + 0.5 * rng.rand(n, nz)), 0.03)
    qc = 2e-4 * rng.rand(n, nz)
    return dict(T=T, q=q, qc=qc, delp=delp, pmid=pmid, pe=pe, rng=rng)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    # values that are zero up to roundoff in both compare absolutely
    assert rel_diff(got, want) <= rtol or np.abs(got - want).max() < 1e-18


def test_thermo_matches_reference():
    from fv3net_tpu.ops import thermo as jt

    c = _columns()
    for name in ("pressure_at_interface", "pressure_at_midpoint_log"):
        _close(getattr(tt, name)(_t(c["delp"])),
               getattr(jt, name)(jnp.asarray(c["delp"])))
    _close(tt.hydrostatic_dz(_t(c["T"]), _t(c["q"]), _t(c["delp"])),
           jt.hydrostatic_dz(jnp.asarray(c["T"]), jnp.asarray(c["q"]),
                             jnp.asarray(c["delp"])))
    _close(tt.virtual_temperature(_t(c["T"]), _t(c["q"])),
           jt.virtual_temperature(jnp.asarray(c["T"]), jnp.asarray(c["q"])))
    _close(tt.layer_mass(_t(c["delp"])), jt.layer_mass(jnp.asarray(c["delp"])))
    dq2 = 1e-6 * c["rng"].randn(*c["q"].shape)
    dq1 = 1e-4 * c["rng"].randn(*c["q"].shape)
    for g, w in zip(
        tt.non_negative_sphum_mse_conserving(_t(c["q"] * 0.01), _t(dq2), 900.0,
                                             q1=_t(dq1)),
        jt.non_negative_sphum_mse_conserving(jnp.asarray(c["q"] * 0.01),
                                             jnp.asarray(dq2), 900.0,
                                             q1=jnp.asarray(dq1)),
    ):
        _close(g, w)


def test_gray_radiation_matches_reference():
    from fv3net_tpu.physics import radiation_gray as jr
    from fv3net_torch.physics import radiation_gray as tr

    c = _columns(1)
    tsfc = 290.0 + 10.0 * c["rng"].rand(40)
    cosz = c["rng"].rand(40) * 2 - 0.5
    lat = c["rng"].rand(40) * 3 - 1.5
    hj, dj = jr.gray_radiation(*map(jnp.asarray, (c["T"], c["delp"], tsfc,
                                                 cosz, lat)))
    ht, dt_ = tr.gray_radiation(*map(_t, (c["T"], c["delp"], tsfc, cosz, lat)))
    _close(ht, hj)
    assert dt_.keys() == dj.keys()
    for k in dj:
        _close(dt_[k], dj[k])


def test_surface_and_pbl_match_reference():
    from fv3net_tpu.physics import pbl as jp
    from fv3net_tpu.physics import surface as js
    from fv3net_tpu.physics import surface_layer as jsl
    from fv3net_torch.physics import pbl as tp
    from fv3net_torch.physics import surface as ts
    from fv3net_torch.physics import surface_layer as tsl

    c = _columns(2)
    rng = c["rng"]
    speed = 10.0 * rng.rand(40)
    tsfc = c["T"][:, -1] + 4.0 * rng.randn(40)
    args = (c["T"][:, -1], c["q"][:, -1], c["pe"][:, -1], c["delp"][:, -1],
            speed, tsfc)
    fj = jsl.monin_obukhov_fluxes(*map(jnp.asarray, args))
    ft = tsl.monin_obukhov_fluxes(*map(_t, args))
    for k in fj:
        _close(ft[k], fj[k])
    bj = js.bulk_surface_fluxes(*map(jnp.asarray, args))
    bt = ts.bulk_surface_fluxes(*map(_t, args))
    for k in bj:
        _close(bt[k], bj[k])

    thv = c["T"] * (1.0e5 / c["pmid"]) ** 0.286
    spd = 10.0 * rng.rand(40, 16)
    dzl = 100.0 + 400.0 * rng.rand(40, 16)
    kargs = (thv, spd, dzl, np.asarray(fj["ustar"]),
             np.asarray(fj["obukhov_inv"]), np.asarray(fj["hpbl_flux"]))
    kj = jp.kprofile_diffusivity(*map(jnp.asarray, kargs))
    kt = tp.kprofile_diffusivity(*map(_t, kargs))
    for g, w in zip(kt, kj):
        _close(g, w)
    dz_if = 0.5 * (dzl[:, :-1] + dzl[:, 1:])
    dm = c["delp"] / 9.80665
    _close(tp.implicit_diffusion(_t(c["q"]), kt[1], _t(dz_if), _t(dm), 900.0),
           jp.implicit_diffusion(jnp.asarray(c["q"]), kj[1],
                                 jnp.asarray(dz_if), jnp.asarray(dm), 900.0))
    sig = c["pe"][:, 1:-1] / c["pe"][:, -1:]
    _close(tp.diffusivity_profile(_t(sig)),
           jp.diffusivity_profile(jnp.asarray(sig)))


def test_convection_and_microphysics_match_reference():
    from fv3net_tpu.physics import convection as jc
    from fv3net_tpu.physics import convection_mf as jmf
    from fv3net_tpu.physics import microphysics as jm
    from fv3net_torch.physics import convection as tcv
    from fv3net_torch.physics import convection_mf as tmf
    from fv3net_torch.physics import microphysics as tm

    c = _columns(3)
    cols = (c["T"], c["q"], c["pmid"], c["delp"])
    for g, w in zip(tcv.betts_miller(*map(_t, cols), 900.0),
                    jc.betts_miller(*map(jnp.asarray, cols), 900.0)):
        _close(g, w)
    wind = 10.0 * c["rng"].randn(3, 40, 16)
    for params in (jmf.MassFluxParams(), jmf.SHALLOW_PARAMS):
        tparams = tmf.MassFluxParams(**vars(params))
        got = tmf.mass_flux_convection(*map(_t, cols), 900.0, tparams,
                                       wind=_t(wind))
        want = jmf.mass_flux_convection(*map(jnp.asarray, cols), 900.0,
                                        params, wind=jnp.asarray(wind))
        assert float(np.asarray(want[2]).max()) > 0.0  # the scheme fired
        for g, w in zip(got, want):
            _close(g, w)
    margs = (c["T"], c["q"], c["qc"], c["pmid"], c["delp"])
    got = tm.microphysics_step(*map(_t, margs), 900.0)
    want = jm.microphysics_step(*map(jnp.asarray, margs), 900.0)
    assert float(np.asarray(want[3]).max()) > 0.0  # it precipitates
    for g, w in zip(got, want):
        _close(g, w)


def _step_inputs(npx=12, npz=16):
    st, grid, _, _ = make_state_numpy(npx, npz, seed=2, moist=True)
    sst = 300.15 - 30.0 * np.sin(grid.lat) ** 2
    cosz = np.cos(grid.lat) * np.cos(grid.lon)
    return st, sst, cosz, grid.lat


@pytest.mark.parametrize(
    "schemes",
    [{}, dict(surface_scheme="bulk", pbl_scheme="ramp",
              convection_scheme="mass_flux")],
    ids=["defaults", "alternates"],
)
def test_physics_step_matches_reference(schemes):
    """``physics_step`` on a convecting C12 state at f64: the defaults
    (gray radiation, Monin-Obukhov, K-profile PBL, Betts-Miller + shallow
    mass flux, Zhao-Carr, stratospheric eddy damping) and the alternate
    surface, PBL and deep-convection branches."""
    from fv3net_tpu.physics import PhysicsConfig as JPhysicsConfig
    from fv3net_tpu.physics import physics_step as jphysics_step

    st, sst, cosz, lat = _step_inputs()
    cfg = JPhysicsConfig(**schemes)
    want, dj = jax.jit(lambda s, *a: jphysics_step(s, *a, 900.0, cfg))(
        jax_state(st, jnp.float64), jnp.asarray(sst), jnp.asarray(cosz),
        jnp.asarray(lat),
    )
    got, dt_ = physics_step(state_from_numpy(st), _t(sst), _t(cosz), _t(lat),
                            900.0, PhysicsConfig(**schemes))
    assert_states_close(got, want, RTOL)
    assert dt_.keys() == dj.keys()
    for k in dj:
        _close(dt_[k], dj[k])
    assert float(np.asarray(dj["PRATEsfc"]).max()) > 0.0


def test_unported_physics_options_raise():
    """The microphysics emulator hooks, which this test once held to a
    raise, run (tests/test_torch_emulation.py holds each mode against the
    reference): an identity emulator in the microphysics slot leaves the
    microphysics out (its implied precipitation is nil), one in the gscond
    slot runs precpd natively; in GFDL mode the hooks raise the
    reference's ValueError.  Stratospheric water and an o3mr tracer,
    which this test once held to a raise, run
    (tests/test_torch_gfdl_physics.py holds them and GFDL microphysics
    against the reference): each moves what it acts on."""
    st, sst, cosz, lat = _step_inputs(4, 8)
    args = (state_from_numpy(st), _t(sst), _t(cosz), _t(lat), 900.0)
    native, dn = physics_step(*args)
    emulated, de = physics_step(*args, PhysicsConfig(),
                                microphysics_emulator=lambda s: s)
    assert torch.equal(de["PRATEsfc"], de["CPRATsfc"])
    assert not torch.equal(emulated.tracers["cloud_water"],
                           native.tracers["cloud_water"])
    gscond, dg = physics_step(*args, PhysicsConfig(),
                              gscond_emulator=lambda s: s)
    for d in (de, dg):
        assert all(torch.isfinite(v).all() for v in d.values())
    assert not torch.equal(gscond.pt, native.pt)
    gfdl = dict(st, tracers={**st["tracers"], **{
        k: np.zeros_like(st["delp"])
        for k in ("ice_wat", "rainwat", "snowwat", "graupel")}})
    for kw in (dict(microphysics_emulator=lambda s: s),
               dict(gscond_emulator=lambda s: s)):
        with pytest.raises(ValueError, match="Zhao-Carr"):
            physics_step(state_from_numpy(gfdl), *args[1:],
                         PhysicsConfig(microphysics_scheme="gfdl"), **kw)
    base, _ = physics_step(*args)
    wet, _ = physics_step(*args, PhysicsConfig(stratospheric_h2o=True))
    assert not torch.equal(wet.tracers["sphum"], base.tracers["sphum"])
    o3 = dict(st, tracers={**st["tracers"], "o3mr": st["tracers"]["sphum"]})
    got, _ = physics_step(state_from_numpy(o3), *args[1:])
    assert not torch.equal(got.tracers["o3mr"],
                           torch.tensor(st["tracers"]["sphum"]))
    # rrtmg reaches the step only as a radiation_fn (runtime/fused.py)
    with pytest.raises(ValueError, match="radiation_fn"):
        physics_step(*args, PhysicsConfig(radiation_scheme="rrtmg"))
