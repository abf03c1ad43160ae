"""fv3net_torch's production chunk held against fv3net_tpu's on shared
numpy inputs (float64): the namelist copy, ``DerivedState``, the dense ML
stepper with its limiter and tendency application, and
``build_fused_production_chunk`` itself, on gray radiation with the
bucket land and sea ice, with the Noah soil and gravity-wave drag, and on
RRTMG with the radiation cache and a "set" prescriber."""
import dataclasses
import functools

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

from fv3net_torch import entry
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.dycore.core import GridArrays
from fv3net_torch.dycore.state import state_from_numpy
from fv3net_torch.fit.dense import params_from_jax
from fv3net_torch.physics import PhysicsConfig
from fv3net_torch.runtime import config as tconfig
from fv3net_torch.runtime import fused, names
from fv3net_torch.runtime.derived_state import DerivedState, ModelState
from fv3net_torch.runtime.diagnostics.compute import limit_sphum_tendency
from fv3net_torch.runtime.steppers import machine_learning as tml

jax.config.update("jax_enable_x64", True)

# float64, one call: roundoff of reassociated sums
RTOL = 1e-12
# float64 chunks: roundoff grown through the steps (the flagship chunk
# tests' bound)
CHUNK_RTOL = 1e-8
NPZ = 16


# ------------------------------------------------------------ namelist
def test_namelist_config_copy_matches_reference():
    from fv3net_tpu.runtime.config import NamelistConfig as JNamelistConfig

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(tconfig.NamelistConfig) == fields(JNamelistConfig)
    for kw in ({}, {"bucket_land": True},
               {"land_model": "noah", "slab_ocean": True, "sea_ice": True,
                "radiation": "rrtmg", "npx": 12}):
        assert (dataclasses.asdict(tconfig.NamelistConfig(**kw))
                == dataclasses.asdict(JNamelistConfig(**kw)))
    for kw in ({"microphysics": "x"}, {"radiation": "x"},
               {"surface_scheme": "x"}, {"pbl_scheme": "x"},
               {"convection": "x"}, {"land_model": "x"},
               {"land_model": "noah"}, {"sea_ice": True}):
        with pytest.raises(ValueError) as want:
            JNamelistConfig(**kw)
        with pytest.raises(ValueError) as got:
            tconfig.NamelistConfig(**kw)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------ shared state
@functools.lru_cache(maxsize=None)
def _grids(npx):
    from fv3net_tpu.dycore.core import GridArrays as JGridArrays
    from fv3net_tpu.grid.geometry import make_grid as jmake_grid

    return (JGridArrays.from_grid(jmake_grid(npx), dtype=jnp.float64),
            GridArrays.from_grid(entry.make_grid(npx), dtype=torch.float64))


def _surface_numpy(grid, land=False, ice=False, seed=0):
    rng = np.random.RandomState(seed)
    sst = 300.15 - 30.0 * np.sin(grid.lat) ** 2
    mask = np.zeros_like(sst)
    if land:
        mask[0] = 1.0
    sfc = {
        names.TSFC: sst, names.SST: sst.copy(), names.MASK: mask,
        "ice_thickness": (np.where(np.abs(grid.lat) > 1.0,
                                   0.5 * rng.rand(*sst.shape), 0.0)
                          if ice else np.zeros_like(sst)),
        names.TOTAL_PRECIP: np.zeros_like(sst),
    }
    return sfc


def _derived_pair(npx=6, seed=7):
    st, grid, _, _ = make_state_numpy(npx, NPZ, seed=seed, moist=True)
    sfc = _surface_numpy(grid, land=True)
    from fv3net_tpu.runtime.derived_state import DerivedState as JDerived
    from fv3net_tpu.runtime.derived_state import ModelState as JModelState

    jg, tg = _grids(npx)
    jd = JDerived(JModelState(dycore=jax_state(st, jnp.float64), surface={
        k: jnp.asarray(v) for k, v in sfc.items()}), jg)
    td = DerivedState(ModelState(dycore=state_from_numpy(st), surface={
        k: torch.tensor(v) for k, v in sfc.items()}), tg)
    return jd, td, st


def _same_state(td, jd, rtol=RTOL):
    assert_states_close(td.state.dycore, jd.state.dycore, rtol)
    assert set(td.state.surface) == set(jd.state.surface)
    for k, v in jd.state.surface.items():
        assert rel_diff(td.state.surface[k].numpy(), v) <= rtol, k


def test_derived_state_getters_and_setters_match_reference():
    jd, td, st = _derived_pair()
    keys = td.keys() + ["sphum", "cloud_water"]
    assert td.keys() == jd.keys()
    for k in keys:
        g, w = td[k], jd[k]
        assert g.dims == w.dims and g.units == w.units, k
        assert rel_diff(g.data.numpy(), w.data) <= RTOL, k
    with pytest.raises(KeyError):
        td["no_such_variable"]
    rng = np.random.RandomState(8)
    shape3, shape2 = st["pt"].shape, st["phis"].shape
    updates = [
        (names.TEMP, 280 + 5 * rng.rand(*shape3)),
        # the humidity setter rescales delp to keep the dry mass
        (names.SPHUM, st["tracers"]["sphum"] * (1 + 0.3 * rng.rand(*shape3))),
        (names.CLOUD, 1e-5 * rng.rand(*shape3)),
        ("sphum", st["tracers"]["sphum"] * 0.9),
        (names.EASTWARD_WIND, 10 * rng.randn(*shape3)),
        (names.NORTHWARD_WIND, 10 * rng.randn(*shape3)),
        (names.TSFC, 290 + rng.rand(*shape2)),
        ("a_new_surface_field", rng.rand(*shape2)),
    ]
    for key, value in updates:
        jd[key] = jnp.asarray(value)
        td[key] = Quantity(torch.tensor(value), ("tile", "z", "y", "x")
                           if value.ndim == 4 else ("tile", "y", "x"))
        _same_state(td, jd)
    with pytest.raises(KeyError):
        td["no_such_variable"] = torch.zeros(shape3)


# ------------------------------------------------------------ ML stepper
@functools.lru_cache(maxsize=None)
def _jax_model(outputs=("dQ1", "dQ2"), seed=0, dq_scale=(1e-5, 3e-6),
               out_scale=1.0):
    """A reference dense model trained as the reference entry's production
    configuration trains its own (1 hidden layer of 16), at float64, on
    tendencies of the scales ``dq_scale`` (by default dQ2 large enough
    that the limiter acts), its last layer's weights and bias times
    ``out_scale`` (the output scaler's floor of 1e-7 keeps an untrained
    net's dQ2 near 1e-7 x its O(10) raw output)."""
    from fv3net_tpu.core.dataset import Dataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity
    from fv3net_tpu.fit.dense import DenseHyperparameters, train_dense_model

    rng = np.random.RandomState(seed)
    n = 64

    def q(x):
        return JQuantity(jnp.asarray(x, jnp.float64), ("sample", "z"))

    batch = Dataset({
        "air_temperature": q(260 + 30 * rng.rand(n, NPZ)),
        "specific_humidity": q(0.01 * rng.rand(n, NPZ)),
        "dQ1": q(dq_scale[0] * rng.randn(n, NPZ)),
        "dQ2": q(dq_scale[1] * rng.randn(n, NPZ)),
    })
    hp = DenseHyperparameters(
        input_variables=["air_temperature", "specific_humidity"],
        output_variables=list(outputs), hidden_layers=1, width=16,
        epochs=1, seed=seed,
    )
    model = train_dense_model(hp, [batch])
    last = model.params[-1]
    model.params[-1] = {"w": out_scale * last["w"], "b": out_scale * last["b"]}
    return model


def _steppers(adapter=False, **kw):
    from fv3net_tpu.runtime.steppers import machine_learning as jml

    if adapter:
        jm = jml.MultiModelAdapter([_jax_model(("dQ1",), 1),
                                    _jax_model(("dQ2",), 2)])
        tm = tml.MultiModelAdapter([params_from_jax(m) for m in jm.models])
        assert tm.input_variables == jm.input_variables
        assert tm.output_variables == jm.output_variables
    else:
        jm = _jax_model()
        tm = params_from_jax(jm)
    return (jml.PureMLStepper(jm, 900.0, **kw),
            tml.PureMLStepper(tm, 900.0, **kw))


def _close_quantities(got, want, rtol=RTOL):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        w = np.asarray(getattr(want[k], "data", want[k]))
        g = getattr(got[k], "data", got[k]).numpy()
        assert g.shape == w.shape, k
        assert rel_diff(g, w) <= rtol, k


@pytest.mark.parametrize("adapter,mse", [(False, True), (True, False)])
def test_ml_stepper_matches_reference(adapter, mse):
    """PureMLStepper's tendencies, diagnostics and state updates (the
    limiter active), then add_tendency, through one model or a
    MultiModelAdapter of two."""
    from fv3net_tpu.runtime.steppers import machine_learning as jml

    jd, td, _ = _derived_pair()
    js, ts = _steppers(adapter, mse_conserving_limiter=mse)
    jt, jdiag, ju = js(None, jd)
    tt, tdiag, tu = ts(None, td)
    _close_quantities(tt, jt)
    _close_quantities(tdiag, jdiag)
    _close_quantities(tu, ju)
    assert float(np.asarray(jdiag["specific_humidity_limiter_active"
                                  ].data)) == 1.0
    assert list(tt) == list(jt)  # dQ1 before dQ2, as the reference
    jml.add_tendency(jd, jt, 900.0)
    tml.add_tendency(td, tt, 900.0)
    _same_state(td, jd, 1e-11)


def test_limit_sphum_tendency_matches_reference():
    from fv3net_tpu.core.quantity import Quantity as JQuantity
    from fv3net_tpu.runtime.diagnostics import compute as jcompute

    rng = np.random.RandomState(9)
    shape = (6, NPZ, 4, 4)
    q = 0.01 * rng.rand(*shape)
    delp = 1000 + 500 * rng.rand(*shape)
    dq1 = 1e-4 * rng.randn(*shape)
    dq2 = 2e-5 * rng.randn(*shape)  # drives q negative in places
    dims = ("tile", "z", "y", "x")
    for mse in (True, False):
        for keys in (("dQ1", "dQ2"), ("dQ2",), ("dQ1",)):
            tend = {k: v for k, v in (("dQ1", dq1), ("dQ2", dq2))
                    if k in keys}
            want = jcompute.limit_sphum_tendency(
                jnp.asarray(q), {k: JQuantity(jnp.asarray(v), dims)
                                 for k, v in tend.items()},
                900.0, mse, jnp.asarray(delp), hydrostatic=mse)
            got = limit_sphum_tendency(
                torch.tensor(q), {k: Quantity(torch.tensor(v), dims)
                                  for k, v in tend.items()},
                900.0, mse, torch.tensor(delp), hydrostatic=mse)
            for g, w in zip(got, want):
                _close_quantities(g, w)


def test_apply_stepper_in_graph_matches_reference():
    """The stepper applied with the precipitation bookkeeping: the
    humidity setter's delp change becomes the ML net moistening, taken
    off TOTAL_PRECIP and clamped at 0."""
    from fv3net_tpu.runtime import fused as jfused

    jd, td, _ = _derived_pair()
    js, ts = _steppers()
    rng = np.random.RandomState(10)
    precip = 0.05 * rng.rand(*td.state.surface[names.TSFC].shape)
    jd.state.surface[names.TOTAL_PRECIP] = jnp.asarray(precip)
    td.state.surface[names.TOTAL_PRECIP] = torch.tensor(precip)
    want = jfused.apply_stepper_in_graph(js, jd, 900.0, track_precip=True)
    got = fused.apply_stepper_in_graph(ts, td, 900.0, track_precip=True)
    _close_quantities(got, want, 1e-10)
    _same_state(td, jd, 1e-11)
    total = td.state.surface[names.TOTAL_PRECIP]
    assert (total == 0).any() and (total > 0).any()


# ------------------------------------------------------------ the chunk
def _production_inputs(npx, nml_kw, n_steps, prephysics=False, land=False,
                       ice=False, sgh=False, noah=False, seed=3):
    """One moist numpy state, its surface, cosz, the prescribed SSTs (with
    ``prephysics``) and (ak, bk)."""
    st, grid, ak, bk = make_state_numpy(npx, NPZ, seed=seed, moist=True)
    st["tracers"]["cloud_water"] *= 10.0
    sfc = _surface_numpy(grid, land=land, ice=ice, seed=seed)
    rng = np.random.RandomState(seed + 1)
    if sgh:
        sfc["sgh"] = sfc[names.MASK] * (100.0 + 300.0 * rng.rand(
            *grid.lat.shape))
    if nml_kw.get("bucket_land"):
        sfc["soil_moisture"] = 0.02 + 0.1 * rng.rand(*grid.lat.shape)
    if noah:
        sfc["soil_temperature"] = np.stack([sfc[names.TSFC] - i
                                            for i in range(4)])
        sfc["soil_moisture_layers"] = 0.15 + 0.2 * rng.rand(
            4, *grid.lat.shape)
        sfc["snow_water_equivalent"] = np.where(
            np.abs(grid.lat) > 0.9, 0.01, 0.0) * sfc[names.MASK]
        sfc["deep_soil_temperature"] = np.clip(sfc[names.TSFC], 271, 300)
    cosz = np.cos(grid.lat) * np.cos(grid.lon)
    presc = ()
    if prephysics:
        presc = ({names.SST: np.stack([sfc[names.SST] + 0.5 * i
                                       for i in range(n_steps)])},)
    return st, sfc, cosz, presc, ak, bk


def _quiet_model():
    """The reference entry's batch recipe (__graft_entry__.py:325-338), its
    outputs scaled so that the limiter does not act: where it acts it
    leaves q at +-1e-18, and the next step's tracer remap parts states
    that differ there only in those residues' signs by 1e-2 of scale, in
    either package (test_production_chunk_limiter_active_step_by_step)."""
    return _jax_model(dq_scale=(1e-6, 1e-9), out_scale=1e-4)


def _production_runners(npx, nml_kw, radiation, n_steps, radiation_interval,
                        ak, bk, kinds=(), model=None):
    """The reference's and the port's production chunks, each a function
    of numpy (state, surface, cosz, prescribed) returning its (dycore,
    surface, diags)."""
    from fv3net_tpu.dycore.core import DycoreConfig as JDycoreConfig
    from fv3net_tpu.physics import PhysicsConfig as JPhysicsConfig
    from fv3net_tpu.runtime import fused as jfused
    from fv3net_tpu.runtime.config import NamelistConfig as JNamelistConfig
    from fv3net_tpu.runtime.steppers import machine_learning as jml

    nml_kw = dict(npx=npx, npz=NPZ, slab_ocean=True, sea_ice=True,
                  radiation=radiation, **nml_kw)
    jg, tg = _grids(npx)
    model = _quiet_model() if model is None else model
    jchunk = jfused.build_fused_production_chunk(
        jg, jnp.asarray(ak), jnp.asarray(bk),
        JDycoreConfig(**vars(entry.PRODUCTION_DYCORE)),
        JPhysicsConfig(radiation_scheme=radiation),
        JNamelistConfig(**nml_kw),
        ml_stepper=jml.PureMLStepper(model, 900.0), n_steps=n_steps,
        radiation_interval=radiation_interval, prephysics_kinds=kinds,
    )
    tchunk = fused.build_fused_production_chunk(
        tg, torch.tensor(ak), torch.tensor(bk), entry.PRODUCTION_DYCORE,
        PhysicsConfig(radiation_scheme=radiation),
        tconfig.NamelistConfig(**nml_kw),
        ml_stepper=tml.PureMLStepper(params_from_jax(model), 900.0),
        n_steps=n_steps, radiation_interval=radiation_interval,
        prephysics_kinds=kinds,
    )

    def run_reference(st, sfc, cosz, presc):
        return jchunk(
            jax_state(st, jnp.float64),
            {k: jnp.asarray(v) for k, v in sfc.items()}, jnp.asarray(cosz),
            tuple({k: jnp.asarray(v) for k, v in p.items()} for p in presc),
        )

    def run_port(st, sfc, cosz, presc):
        return tchunk(
            state_from_numpy(st),
            {k: torch.tensor(v) for k, v in sfc.items()}, torch.tensor(cosz),
            tuple({k: torch.tensor(v) for k, v in p.items()} for p in presc),
        )

    return run_reference, run_port


def _production_pair(npx, nml_kw, radiation, n_steps, radiation_interval,
                     prephysics=False, **inputs):
    """The reference's and the port's production chunks on one moist
    numpy state and surface, with the quiet model; returns (want, got) as
    (dycore, surface, diags)."""
    st, sfc, cosz, presc, ak, bk = _production_inputs(
        npx, nml_kw, n_steps, prephysics, **inputs)
    run_reference, run_port = _production_runners(
        npx, nml_kw, radiation, n_steps, radiation_interval, ak, bk,
        kinds=("set",) * len(presc))
    return (run_reference(st, sfc, cosz, presc),
            run_port(st, sfc, cosz, presc))


def _compare_chunks(want, got, expect_keys):
    jdy, jsfc, jdiag = want
    tdy, tsfc, tdiag = got
    assert_states_close(tdy, jdy, CHUNK_RTOL)
    assert set(tsfc) == set(jsfc), sorted(set(tsfc) ^ set(jsfc))
    assert set(tdiag) == set(jdiag), sorted(set(tdiag) ^ set(jdiag))
    for key in expect_keys:
        assert key in tdiag or key in tsfc, key
    # every surface key, TOTAL_PRECIP and the chunk-accumulated water
    bad = {}
    for k in sorted(jsfc):
        d = rel_diff(tsfc[k].numpy(), jsfc[k])
        if not d <= CHUNK_RTOL:
            bad["surface " + k] = d
    for k in sorted(jdiag):
        if k == names.TOTAL_PRECIP or k.startswith("chunk_accumulated_"):
            d = rel_diff(tdiag[k].numpy(), jdiag[k])
            if not d <= CHUNK_RTOL:
                bad[k] = d
    assert not bad, bad


def test_production_chunk_gray_bucket_sea_ice():
    """4 gray steps at C8 with the bucket land on tile 0 and sea ice on
    the polar ocean (the reference's
    test_fused_production_ml_surface_matches_perstep configuration)."""
    want, got = _production_pair(8, {"bucket_land": True}, "gray", 4, 1,
                                 land=True, ice=True)
    _compare_chunks(want, got, ("soil_moisture", "ice_thickness",
                                "chunk_accumulated_RUNOFFsfc"))
    h = got[1]["ice_thickness"]
    assert (h > 0).any() and (got[1]["soil_moisture"] > 0).all()
    assert (got[2][names.TOTAL_PRECIP] > 0).any()


def test_production_chunk_gray_noah_gravity_wave_drag():
    """The same with the Noah soil and a seeded sgh on the land tile, so
    the step runs the gravity-wave drag."""
    want, got = _production_pair(8, {"land_model": "noah"}, "gray", 4, 1,
                                 land=True, ice=True, sgh=True, noah=True)
    _compare_chunks(want, got, ("soil_moisture_layers", "taugwd",
                                "chunk_accumulated_DRAINsfc"))
    tau = got[2]["taugwd"]
    assert (tau[0] > 0).all() and (tau[1:] == 0).all()


def _numpy_state(state):
    """The reference's DycoreState as a numpy state."""
    return {"delp": np.asarray(state.delp), "pt": np.asarray(state.pt),
            "wind": np.asarray(state.wind), "phis": np.asarray(state.phis),
            "tracers": {k: np.asarray(v) for k, v in state.tracers.items()}}


def test_production_chunk_limiter_active_step_by_step():
    """The chunk with the ML limiter acting (the recipe's model at its
    full output scale), gray with the bucket land and sea ice at C8, held
    step by step: step 0 from the seeded state, then step 1 in both
    packages from the reference's state after step 0.  Where the limiter
    acts it leaves q at +-1e-18, and the reference's own dynamics_step
    moves q by 1e-2 of scale when only those residues' signs change: its
    kord-9 tracer remap takes a layer for an extremum from the sign of
    q[k+1] - q[k], which between two residues is the sign of roundoff,
    and flattens the profile of the layer beside such an extremum.  So
    chained chunks part wherever the two packages' roundoff leaves a
    residue of the other sign; the port takes any one such state exactly
    as the reference does."""
    from fv3net_tpu.dycore import dynamics_step as jdynamics_step
    from fv3net_tpu.dycore.core import DycoreConfig as JDycoreConfig

    from fv3net_torch.dycore.core import dynamics_step

    st, sfc, cosz, _, ak, bk = _production_inputs(
        8, {"bucket_land": True}, 1, land=True, ice=True)
    run_reference, run_port = _production_runners(
        8, {"bucket_land": True}, "gray", 1, 1, ak, bk, model=_jax_model())
    want = run_reference(st, sfc, cosz, ())
    _compare_chunks(want, run_port(st, sfc, cosz, ()),
                    ("soil_moisture", "ice_thickness"))
    st1 = _numpy_state(want[0])
    sfc1 = {k: np.asarray(v) for k, v in want[1].items()}
    q = st1["tracers"]["sphum"]
    residue = np.abs(q) < 1e-15
    # the limiter acted: the seeded q is nowhere below 1e-6
    assert st["tracers"]["sphum"].min() > 1e-6 and residue.any()
    _compare_chunks(run_reference(st1, sfc1, cosz, ()),
                    run_port(st1, sfc1, cosz, ()), ())

    flipped = dict(st1, tracers=dict(st1["tracers"],
                                     sphum=np.where(residue, -q, q)))
    jg, tg = _grids(8)
    jcfg = JDycoreConfig(**vars(entry.PRODUCTION_DYCORE))

    def reference_dynamics(s):
        return jdynamics_step(jax_state(s, jnp.float64), jg, jnp.asarray(ak),
                              jnp.asarray(bk), jcfg)

    base, moved = reference_dynamics(st1), reference_dynamics(flipped)
    assert rel_diff(moved.tracers["sphum"], base.tracers["sphum"]) > 1e-4
    assert_states_close(moved, base, 0.0,
                        fields=["delp", "pt", "wind", "cloud_water"])
    assert_states_close(
        dynamics_step(state_from_numpy(flipped), tg, torch.tensor(ak),
                      torch.tensor(bk), entry.PRODUCTION_DYCORE),
        moved, CHUNK_RTOL)


def test_production_chunk_rrtmg_cache_and_prescriber(monkeypatch):
    """2 RRTMG steps with radiation_interval=2, so step 1 takes the
    cache, and a "set" SST prescriber; both drivers in float64, the port
    taking the reference's McICA draws."""
    from test_torch_rrtmg import jax_mcica_draws

    from fv3net_tpu.physics.radiation.rrtmg import driver as jdrv

    from fv3net_torch.physics.radiation.rrtmg import driver as tdrv

    monkeypatch.setattr(jdrv, "RRTMGDriver", functools.partial(
        jdrv.RRTMGDriver, dtype=jnp.float64))
    monkeypatch.setattr(tdrv.RRTMGDriver, "draw_mcica",
                        jax_mcica_draws(torch.float64))
    calls = []
    orig = tdrv.RRTMGDriver.__call__
    monkeypatch.setattr(tdrv.RRTMGDriver, "__call__",
                        lambda self, *a, **k: calls.append(1) or orig(
                            self, *a, **k))
    want, got = _production_pair(6, {}, "rrtmg", 2, 2, prephysics=True,
                                 ice=True)
    assert len(calls) == 1  # step 1 reused step 0's radiation
    _compare_chunks(want, got, ("ice_thickness", "DSWRFsfc"))


def test_production_chunk_tend_prescriber():
    """A "tend" prephysics stepper (dQ1) against the reference's chunk
    given the same update as a "set" of the temperature it makes, one
    gray step at C4 (the reference's own "tend" kind raises: it wraps the
    updates in Quantities of no dims)."""
    from fv3net_tpu.dycore.core import DycoreConfig as JDycoreConfig
    from fv3net_tpu.physics import PhysicsConfig as JPhysicsConfig
    from fv3net_tpu.runtime import fused as jfused
    from fv3net_tpu.runtime.config import NamelistConfig as JNamelistConfig

    jd, td, st = _derived_pair(npx=4)
    jg, tg = _grids(4)
    grid = entry.make_grid(4)
    _, ak, bk = entry.init_state(grid, NPZ, dtype=torch.float64)
    cosz = np.cos(grid.lat) * np.cos(grid.lon)
    dq1 = 2e-4 * np.random.RandomState(11).randn(1, *st["pt"].shape)
    T_set = np.asarray(jd[names.TEMP].data) + 900.0 * dq1
    jchunk = jfused.build_fused_production_chunk(
        jg, jnp.asarray(ak), jnp.asarray(bk),
        JDycoreConfig(**vars(entry.PRODUCTION_DYCORE)), JPhysicsConfig(),
        JNamelistConfig(slab_ocean=True), n_steps=1,
        prephysics_kinds=("set",))
    want = jchunk(jd.state.dycore, jd.state.surface, jnp.asarray(cosz),
                  ({names.TEMP: jnp.asarray(T_set)},))
    tchunk = fused.build_fused_production_chunk(
        tg, torch.tensor(ak), torch.tensor(bk), entry.PRODUCTION_DYCORE,
        PhysicsConfig(), tconfig.NamelistConfig(slab_ocean=True), n_steps=1,
        prephysics_kinds=("tend",))
    got = tchunk(td.state.dycore, td.state.surface, torch.tensor(cosz),
                 ({"dQ1": torch.tensor(dq1)},))
    _compare_chunks(want, got, ())
    with pytest.raises(ValueError, match="prephysics kind"):
        fused.build_fused_production_chunk(
            tg, torch.tensor(ak), torch.tensor(bk), entry.PRODUCTION_DYCORE,
            PhysicsConfig(), tconfig.NamelistConfig(), n_steps=1,
            prephysics_kinds=("nudge",))


def test_entry_production_runs_on_cpu():
    """``entry.production`` on the CPU (gray, 2 steps, the Noah land
    variant with sgh): finite fields, no kernel launch, and the dry-air
    budget that ``chip_smoke.py`` gates: the global dry air mass changes
    by the chunk's precipitation less evaporation plus the change of the
    cloud water mass (the ML humidity setter keeps each layer's dry air
    and moves delp, the physics moves water and keeps delp)."""
    from fv3net_torch.core.constants import GRAVITY
    from fv3net_torch.ops import ktable_cuda, remap_cuda

    mask = np.zeros((6, 4, 4))
    mask[0] = 1.0
    chunk, (dycore, surface, cosz, presc) = entry.production(
        npx=4, npz=8, radiation="gray", chunk=2, land_model="noah",
        land_mask=mask, sgh=mask * 300.0, dtype=torch.float64,
        device="cpu")
    before = (remap_cuda.LAUNCHES, ktable_cuda.SELECT_LAUNCHES)
    out, sfc, diags = chunk(dycore, surface, cosz, presc)
    assert before == (remap_cuda.LAUNCHES, ktable_cuda.SELECT_LAUNCHES)
    for x in [out.delp, out.pt, out.wind, *out.tracers.values(),
              *sfc.values(), *diags.values()]:
        assert torch.isfinite(x).all()
    assert (diags["taugwd"][0] > 0).all()
    assert presc[0][names.SST].shape == (2, 6, 4, 4)

    area = torch.tensor(entry.make_grid(4).area)

    def masses(d):
        dry = ((d.delp * (1 - d.tracers["sphum"])).sum(1) * area).sum()
        wc = ((d.delp * d.tracers["cloud_water"]).sum(1) * area).sum()
        return dry / GRAVITY, wc / GRAVITY

    (dry0, wc0), (dry1, wc1) = masses(dycore), masses(out)
    p_minus_e = ((diags["chunk_accumulated_PRATEsfc"]
                  - diags["chunk_accumulated_evaporation"]) * area).sum()
    residual = (dry1 - dry0 - p_minus_e - (wc1 - wc0)) / dry0
    assert abs(float(residual)) <= 1e-12, float(residual)
    assert abs(float(dry1 - dry0)) > 1e3 * abs(float(residual * dry0))
