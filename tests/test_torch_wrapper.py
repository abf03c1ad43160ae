"""The port's ``fv3gfs.wrapper``-shaped surface (``fv3net_torch.wrapper``)
against ``fv3net_tpu.wrapper``: the same staged sequence at C6, npz=8 in
float64 through both (two steps of ``step_dynamics``,
``step_pre_radiation``, ``step_radiation``,
``step_post_radiation_physics`` and ``apply_physics``, a
``set_state_mass_conserving`` between them), every state field and
diagnostic within 1e-10 of its scale; and the reference test's protocol
checks on the port."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (torch threads under xdist)

from fv3net_torch import wrapper as tw
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.runtime.config import NamelistConfig, UserConfig
from fv3net_tpu import wrapper as jw

jax.config.update("jax_enable_x64", True)

NPX, NPZ = 6, 8
# two float64 staged steps: roundoff grown through the dycore (the winds,
# which start at rest, part by ~2e-11 of their scale)
STAGED_RTOL = 1e-10
STATE = ("air_temperature", "specific_humidity", "eastward_wind",
         "northward_wind", "pressure_thickness_of_atmospheric_layer",
         "surface_pressure", "cloud_water_mixing_ratio")
DIAGS = ("cos_zenith_angle", "PRATEsfc", "ULWRFtoa", "DSWRFtoa",
         "DLWRFsfc", "USWRFsfc", "net_surface_shortwave")


def _config(ref):
    if ref:
        from fv3net_tpu.runtime.config import NamelistConfig as JN
        from fv3net_tpu.runtime.config import UserConfig as JU

        return JU(namelist=JN(npx=NPX, npz=NPZ), duration_seconds=1800.0)
    return UserConfig(namelist=NamelistConfig(npx=NPX, npz=NPZ),
                      duration_seconds=1800.0)


def _staged(w):
    """Two staged steps, humidity raised by 1% (mass-conserving) between
    them; the state and the last step's diagnostics, as numpy."""
    for step in range(2):
        w.step_dynamics()
        w.step_pre_radiation()
        w.step_radiation()
        w.step_post_radiation_physics()
        w.apply_physics()
        if step == 0:
            q = w.get_state(["specific_humidity"])["specific_humidity"]
            w.set_state_mass_conserving({"specific_humidity": type(q)(
                q.data * 1.01, q.dims, q.units)})
    state = {k: np.asarray(v.values, np.float64)
             for k, v in w.get_state(list(STATE)).items()}
    diags = {k: np.asarray(w.get_diagnostic_by_name(k).values, np.float64)
             for k in DIAGS}
    return state, diags, w.get_step_count()


@pytest.fixture(scope="module")
def staged_runs():
    jw.initialize(_config(True), dtype=jnp.float64)
    tw.initialize(_config(False), dtype=torch.float64, device="cpu")
    try:
        return _staged(jw), _staged(tw)
    finally:
        jw.cleanup()
        tw.cleanup()


@pytest.mark.parametrize("kind", ("state", "diagnostics"))
def test_staged_sequence_matches_reference(staged_runs, kind):
    (jstate, jdiags, jn), (tstate, tdiags, tn) = staged_runs
    assert jn == tn == 2
    want, got = (jstate, tstate) if kind == "state" else (jdiags, tdiags)
    for name in want:
        assert got[name].shape == want[name].shape, name
        scale = max(np.abs(want[name]).max(), 1e-30)
        err = np.abs(got[name] - want[name]).max() / scale
        assert err <= STAGED_RTOL, (name, err)


@pytest.fixture()
def model():
    tw.initialize(_config(False), device="cpu")
    yield tw
    tw.cleanup()


def test_requires_initialize_and_default_device():
    tw.cleanup()
    with pytest.raises(RuntimeError, match="initialize"):
        tw.get_step_count()
    if not torch.cuda.is_available():
        # the card by default: without one, initialize raises
        with pytest.raises((RuntimeError, AssertionError)):
            tw.initialize(_config(False))
        tw.cleanup()


def test_staged_step_protocol(model):
    """The reference test's sequence on the port: the step count, the
    cached radiation, the state unchanged until ``apply_physics``, the
    physics diagnostics by name."""
    assert tw.get_step_count() == 0
    t0 = tw.get_state(["air_temperature"])["air_temperature"]
    tw.step_dynamics()
    assert tw.get_step_count() == 1
    tw.step_pre_radiation()
    tw.step_radiation()
    assert tw.get_diagnostic_by_name("cos_zenith_angle").data.shape == (
        6, NPX, NPX)
    tw.step_post_radiation_physics()
    before = tw.get_state(["air_temperature"])["air_temperature"].data
    assert torch.equal(before, tw.get_state(["air_temperature"])[
        "air_temperature"].data)
    tw.apply_physics()
    t1 = tw.get_state(["air_temperature"])["air_temperature"]
    assert (t1.data - t0.data).abs().max() > 0.0
    assert torch.isfinite(t1.data).all()
    assert tw.get_diagnostic_by_name("PRATEsfc") is not None
    with pytest.raises(ValueError, match="no diagnostic"):
        tw.get_diagnostic_by_name("nope")
    # a stage called out of order runs the stages before it
    tw.step_dynamics()
    tw.apply_physics()
    assert tw.get_step_count() == 2


def test_radiation_fn_protocol():
    """The cached radiation the wrapper hands ``physics_step`` binds the
    canonical call, as every radiation_fn of the port does: positional
    (T, delp, q, qc, tsfc, cosz, lat) plus keywords o3=, land=, ice=."""
    import inspect

    from fv3net_torch.physics import PhysicsConfig
    from fv3net_torch.runtime import fused

    fn = fused._build_radiation_fn(PhysicsConfig(radiation_scheme="rrtmg"),
                                   "cpu", torch.float64)
    inspect.signature(fn).bind(*[None] * 7, o3=None, land=None, ice=None)
    assert fused._build_radiation_fn(PhysicsConfig(), "cpu",
                                     torch.float64) is None


def test_get_set_state_mass_conserving(model):
    state = tw.get_state(["specific_humidity", "air_temperature"])
    q = state["specific_humidity"]
    delp0 = tw.get_state(["pressure_thickness_of_atmospheric_layer"])[
        "pressure_thickness_of_atmospheric_layer"].data
    tw.set_state_mass_conserving({"specific_humidity": Quantity(
        q.data * 1.01, q.dims, q.units)})
    q2 = tw.get_state(["specific_humidity"])["specific_humidity"]
    np.testing.assert_allclose(q2.values, q.values * 1.01, rtol=1e-5)
    delp1 = tw.get_state(["pressure_thickness_of_atmospheric_layer"])[
        "pressure_thickness_of_atmospheric_layer"].data
    # the dry air of every layer is kept: delp (1 - q) unchanged
    np.testing.assert_allclose((delp1 * (1 - q2.data)).numpy(),
                               (delp0 * (1 - q.data)).numpy(), rtol=1e-5)


def test_tracer_metadata_and_flags(model):
    meta = tw.get_tracer_metadata()
    jw.initialize(_config(True))
    try:
        assert meta == jw.get_tracer_metadata()
        jf = jw.flags()
    finally:
        jw.cleanup()
    assert meta["sphum"]["units"] == "kg/kg"
    assert {m["i_tracer"] for m in meta.values()} == {1, 2}
    f = tw.flags()
    assert f.npx == NPX and f.hydrostatic
    assert vars(f) == vars(jf)


def test_intermediate_restart(model, tmp_path):
    """``save_intermediate_restart_if_enabled`` writes nothing unless the
    flag is set, then the port's ``save_state`` files, which both
    packages' ``load_state`` read back."""
    from fv3net_torch.runtime import checkpoint
    from fv3net_tpu.runtime import checkpoint as jcheckpoint

    f = tw.flags()
    f.intermediate_restart_path = str(tmp_path / "RESTART")
    tw.step_dynamics()
    tw.save_intermediate_restart_if_enabled()
    assert not os.path.exists(str(tmp_path / "RESTART"))
    f.save_intermediate_restart = True
    tw.save_intermediate_restart_if_enabled()
    assert sorted(os.listdir(tmp_path / "RESTART")) == ["restart.json",
                                                        "state.npz"]
    loaded, time = checkpoint.load_state(str(tmp_path / "RESTART"))
    ref, ref_time = jcheckpoint.load_state(str(tmp_path / "RESTART"))
    assert time == ref_time == tw._model().loop.time
    assert torch.equal(loaded.dycore.pt.cpu(),
                       tw._model().loop.state.dycore.pt)
    np.testing.assert_array_equal(np.asarray(ref.dycore.pt),
                                  loaded.dycore.pt.numpy())
