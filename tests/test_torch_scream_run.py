"""The port's SCREAM run (``fv3net_torch.scream_run``) against
``fv3net_tpu.scream_run``: the config surface, the humidity limiter and
the output scaling on shared inputs (bit for bit: the operations are the
same), the ``prepare-config`` and ``write-rundir`` subcommands, and the
``run`` subcommand of both CLIs at ne4pg2 (C8) for 3 steps with the same
dense model, on the CPU in float64, every state field within 1e-10 of
its scale."""
import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_port_util  # noqa: F401  (torch threads under xdist)

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.scream_run import cli as tcli
from fv3net_torch.scream_run import config as tconfig
from fv3net_torch.scream_run import ml as tml
from fv3net_tpu.core.dataset import Dataset as JDataset
from fv3net_tpu.core.quantity import Quantity as JQuantity
from fv3net_tpu.scream_run import cli as jcli
from fv3net_tpu.scream_run import config as jconfig
from fv3net_tpu.scream_run import ml as jml

jax.config.update("jax_enable_x64", True)

NZ = 8
STEPS = 3
# three float64 steps of both runs with the ML correction: roundoff grown
# through the dycore (the winds, from rest, part by ~2e-11 of scale)
RUN_RTOL = 1e-10
STATE = ("air_temperature", "specific_humidity", "eastward_wind",
         "northward_wind", "pressure_thickness_of_atmospheric_layer")


@pytest.mark.parametrize("cfg", (
    {"RESOLUTION": "ne4pg2_ne4pg2", "ATM_NCPL": 96,
     "RUNTIME": {"STOP_OPTION": "nsteps", "STOP_N": 3}},
    {"RESOLUTION": "ne30pg2_ne30pg2", "ATM_NCPL": 48,
     "RUNTIME": {"STOP_OPTION": "nhours", "STOP_N": 6}},
    {"RESOLUTION": "ne120pg2_ne120pg2",
     "RUNTIME": {"STOP_OPTION": "ndays", "STOP_N": 2}, "npz": 79},
))
def test_scream_config_matches_reference(cfg, tmp_path):
    """The grid mapping (neXpg2 -> C(2X)), the step, the duration and the
    written case directory of both packages; the run script names the
    port's console script."""
    got = tconfig.ScreamConfig.from_dict(cfg)
    want = jconfig.ScreamConfig.from_dict(cfg)
    assert (got.npx, got.npz, got.dt_atmos, got.duration_seconds) == (
        want.npx, want.npz, want.dt_atmos, want.duration_seconds)
    got.write_rundir(str(tmp_path / "port"))
    want.write_rundir(str(tmp_path / "ref"))
    assert ((tmp_path / "port" / "scream_config.yaml").read_text()
            == (tmp_path / "ref" / "scream_config.yaml").read_text())
    script = (tmp_path / "port" / "run_case.sh").read_text()
    ref_script = (tmp_path / "ref" / "run_case.sh").read_text()
    assert script == ref_script.replace("fv3net_tpu", "fv3net_torch").replace(
        "scream-run", "scream-run-torch").replace(
        str(tmp_path / "ref"), str(tmp_path / "port"))
    assert os.access(tmp_path / "port" / "run_case.sh", os.X_OK)


def test_scream_config_refusals():
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match="local"):
            mod.ScreamConfig(initial_conditions_type="cloud")
        with pytest.raises(ValueError, match="RESOLUTION"):
            _ = mod.ScreamConfig(RESOLUTION="T62").npx


def _limiter_inputs():
    rng = np.random.RandomState(3)
    q = 1e-4 * rng.rand(40, NZ)
    dq1 = 1e-4 * rng.randn(40, NZ)
    dq2 = 2e-7 * rng.randn(40, NZ)  # drives some of q negative in 900 s
    return q, dq1, dq2


@pytest.mark.parametrize("mse", (True, False))
@pytest.mark.parametrize("outputs", (("dQ1", "dQ2"), ("dQ2",), ("dQ1",)))
def test_limiter_bit_for_bit(mse, outputs):
    """``enforce_non_negative_humidity`` of both packages on the same
    float64 inputs: equal bit for bit, humidity non-negative after the
    step up to the roundoff of q + dt (-q / dt)."""
    q, dq1, dq2 = _limiter_inputs()
    arrays = {"dQ1": dq1, "dQ2": dq2}
    dims = ("sample", "z")
    got = tml.enforce_non_negative_humidity(
        Dataset({k: Quantity(torch.from_numpy(arrays[k]), dims)
                 for k in outputs}),
        {"qv": Quantity(torch.from_numpy(q), dims)}, 900.0, mse)
    want = jml.enforce_non_negative_humidity(
        JDataset({k: _jq(arrays[k]) for k in outputs}), {"qv": _jq(q)},
        900.0, mse)
    assert sorted(got) == sorted(want) == sorted(outputs)
    for k in outputs:
        np.testing.assert_array_equal(got[k].values, np.asarray(
            want[k].data))
    if "dQ2" in outputs:
        after = q + 900.0 * got["dQ2"].values
        assert after.min() >= -4 * np.finfo(np.float64).eps * q.max()
        assert (got["dQ2"].values != dq2).any()  # the limiter acted


def _jq(a):
    return JQuantity(jnp.asarray(a), ("sample", "z"))


def test_scaling_before_the_limiter():
    """``predict`` multiplies the named outputs before the limiter sees
    them, in both packages, equal bit for bit; a factor for an output the
    model lacks is ignored."""
    q, dq1, dq2 = _limiter_inputs()

    class Model:
        input_variables = ["qv"]
        output_variables = ["dQ1", "dQ2"]

        def __init__(self, ds, quantity):
            self.ds, self.quantity = ds, quantity

        def predict(self, X):
            return self.ds({"dQ1": self.quantity(dq1_of(X), ("sample", "z")),
                            "dQ2": self.quantity(dq2_of(X), ("sample", "z"))})

    def dq1_of(X):
        data = X["qv"].data
        return (torch.from_numpy(dq1) if torch.is_tensor(data)
                else jnp.asarray(dq1))

    def dq2_of(X):
        data = X["qv"].data
        return (torch.from_numpy(dq2) if torch.is_tensor(data)
                else jnp.asarray(dq2))

    scaling = {"dQ2": 3.0, "dQ1": 0.5, "dQu": 2.0}
    got = tml.predict_with_qv_constraint(
        Model(Dataset, Quantity),
        {"qv": Quantity(torch.from_numpy(q), ("sample", "z"))}, 900.0,
        scaling=scaling)
    want = jml.predict_with_qv_constraint(
        Model(JDataset, JQuantity), {"qv": _jq(q)}, 900.0, scaling=scaling)
    for k in ("dQ1", "dQ2"):
        np.testing.assert_array_equal(got[k].values, np.asarray(
            want[k].data))
    plain = tml.predict(Model(Dataset, Quantity), {"qv": Quantity(
        torch.from_numpy(q), ("sample", "z"))}, scaling=scaling)
    np.testing.assert_array_equal(plain["dQ2"].values, 3.0 * dq2)


def test_prepare_config_subcommand(tmp_path):
    """``prepare-config`` of both CLIs on a config path and on literal
    YAML, with ``--precompiled-case``: the same files."""
    src = tmp_path / "in.yaml"
    src.write_text(yaml.safe_dump({"CASE_NAME": "x", "ATM_NCPL": 48}))
    for argv in ([str(src)], ["CASE_NAME: y\nnpz: 16\n"],
                 [str(src), "--precompiled-case"]):
        outs = []
        for name, main in (("port", tcli.main), ("ref", jcli.main)):
            out = str(tmp_path / f"{name}.yaml")
            assert main(["prepare-config", argv[0], out] + argv[1:]) == 0
            outs.append(open(out).read())
        assert outs[0] == outs[1], argv


def test_run_needs_the_card_by_default(tmp_path):
    path = tmp_path / "s.yaml"
    path.write_text(yaml.safe_dump({"RUNTIME": {"STOP_OPTION": "nsteps",
                                                "STOP_N": 1}}))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            tcli.main(["run", str(path), str(tmp_path / "run")])


@pytest.fixture(scope="module")
def scream_runs(tmp_path_factory):
    """Both CLIs' ``write-rundir`` then ``run`` on one config (ne4pg2,
    ATM_NCPL 96, 3 steps, npz 8) with one dense model the port trains and
    dumps (SCREAM names: T_mid and qv in, dQ1 and dQ2 out, the dQ2 drying
    some columns past their humidity), both TimeLoops in float64; the
    loops the CLIs built, and what they printed."""
    import fv3net_torch.runtime.loop as tloop
    import fv3net_tpu.runtime as jruntime
    from fv3net_torch.fit import io as fit_io
    from fv3net_torch.fit.dense import DenseHyperparameters, train_dense_model

    tmp = tmp_path_factory.mktemp("scream")
    rng = np.random.RandomState(0)
    n = 128
    dims = ("sample", "z")
    batch = Dataset({
        "T_mid": Quantity(torch.from_numpy(260 + 20 * rng.rand(n, NZ)), dims),
        "qv": Quantity(torch.from_numpy(1e-3 * rng.rand(n, NZ)), dims),
        "dQ1": Quantity(torch.from_numpy(1e-4 * rng.randn(n, NZ)), dims),
        "dQ2": Quantity(torch.from_numpy(-3e-6 * rng.rand(n, NZ)), dims),
    })
    model = train_dense_model(DenseHyperparameters(
        input_variables=["T_mid", "qv"], output_variables=["dQ1", "dQ2"],
        hidden_layers=1, width=16, epochs=1), [batch])
    model_path = str(tmp / "model")
    fit_io.dump(model, model_path)
    cfg = {"CASE_NAME": "port_case", "RESOLUTION": "ne4pg2_ne4pg2",
           "ATM_NCPL": 96, "npz": NZ,
           "RUNTIME": {"STOP_OPTION": "nsteps", "STOP_N": STEPS},
           "machine_learning": {"models": [model_path]}}
    cfg_path = str(tmp / "scream.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)

    loops = {}

    def recording(cls, key, **forced):
        class Recorded(cls):
            def __init__(self, *args, **kwargs):
                kwargs.update(forced)
                super().__init__(*args, **kwargs)
                loops[key] = self

        return Recorded

    saved = (jruntime.TimeLoop, tloop.TimeLoop, tcli.DTYPE)
    jruntime.TimeLoop = recording(saved[0], "ref", dtype=jnp.float64)
    tloop.TimeLoop = recording(saved[1], "port")
    tcli.DTYPE = torch.float64
    printed = {}
    try:
        for key, main, extra in (("ref", jcli.main, []),
                                 ("port", tcli.main, ["--device", "cpu"])):
            rundir = str(tmp / key)
            assert main(["write-rundir", cfg_path, rundir]) == 0
            rundir_cfg = os.path.join(rundir, "scream_config.yaml")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main(["run", rundir_cfg, rundir] + extra) == 0
            printed[key] = json.loads(buf.getvalue().splitlines()[-1])
    finally:
        jruntime.TimeLoop, tloop.TimeLoop, tcli.DTYPE = saved
    return loops, printed


def test_run_cli_matches_reference(scream_runs):
    loops, printed = scream_runs
    assert printed["port"] == printed["ref"] == {"case": "port_case",
                                                 "steps_completed": STEPS}
    jd, td = loops["ref"]._derived(), loops["port"]._derived()
    assert td[STATE[0]].data.dtype == torch.float64
    assert td[STATE[0]].shape == (6, NZ, 8, 8)  # C8
    for name in STATE:
        want = np.asarray(jd[name].data)
        got = td[name].values
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= RUN_RTOL, (name, err)
    # the correction dried columns to the limiter's floor: q >= 0 up to
    # the roundoff of q + dt (-q / dt)
    q = td["specific_humidity"].values
    assert q.min() >= -4 * np.finfo(np.float64).eps * q.max()
