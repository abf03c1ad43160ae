"""The port's local workflows (``fv3net_torch.workflows``) against
``fv3net_tpu.workflows``: every shipped Argo template is the reference's
DAG with only the module names mapped (console scripts and
``fv3net_tpu`` modules to ``python -m fv3net_torch....``) and the added
``device`` parameter handed to each CLI's ``--device``; the executor on
the reference test's toy DAG; ``resolve-output-url`` and
``cubed-to-latlon`` end to end as subprocesses on the CPU;
``chgres-cube`` refusing a refinement; and a small ``EndToEnd`` chain
(train, prognostic run, diagnostics) on the CPU whose trained model the
reference's ``fit.load`` reads with equal predictions."""
import os
import re

import numpy as np
import pytest
import torch
import yaml

import torch_port_util  # noqa: F401  (torch threads under xdist)

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.workflows import templates as ttemplates
from fv3net_torch.workflows import (DiagnosticsJob, EndToEnd, PrognosticJob,
                                    TrainingJob)
from fv3net_tpu.workflows import templates as jtemplates

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
DEVICE_ARG = "--device {{inputs.parameters.device}}"
DEVICE_KWARG = '    device="{{inputs.parameters.device}}",\n'
DEVICE_PARAM = {"name": "device"}
# the reference's console scripts and the port's modules that run them
SCRIPTS = (("runfv3 ", "python -m fv3net_torch.runtime.segmented_run.cli "),
           ("prognostic-run-diags ", "python -m fv3net_torch.diagnostics.cli "),
           ("post-process-run ", "python -m fv3net_torch.post_process_cli "),
           ("scream-run ", "python -m fv3net_torch.scream_run.cli "))
# the CLIs whose work is on tensors, each of which takes --device
TENSOR_CLIS = re.compile(
    r"segmented_run\.cli append|diagnostics\.cli (compute|metrics)"
    r"|post_process_cli|scream_run\.cli run|fit\.train|fit\.sweep"
    r"|pipelines\.coarsen_restarts")


def _mapped(text):
    """The reference's text with only the module names mapped."""
    text = text.replace("fv3net_tpu", "fv3net_torch")
    for script, module in SCRIPTS:
        text = re.sub(r"(?<![\w.-])" + re.escape(script), module, text)
    return text


def _without_device(text):
    return text.replace(DEVICE_ARG + " ", "").replace(DEVICE_KWARG, "")


def _docs(name):
    with open(os.path.join(jtemplates.TEMPLATE_DIR, name + ".yaml")) as f:
        ref = yaml.safe_load(f)
    with open(os.path.join(ttemplates.TEMPLATE_DIR, name + ".yaml")) as f:
        port = yaml.safe_load(f)
    return ref, port


def test_the_port_ships_the_reference_templates():
    names = ttemplates.list_templates()
    assert names == jtemplates.list_templates()
    assert len(names) == 15
    assert ttemplates.TEMPLATE_DIR.startswith(os.path.join(
        REPO, "fv3net_torch"))


@pytest.mark.parametrize("name", jtemplates.list_templates())
def test_template_is_the_reference_dag_with_the_port_modules(name):
    """Metadata, entrypoint, every template's inputs, DAG tasks (names,
    templates, dependencies, arguments), retries and script commands are
    the reference's; a script's source is the reference's with the module
    names mapped once its ``--device`` flags are taken out; the device
    flags sit on every tensor CLI and nowhere else; the added ``device``
    parameter defaults to ``cuda`` at the entrypoint."""
    ref, port = _docs(name)
    assert port["metadata"] == ref["metadata"]
    assert port["spec"]["entrypoint"] == ref["spec"]["entrypoint"]
    ref_t = {t["name"]: t for t in ref["spec"]["templates"]}
    port_t = {t["name"]: t for t in port["spec"]["templates"]}
    assert list(port_t) == list(ref_t)
    uses_device = False
    for tname, rt in ref_t.items():
        pt = port_t[tname]
        assert set(pt) == set(rt), tname
        r_in = rt.get("inputs", {}).get("parameters", [])
        p_in = pt.get("inputs", {}).get("parameters", [])
        if len(p_in) == len(r_in) + 1:
            assert p_in[:-1] == r_in and p_in[-1]["name"] == "device"
            want = ({"name": "device", "value": "cuda"}
                    if tname == ref["spec"]["entrypoint"] else DEVICE_PARAM)
            assert p_in[-1] == want, tname
            uses_device = True
        else:
            assert p_in == r_in, tname
        assert pt.get("retryStrategy") == rt.get("retryStrategy")
        if "dag" in rt:
            r_tasks, p_tasks = rt["dag"]["tasks"], pt["dag"]["tasks"]
            assert [t["name"] for t in p_tasks] == [t["name"]
                                                    for t in r_tasks]
            for r_task, p_task in zip(r_tasks, p_tasks):
                assert {k: v for k, v in p_task.items() if k != "arguments"
                        } == {k: v for k, v in r_task.items()
                              if k != "arguments"}
                r_args = r_task.get("arguments", {}).get("parameters", [])
                p_args = p_task.get("arguments", {}).get("parameters", [])
                callee = port_t[p_task["template"]]
                if DEVICE_PARAM["name"] in [
                        p["name"] for p in callee["inputs"]["parameters"]]:
                    assert p_args[-1] == {
                        "name": "device",
                        "value": "{{inputs.parameters.device}}"}
                    p_args = p_args[:-1]
                assert [a["name"] for a in p_args] == [a["name"]
                                                       for a in r_args]
                for a, b in zip(p_args, r_args):
                    assert _without_device(a["value"]) == _mapped(
                        b["value"])
                    assert len(TENSOR_CLIS.findall(a["value"])) == a[
                        "value"].count(DEVICE_ARG)
                    uses_device |= DEVICE_ARG in a["value"]
        if "script" in rt:
            rs, ps = rt["script"], pt["script"]
            assert set(ps) == set(rs)
            assert ps["command"] == rs["command"]
            assert _without_device(ps["source"]) == _mapped(rs["source"])
            tensor = len(TENSOR_CLIS.findall(ps["source"]))
            assert ps["source"].count(DEVICE_ARG) == tensor, tname
            if "regrid_zarr_to_latlon(" in ps["source"] or (
                    "compute_offline_diags(" in ps["source"]):
                assert DEVICE_KWARG in ps["source"]
                tensor += 1
            assert tensor == 0 or {"name": "device"} in [
                {"name": p["name"]} for p in pt["inputs"]["parameters"]]
    port_tpl = ttemplates.WorkflowTemplate.load(name)
    assert (port_tpl.parameters().get("device") == "cuda") == uses_device


@pytest.mark.parametrize("name", jtemplates.list_templates())
def test_resolved_tasks_match_the_reference(name):
    """Both templates resolved with the same parameters: the same tasks,
    dependencies and retries in the same order, and the port's commands
    the reference's mapped, with ``--device cuda`` on the tensor CLIs."""
    ref = jtemplates.WorkflowTemplate.load(name)
    port = ttemplates.WorkflowTemplate.load(name)
    params = {k: (v if v is not None else f"/p/{k}")
              for k, v in ref.parameters().items()}
    if "source_resolution" in params:
        params.update(source_resolution="C48", target_resolution="C12")
    r_tasks = jtemplates._toposort(ref.resolve_tasks(params))
    p_tasks = ttemplates._toposort(port.resolve_tasks(params))
    assert [(t.name, t.dependencies, t.retries, t.backoff_seconds)
            for t in p_tasks] == [(t.name, t.dependencies, t.retries,
                                   t.backoff_seconds) for t in r_tasks]
    for r, p in zip(r_tasks, p_tasks):
        text = " ".join(p.command)
        assert text.count("--device cuda") == len(
            TENSOR_CLIS.findall(text))
        stripped = text.replace("--device cuda ", "").replace(
            '    device="cuda",\n', "")
        assert stripped == _mapped(" ".join(r.command))


# ---------------------------------------------------------- the executor
TOY = """
apiVersion: argoproj.io/v1alpha1
kind: WorkflowTemplate
metadata: {name: toy}
spec:
  entrypoint: main
  templates:
  - name: main
    inputs:
      parameters:
      - name: msg
      - {name: outdir, value: /tmp}
    dag:
      tasks:
      - name: second
        dependencies: [first]
        template: append
        arguments:
          parameters:
          - {name: text, value: "second-{{inputs.parameters.msg}}"}
          - {name: outdir, value: "{{inputs.parameters.outdir}}"}
      - name: first
        template: append
        arguments:
          parameters:
          - {name: text, value: "first-{{inputs.parameters.msg}}"}
          - {name: outdir, value: "{{inputs.parameters.outdir}}"}
  - name: append
    inputs:
      parameters: [{name: text}, {name: outdir}]
    script:
      command: [bash, -c]
      source: |
        echo {{inputs.parameters.text}} >> {{inputs.parameters.outdir}}/log.txt
"""


def test_executor_order_retries_and_refusals(tmp_path):
    """The reference test's toy DAG through the port's executor: the
    dependency order, the substitution, an unknown parameter, a failed
    task retried then raised, a cycle."""
    t = ttemplates.WorkflowTemplate(yaml.safe_load(TOY))
    results = ttemplates.run_workflow(t, {"msg": "hello",
                                          "outdir": str(tmp_path)})
    assert list(results) == ["first", "second"]
    assert (tmp_path / "log.txt").read_text().split() == ["first-hello",
                                                          "second-hello"]
    with pytest.raises(ValueError, match="unknown parameters"):
        t.resolve_tasks({"msg": "x", "typo": "y"})
    doc = yaml.safe_load(TOY)
    doc["spec"]["templates"][1]["script"]["source"] = (
        "echo attempt >> {{inputs.parameters.outdir}}/tries.txt; exit 1")
    doc["spec"]["templates"][1]["retryStrategy"] = {
        "limit": 2, "backoff": {"duration": "0s"}}
    with pytest.raises(RuntimeError, match="failed at task first"):
        ttemplates.run_workflow(ttemplates.WorkflowTemplate(doc), {
            "msg": "x", "outdir": str(tmp_path)})
    assert (tmp_path / "tries.txt").read_text().count("attempt") == 3
    doc = yaml.safe_load(TOY)
    doc["spec"]["templates"][0]["dag"]["tasks"][1]["dependencies"] = [
        "second"]
    with pytest.raises(ValueError, match="cycle"):
        ttemplates.run_workflow(ttemplates.WorkflowTemplate(doc), {"msg": "x"})
    for name in ttemplates.list_templates():
        tpl = ttemplates.WorkflowTemplate.load(name)
        if any(v is None for v in tpl.parameters().values()):
            with pytest.raises(ValueError, match="missing required"):
                tpl.resolve_tasks({})


# ---------------------------------------------------------- as subprocesses
def test_resolve_output_url_end_to_end():
    t = ttemplates.WorkflowTemplate.load("resolve-output-url")
    results = ttemplates.run_workflow(
        t, {"bucket": "gs://bkt", "project": "proj", "tag": "exp-1"},
        workdir=REPO, env=ENV)
    out = results["resolve-output-url"].stdout.strip()
    ref = jtemplates.run_workflow(
        jtemplates.WorkflowTemplate.load("resolve-output-url"),
        {"bucket": "gs://bkt", "project": "proj", "tag": "exp-1"},
        workdir=REPO, env=ENV)["resolve-output-url"].stdout.strip()
    assert out == ref
    assert out.startswith("gs://bkt/proj/") and out.endswith("/exp-1")


def test_cubed_to_latlon_end_to_end(tmp_path):
    """The template regrids a cube store the port writes, on the CPU;
    the port's output equals a direct call of the port's
    ``regrid_zarr_to_latlon``, and the global mean is kept."""
    from fv3net_torch.core.zarrio import open_zarr, to_zarr
    from fv3net_torch.post_process import regrid_zarr_to_latlon

    n = 12
    rng = np.random.RandomState(0)
    ds = Dataset({"h500": Quantity(rng.randn(2, 6, n, n).astype(np.float32),
                                   ("time", "tile", "y", "x"))},
                 coords={"time": np.arange(2)})
    src, dst = str(tmp_path / "cube.zarr"), str(tmp_path / "latlon.zarr")
    to_zarr(ds, src)
    t = ttemplates.WorkflowTemplate.load("cubed-to-latlon")
    if not torch.cuda.is_available():
        # the card by default: without one the task fails
        with pytest.raises(RuntimeError, match="failed at task regrid"):
            ttemplates.run_workflow(t, {"input-zarr": src,
                                        "output-zarr": dst, "nlat": "24",
                                        "nlon": "48"}, workdir=REPO, env=ENV)
    results = ttemplates.run_workflow(
        t, {"input-zarr": src, "output-zarr": dst, "nlat": "24",
            "nlon": "48", "device": "cpu"}, workdir=REPO, env=ENV)
    assert results["regrid"].succeeded
    out = open_zarr(dst)
    assert out["h500"].shape == (2, 24, 48)
    regrid_zarr_to_latlon(src, str(tmp_path / "direct.zarr"), 24, 48,
                          device="cpu")
    np.testing.assert_array_equal(out["h500"].values, open_zarr(str(
        tmp_path / "direct.zarr"))["h500"].values)
    assert abs(float(out["h500"].values.mean())) < 1.0


def test_chgres_cube_refuses_a_refinement(tmp_path):
    t = ttemplates.WorkflowTemplate.load("chgres-cube")
    with pytest.raises(RuntimeError, match="unsupported resolution change"):
        ttemplates.run_workflow(t, {
            "restarts": str(tmp_path), "source_resolution": "C48",
            "target_resolution": "C384",
            "destination": str(tmp_path / "out"), "device": "cpu"},
            workdir=REPO, env=ENV)


# ---------------------------------------------------------- the job chain
NZ, NPX = 10, 6


def _batch(n=256):
    rng = np.random.RandomState(0)
    dims = ("sample", "z")
    return Dataset({
        "air_temperature": Quantity(250 + 40 * rng.rand(n, NZ), dims),
        "specific_humidity": Quantity(0.01 * rng.rand(n, NZ), dims),
        "dQ1": Quantity(1e-6 * rng.randn(n, NZ), dims),
        "dQ2": Quantity(1e-9 * rng.randn(n, NZ), dims),
    })


TRAIN = {"model_type": "dense", "hyperparameters": {
    "input_variables": ["air_temperature", "specific_humidity"],
    "output_variables": ["dQ1", "dQ2"], "hidden_layers": 1, "width": 32,
    "epochs": 2}}


def test_jobs_need_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        return
    for job in (TrainingJob("t", TRAIN, "m", train_batches=[_batch(8)]),
                PrognosticJob("r", {}), DiagnosticsJob("d", "/none")):
        with pytest.raises((RuntimeError, AssertionError)):
            job.run(str(tmp_path))
    assert TrainingJob("t", {}, "m").device == "cuda"


def test_end_to_end_chain_on_the_cpu(tmp_path, capsys):
    """The reference test's chain on the CPU: the dense 1 x 32 trainer,
    then a C6 run with the model, then the diagnostics and the report;
    each job prints its provenance line; the trained model, read by the
    reference's ``fit.load``, predicts what the port's predicts."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from fv3net_torch.core import zarrio
    from fv3net_torch.fit import io
    from fv3net_tpu import fit as jfit
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    run_cfg = {
        "namelist": {"npx": NPX, "npz": NZ, "dt_atmos": 900.0,
                     "n_split": 2},
        "duration_seconds": 1800.0,
        "scikit_learn": {"model": [str(tmp_path / "ws" / "model")]},
        "diagnostics": [{"name": "diags.zarr",
                         "variables": ["PRATEsfc", "ULWRFtoa",
                                       "dQ1_machine_learning"],
                         "times": {"kind": "every"}}],
    }
    ws = str(tmp_path / "ws")
    outputs = EndToEnd([
        TrainingJob("train-dq", TRAIN, "model", train_batches=[_batch()],
                    device="cpu"),
        PrognosticJob("run1", run_cfg, device="cpu"),
        DiagnosticsJob("run1", device="cpu")], ws).run()
    assert outputs[0] == os.path.join(ws, "model")
    assert outputs[1] == os.path.join(ws, "run1")
    html = open(os.path.join(outputs[2], "index.html")).read()
    assert "PRATEsfc" in html
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith('{"step_metadata"')]
    assert [yaml.safe_load(line)["step_metadata"]["job_type"]
            for line in printed] == ["training", "prognostic_run",
                                     "diagnostics"]
    seg = sorted(os.listdir(os.path.join(ws, "run1", "artifacts")))[0]
    ds = zarrio.open_zarr(os.path.join(ws, "run1", "artifacts", seg,
                                       "diags.zarr"))
    assert ds["dQ1_machine_learning"].shape[0] == 2
    assert np.isfinite(ds["dQ1_machine_learning"].values).all()
    assert np.abs(ds["dQ1_machine_learning"].values).max() > 0
    # the artifact both ways: the reference reads the port's model
    batch = _batch(32)
    mine = io.load(outputs[0]).to(dtype=torch.float64).predict(Dataset({
        k: Quantity(torch.from_numpy(batch[k].values), batch[k].dims)
        for k in ("air_temperature", "specific_humidity")}))
    ref = jfit.load(outputs[0]).predict(JDataset({
        k: JQuantity(jnp.asarray(batch[k].values), batch[k].dims)
        for k in ("air_temperature", "specific_humidity")}))
    for k in ("dQ1", "dQ2"):
        want = np.asarray(ref[k].data, np.float64)
        got = mine[k].values
        # the artifact's float32 weights, applied in float64 by the port
        # and in the reference's dtype by the reference
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-6, (k, err)
