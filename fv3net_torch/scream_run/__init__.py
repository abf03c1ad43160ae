"""SCREAM prognostic-run driver (port of ``fv3net_tpu/scream_run``;
reference: workflows/prognostic_scream_run — a thin CLI + config layer
that writes an E3SM-SCREAM case run directory and drives the GPU C++
model through CIME, with an ML stepper applying corrective tendencies in
SCREAM variable conventions).

The E3SM binary does not exist in this environment; the case here runs
this port's model as the atmosphere, on the card unless the CLI's
``--device`` says otherwise, while preserving the reference's surface:
`ScreamConfig` (CASE_NAME / RESOLUTION / ATM_NCPL / RUN_STARTDATE...),
`scream-run-torch write-rundir` / `scream-run-torch run` CLI (reference
scream_run/cli.py:37-70), and the SCREAM-named ML stepper with the
non-negative-humidity constraint
(scream_run/steppers/machine_learning.py).
"""
from fv3net_torch.scream_run.config import ScreamConfig  # noqa: F401
from fv3net_torch.scream_run.ml import (  # noqa: F401
    MachineLearningConfig,
    open_model,
    predict_with_qv_constraint,
)
