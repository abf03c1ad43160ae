"""Experiment orchestration (port of ``fv3net_tpu/workflows``: the jobs
take ``device``, default ``cuda``).

reference: workflows/argo (15 Argo WorkflowTemplates chaining
training-data -> train -> prognostic-run -> diags on k8s) and
projects/microphysics/scripts/end_to_end.py:43-135 (PrognosticJob /
TrainingJob dataclasses submitted to Argo).  Without a cluster the same
chain runs in-process: each job is a dataclass with a ``run`` method,
and ``EndToEnd`` executes a list of jobs with provenance printing.
"""
from fv3net_torch.workflows.end_to_end import (  # noqa: F401
    DiagnosticsJob,
    EndToEnd,
    PrognosticJob,
    TrainingJob,
)
