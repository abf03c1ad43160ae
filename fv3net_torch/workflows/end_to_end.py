"""Local end-to-end job chain: train -> prognostic run -> diagnostics
(port of ``fv3net_tpu/workflows/end_to_end.py``: every job runs on its
``device``, the card unless the caller asks for the CPU).

reference: projects/microphysics/scripts/end_to_end.py:43-135 (job
dataclasses with argo submission) + workflows/argo/train-diags-prog.yaml
(the chained WorkflowTemplate).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence

from fv3net_torch.artifacts import StepMetadata


@dataclasses.dataclass
class TrainingJob:
    """Train a model from a config dict and in-memory batches, moved to
    ``device`` (reference end_to_end.py TrainingJob)."""

    name: str
    config: Dict[str, Any]
    output: str
    train_batches: Any = None
    validation_batches: Any = None
    device: str = "cuda"

    def run(self, workspace: str) -> str:
        from fv3net_torch.fit.train import batches_on, train_main
        from fv3net_torch.pipelines import resolve_device

        device = resolve_device(self.device)
        out = os.path.join(workspace, self.output)
        batches = self.train_batches
        if batches is None:
            from fv3net_torch.loaders import batches_from_config

            batches = batches_from_config(self.config["data"])
        validation = self.validation_batches
        if validation is not None:
            validation = batches_on(validation, device)
        train_main(self.config, batches_on(batches, device), validation, out)
        StepMetadata("training", out, args=[self.name]).print_json()
        return out


@dataclasses.dataclass
class PrognosticJob:
    """Create + run a segmented prognostic run on ``device``
    (reference end_to_end.py PrognosticJob)."""

    name: str
    config: Dict[str, Any]
    segments: int = 1
    device: str = "cuda"

    def run(self, workspace: str) -> str:
        from fv3net_torch.pipelines import resolve_device
        from fv3net_torch.runtime.segmented_run import api

        device = resolve_device(self.device)
        url = os.path.join(workspace, self.name)
        api.create(url, self.config)
        for _ in range(self.segments):
            api.append_segment(url, device=device)
        StepMetadata("prognostic_run", url, args=[self.name]).print_json()
        return url


@dataclasses.dataclass
class DiagnosticsJob:
    """Compute diagnostics on ``device`` + report for a finished run (the
    report needs matplotlib and raises its ImportError without it)."""

    name: str
    run_url: str = ""  # filled from the previous job if empty
    device: str = "cuda"

    def run(self, workspace: str, run_url: Optional[str] = None) -> str:
        from fv3net_torch.diagnostics.cli import compute_cmd, report_cmd

        url = self.run_url or run_url
        diags = os.path.join(workspace, f"{self.name}_diags.zarr")
        compute_cmd(url, diags, device=self.device)
        report_dir = os.path.join(workspace, f"{self.name}_report")
        report_cmd(diags, report_dir)
        StepMetadata("diagnostics", report_dir, args=[self.name]).print_json()
        return report_dir


class EndToEnd:
    """Run jobs in order, forwarding each output to the next
    (the train-diags-prog chain of workflows/argo/train-diags-prog.yaml)."""

    def __init__(self, jobs: Sequence, workspace: str):
        self.jobs = list(jobs)
        self.workspace = workspace

    def run(self) -> List[str]:
        os.makedirs(self.workspace, exist_ok=True)
        outputs: List[str] = []
        last: Optional[str] = None
        for job in self.jobs:
            if isinstance(job, DiagnosticsJob):
                last = job.run(self.workspace, run_url=last)
            else:
                last = job.run(self.workspace)
            outputs.append(last)
        return outputs
