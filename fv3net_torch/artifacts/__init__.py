"""Experiment bookkeeping (reference: external/artifacts)."""
from fv3net_torch.artifacts.metadata import StepMetadata  # noqa: F401
from fv3net_torch.artifacts.resolve_url import resolve_url  # noqa: F401
