"""Prognostic-run diagnostics (port of
``fv3net_tpu/diagnostics/prognostic``; reference:
workflows/diagnostics/fv3net/diagnostics/prognostic_run/)."""
