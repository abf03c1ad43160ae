"""Analysis and reporting (port of ``fv3net_tpu/diagnostics``; reference:
workflows/diagnostics fv3net.diagnostics): the prognostic-run
diagnostics registries, scalar metrics, the offline ML diagnostics, the
emulation and reservoir diagnostics and the HTML reports.  The
computations run on tensors on an explicit ``device``."""
