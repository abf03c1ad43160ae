"""HTML report generation (reference: external/report/report/
create_report.py:85-111 — create_report with sections of ImagePlot /
Link / RawHTML items, metadata/metrics tables)."""
from fv3net_torch.report.create_report import (  # noqa: F401
    HTML,
    ImagePlot,
    Link,
    OrderedList,
    RawHTML,
    MatplotlibFigure,
    create_html,
    create_report,
    fig_to_b64,
    upload,
)
