"""Streamlit web app for browsing a run's statistics stream.

The reference's interactive log viewer (reference
workflows/diagnostics/fv3net/diagnostics/prognostic_run/apps/
log_viewer.py) plots the per-step conservation/statistics series of a
(segmented) run in a browser.  This build's runs emit the same role of
data as a JSON statistics stream (`logs.json` per segment,
runtime/logs.py) and optionally legacy Fortran stdout logs
(runtime/fv3logs.py); this app renders either.

streamlit is not vendored in this environment — the module imports it
lazily and the CLI (`prognostic-run-diags log-viewer-web <rundir>`)
gives an actionable error when it is missing.  Launch manually with:

    streamlit run fv3net_torch/diagnostics/prognostic/apps/log_viewer.py \
        -- <rundir>

Host copy of ``fv3net_tpu/diagnostics/prognostic/apps/log_viewer.py``.
"""
from __future__ import annotations

import glob
import os
import sys


def load_series(url: str):
    """{name: (times, values)} from every logs.json under a run dir
    (segmented layout artifacts/<seg>/logs.json or a flat logs.json)."""
    import numpy as np

    from fv3net_torch.runtime.logs import loads

    paths = sorted(
        glob.glob(os.path.join(url, "artifacts", "*", "logs.json"))
        or glob.glob(os.path.join(url, "logs.json"))
    )
    times, scalars = [], {}
    for p in paths:
        with open(p) as f:
            log = loads(f.read())
        offset = len(times)
        times.extend(log.times)
        for name, vals in log.scalars.items():
            series = scalars.setdefault(name, [np.nan] * offset)
            series.extend(vals)
    n = len(times)
    for name in scalars:
        scalars[name] += [float("nan")] * (n - len(scalars[name]))
    return times, scalars


def main(url: str) -> None:
    import streamlit as st  # lazy: not vendored in every environment

    st.title("Prognostic run log viewer")
    st.caption(url)
    times, scalars = load_series(url)
    if not times:
        st.error(f"no logs.json found under {url}")
        return
    st.write(f"{len(times)} records, {times[0]} .. {times[-1]}")
    names = sorted(scalars)
    # grouped series the reference app plots together: water species,
    # then surface pressure, then everything the user picks
    groups = {
        "water": [n for n in names if "water" in n or "sphum" in n
                  or "precip" in n],
        "pressure": [n for n in names if "pressure" in n],
    }
    for title, members in groups.items():
        if members:
            st.header(title)
            st.line_chart({m: scalars[m] for m in members})
    st.header("all series")
    pick = st.multiselect("variables", names, default=names[:1])
    if pick:
        st.line_chart({m: scalars[m] for m in pick})


def run_app(url: str) -> None:
    """CLI helper: exec `streamlit run` on this file (the reference's
    run_streamlit subprocess call)."""
    import subprocess

    try:
        import streamlit  # noqa: F401
    except ImportError:
        raise SystemExit(
            "streamlit is not installed in this environment; install it "
            "(pip install streamlit) or use the terminal summary: "
            "`prognostic-run-diags log-viewer <logfile>`"
        )
    subprocess.run(
        [sys.executable, "-m", "streamlit", "run", __file__, "--", url],
        check=True,
    )


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
