"""Validate a user-supplied RRTMG lookup-table directory (a copy of the
numpy-only ``fv3net_tpu/physics/radiation/rrtmg/validate.py``, checking
against the port's own ``tables.py`` and ``io.py`` copies).

The repo ships SYNTHETIC k-distribution tables (tables.py); a production
deployment drops in the measured data in the reference's netCDF layout
(reference external/radiation/radiation/io.py:29-257, downloaded from GCS
by its config.py:4-5 — network egress is unavailable here, so ingestion +
validation is the deliverable).  This module checks such a directory
BEFORE a run: file completeness, per-key shape agreement with the solver
contract (derived from the synthetic schema), dtype sanity, and physical
invariants (non-negative absorption/extinction coefficients, monotone
reference profiles, normalized Planck fractions).

CLI: ``python -m fv3net_torch.physics.radiation.rrtmg.validate <lookup_dir>``
exits non-zero with a problem list, or prints OK.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Mapping

import numpy as np


def _schema(d: Mapping, prefix: str = "") -> Dict[str, tuple]:
    out: Dict[str, tuple] = {}
    for k, v in d.items():
        if isinstance(v, Mapping):
            out.update(_schema(v, prefix=f"{prefix}{k}/"))
        else:
            arr = np.asarray(v)
            out[f"{prefix}{k}"] = arr.shape
    return out


def validate_tables(lwdict: Mapping, swdict: Mapping) -> List[str]:
    """Problems in already-loaded LW/SW table dicts (empty list = valid)."""
    from fv3net_torch.physics.radiation.rrtmg.tables import (
        make_lw_tables,
        make_sw_tables,
    )

    problems: List[str] = []
    for label, loaded, synth in (
        ("lw", lwdict, make_lw_tables(seed=0)),
        ("sw", swdict, make_sw_tables(seed=1)),
    ):
        want = _schema(synth)
        got = _schema(loaded)
        for key, shape in want.items():
            if key not in got:
                problems.append(f"{label}: missing key {key}")
            elif got[key] != shape:
                problems.append(
                    f"{label}: {key} shape {got[key]} != expected {shape}"
                )
        for key in got:
            if key not in want:
                problems.append(f"{label}: unexpected key {key}")

    def flat(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, Mapping):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    for label, loaded in (("lw", lwdict), ("sw", swdict)):
        for key, arr in flat(loaded):
            if not np.isfinite(arr).all():
                problems.append(f"{label}: {key} contains non-finite values")
                continue
            base = key.rsplit("/", 1)[-1]
            # absorption / extinction / self- and foreign-continuum
            # coefficients are non-negative by construction
            if base.startswith(("abs", "ext", "selfref", "forref", "ka_",
                                "kb_", "rayl")):
                if np.asarray(arr, np.float64).min() < -1e-12:
                    problems.append(
                        f"{label}: {key} has negative coefficients "
                        f"(min {float(np.min(arr)):.3e})"
                    )
            if base in ("fracrefa", "fracrefb") and arr.ndim >= 1:
                if float(np.max(arr)) > 1.0 + 1e-6 or float(np.min(arr)) < 0:
                    problems.append(
                        f"{label}: {key} Planck/solar fractions outside "
                        f"[0, 1]"
                    )

    # reference pressure/temperature profiles: preflog strictly
    # decreasing with level index (log surface->TOA), tref within
    # atmospheric range
    for label, loaded in (("lw", lwdict), ("sw", swdict)):
        preflog = np.asarray(loaded.get("preflog", np.zeros(0)))
        if preflog.size and not (np.diff(preflog) < 0).all():
            problems.append(
                f"{label}: preflog is not strictly decreasing "
                "(expected log-pressure surface->TOA)"
            )
        tref = np.asarray(loaded.get("tref", np.zeros(0)))
        if tref.size and (tref.min() < 120.0 or tref.max() > 350.0):
            problems.append(
                f"{label}: tref outside plausible range "
                f"[{tref.min():.1f}, {tref.max():.1f}] K"
            )
    # LW Planck table: total emitted power increases with temperature
    totplnk = np.asarray(lwdict.get("totplnk", np.zeros(0)))
    if totplnk.size and not (np.diff(totplnk.sum(axis=-1)) > 0).all():
        problems.append(
            "lw: totplnk band-summed Planck power is not increasing in "
            "temperature"
        )
    return problems


def validate_lookup_dir(lookup_dir: str) -> List[str]:
    """Problems found in a lookup directory (empty list = valid)."""
    import os

    from fv3net_torch.physics.radiation.rrtmg import io as rio

    problems: List[str] = []
    expected = (
        ["totplnk.nc", "radlw_ref_data.nc", "radlw_cldprlw_data.nc"]
        + [f"radlw_kgb{b:02d}_data.nc" for b in range(1, 17)]
        + ["radsw_sflux_data.nc", "radsw_ref_data.nc",
           "radsw_cldprtb_data.nc"]
        + [f"radsw_kgb{b}_data.nc" for b in range(16, 30)]
    )
    missing = [
        f for f in expected
        if not os.path.exists(os.path.join(lookup_dir, f))
    ]
    if missing:
        return [f"missing file {f}" for f in missing]
    try:
        lwdict = rio.load_lw(lookup_dir)
        swdict = rio.load_sw(lookup_dir)
    except Exception as e:
        return [f"failed to load lookup dir: {e}"]
    problems.extend(validate_tables(lwdict, swdict))
    return problems


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(
            "usage: python -m fv3net_torch.physics.radiation.rrtmg.validate "
            "<lookup_dir>",
            file=sys.stderr,
        )
        return 2
    problems = validate_lookup_dir(argv[0])
    if problems:
        for p in problems:
            print(f"PROBLEM: {p}")
        print(f"{len(problems)} problem(s) found in {argv[0]}")
        return 1
    print(f"OK: {argv[0]} is a valid RRTMG lookup directory")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
