"""User-facing config preparation: base presets + overlays (a copy of
``fv3net_tpu/runtime/segmented_run/prepare_config.py``; its
``prepare-config`` CLI is the console script ``prepare-config-torch``).

reference: workflows/prognostic_c48_run/runtime/segmented_run/
prepare_config.py:51-155 — ``HighLevelConfig`` composes versioned base
configs (fv3kube base_yamls) with user overlays and lowers them to the
runtime config; ``get_config`` routes a ``base_version`` dict here, and
the ``prepare-config`` CLI prints the lowered yaml.
"""
from __future__ import annotations

import argparse
import copy
import sys
from typing import Any, Dict, Mapping

import yaml

# versioned base presets (the fv3kube base_yamls analog,
# reference external/fv3kube/fv3kube/config.py)
BASE_CONFIGS: Dict[str, Dict[str, Any]] = {
    "v0.1/aquaplanet_c48": {
        "namelist": {
            "npx": 48,
            "npz": 32,
            "dt_atmos": 900.0,
            "n_split": 2,
        },
        "duration_seconds": 3600.0,
        "diagnostics": [
            {
                "name": "diags.zarr",
                "variables": [
                    "surface_precipitation_rate",
                    "PRATEsfc",
                    "LHTFLsfc",
                    "SHTFLsfc",
                    "ULWRFtoa",
                    "DSWRFtoa",
                ],
                "times": {"kind": "interval-average", "frequency": 3600.0},
            },
            {
                "name": "state_after_timestep.zarr",
                "variables": [
                    "tendency_of_air_temperature_due_to_fv3_physics",
                    "tendency_of_specific_humidity_due_to_fv3_physics",
                ],
                "times": {"kind": "every"},
            },
        ],
    },
    "v0.1/aquaplanet_c12_test": {
        "namelist": {"npx": 12, "npz": 16, "dt_atmos": 900.0, "n_split": 2},
        "duration_seconds": 1800.0,
        "diagnostics": [
            {
                "name": "diags.zarr",
                "variables": ["PRATEsfc", "ULWRFtoa"],
                "times": {"kind": "every"},
            }
        ],
    },
}


def merge_overlays(base: Mapping, *overlays: Mapping) -> Dict[str, Any]:
    """Deep merge, later overlays win (reference fv3kube
    merge_fv3config_overlays)."""
    out = copy.deepcopy(dict(base))
    for overlay in overlays:
        _merge_into(out, overlay)
    return out


def _merge_into(dst: Dict, src: Mapping) -> None:
    for key, value in src.items():
        if (
            key in dst
            and isinstance(dst[key], dict)
            and isinstance(value, Mapping)
        ):
            _merge_into(dst[key], value)
        else:
            dst[key] = copy.deepcopy(value)


def prepare_config(user: Mapping) -> Dict[str, Any]:
    """Lower a user config with a ``base_version`` key to a full runtime
    config dict (reference prepare_config.py:51-155 to_fv3config)."""
    user = dict(user)
    base_version = user.pop("base_version", None)
    base = BASE_CONFIGS.get(base_version, {}) if base_version else {}
    merged = merge_overlays(base, user)
    # validate strictly
    from fv3net_torch.runtime.config import get_config

    get_config(merged)
    return merged


def main(argv=None) -> int:
    """``prepare-config`` CLI (reference setup.py:36)."""
    parser = argparse.ArgumentParser("prepare-config")
    parser.add_argument("user_config")
    args = parser.parse_args(argv)
    with open(args.user_config) as f:
        user = yaml.safe_load(f)
    yaml.safe_dump(prepare_config(user), sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
