"""ScreamConfig (port of ``fv3net_tpu/scream_run/config.py``, whose
generated ``run_case.sh`` here names ``scream-run-torch``; reference:
prognostic_scream_run/scream_run/config.py:66
— the CIME case knobs; the subset that is meaningful without E3SM keeps
its names and semantics, the build-system knobs are accepted and
recorded so reference configs parse)."""
from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Any, Dict, List, Optional, Union

import yaml


@dataclasses.dataclass
class RuntimeScreamConfig:
    """(reference config.py RuntimeScreamConfig subset)"""

    STOP_OPTION: str = "ndays"
    STOP_N: int = 1
    REST_OPTION: str = "ndays"
    REST_N: int = 1


@dataclasses.dataclass
class ScreamConfig:
    output_yaml: Union[str, List[str]] = ""
    initial_conditions_type: str = "local"
    create_newcase: bool = True
    case_setup: bool = True
    case_build: bool = True
    number_of_processors: int = 1
    CASE_ROOT: str = ""
    CASE_NAME: str = "scream_test"
    COMPSET: str = "F2010-SCREAMv1"
    RESOLUTION: str = "ne30pg2_ne30pg2"
    ATM_NCPL: int = 96  # atmosphere steps per day
    RUN_STARTDATE: Union[str, datetime.date] = "2010-01-01"
    MODEL_START_TYPE: str = "initial"
    OLD_EXECUTABLE: str = ""
    RUNTIME: RuntimeScreamConfig = dataclasses.field(
        default_factory=RuntimeScreamConfig
    )
    # ML correction (this build's addition; the reference passes it via
    # the output yaml + namelist)
    machine_learning: Optional[Dict[str, Any]] = None
    npz: int = 32

    def __post_init__(self):
        if self.initial_conditions_type != "local":
            raise ValueError(
                "initial_conditions_type must be 'local' (the reference "
                "has the same restriction, config.py:85-93)"
            )

    @property
    def npx(self) -> int:
        """Map an neXpg2 SCREAM resolution onto a comparable cubed-sphere
        size: ne-N spectral elements with 2x2 physics columns per element
        ~ C(2N)."""
        m = re.match(r"ne(\d+)", self.RESOLUTION)
        if not m:
            raise ValueError(f"unrecognized RESOLUTION {self.RESOLUTION}")
        return 2 * int(m.group(1))

    @property
    def dt_atmos(self) -> float:
        return 86400.0 / self.ATM_NCPL

    @property
    def duration_seconds(self) -> float:
        n = self.RUNTIME.STOP_N
        unit = self.RUNTIME.STOP_OPTION
        return {
            "ndays": n * 86400.0,
            "nhours": n * 3600.0,
            "nsteps": n * self.dt_atmos,
        }[unit]

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ScreamConfig":
        d = dict(d)
        if "RUNTIME" in d and isinstance(d["RUNTIME"], dict):
            d["RUNTIME"] = RuntimeScreamConfig(**d["RUNTIME"])
        return cls(**d)

    @classmethod
    def from_yaml(cls, path: str) -> "ScreamConfig":
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))

    def write_rundir(self, rundir: str) -> str:
        """Materialize the case run directory (reference cli.py
        write_rundir: output yamls + run script into rundir)."""
        os.makedirs(rundir, exist_ok=True)
        with open(os.path.join(rundir, "scream_config.yaml"), "w") as f:
            yaml.safe_dump(dataclasses.asdict(self), f, default_flow_style=False)
        run_script = os.path.join(rundir, "run_case.sh")
        with open(run_script, "w") as f:
            f.write(
                "#!/bin/bash\n"
                "# generated by fv3net_torch scream-run-torch write-rundir\n"
                f"scream-run-torch run {rundir}/scream_config.yaml {rundir}\n"
            )
        os.chmod(run_script, 0o755)
        return rundir
