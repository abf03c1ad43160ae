"""Stepper factories: build the steppers a :class:`UserConfig` names
(port of ``fv3net_tpu/runtime/factories.py``; reference:
workflows/prognostic_c48_run/runtime/factories.py:60-150).

Ported: the ML corrector (``scikit_learn``: dense models in the
reference's artifact format), the "prescriber" prephysics kind, the
Python radiation stepper (``radiation_scheme``) and the online
microphysics emulator (``online_emulator``).  The other steppers raise
``NotImplementedError`` naming their ROADMAP.md item; configs that
merely carry their keys without enabling them build nothing, as in the
reference.
"""
from __future__ import annotations

import datetime
from typing import List

from fv3net_torch.runtime.config import UserConfig


def not_ported(what: str, item: int) -> NotImplementedError:
    """The error of an option the port does not run, naming its item of
    ROADMAP.md's Queue 1."""
    return NotImplementedError(
        f"{what} is not ported to fv3net_torch yet (ROADMAP.md Queue 1 "
        f"item {item})"
    )


def _getter(mapper, config: UserConfig, timestep: float):
    """Dataset getter with an index-keyed fallback: mappers keyed by
    %Y%m%d.%H%M%S labels resolve by time; integer-keyed zarr stores
    resolve by step index from the run's initial_time."""
    from fv3net_torch.runtime.interpolate import mapper_getter

    return mapper_getter(
        mapper,
        initial_time=datetime.datetime.fromisoformat(config.initial_time),
        frequency=datetime.timedelta(seconds=timestep),
    )


def get_postphysics_stepper(config: UserConfig, timestep: float,
                            dtype=None, device="cuda"):
    """The ML corrector from ``scikit_learn``: its models loaded from
    their artifact directories and moved to ``device`` in ``dtype``."""
    if config.scikit_learn is not None and config.scikit_learn.model:
        from fv3net_torch.fit import io
        from fv3net_torch.runtime.steppers.machine_learning import (
            MultiModelAdapter,
            PureMLStepper,
        )

        models = [io.load(path).to(device=device, dtype=dtype)
                  for path in config.scikit_learn.model]
        return PureMLStepper(
            MultiModelAdapter(models),
            timestep,
            hydrostatic=config.namelist.hydrostatic,
            mse_conserving_limiter=(
                config.scikit_learn.use_mse_conserving_humidity_limiter
            ),
            # diagnostic_ml (or online: false): record, don't apply
            diagnostic_only=(
                config.scikit_learn.diagnostic_ml
                or not config.scikit_learn.online
            ),
        )
    if config.nudging is not None and config.nudging.timescale_hours:
        raise not_ported("nudging (runtime/steppers/nudging.py)", 9)
    return None


def get_prephysics_steppers(config: UserConfig, timestep: float) -> List:
    """The prescriber chain of ``prephysics``."""
    steppers: List = []
    for entry in config.prephysics or []:
        kind = entry.get("kind", "prescriber")
        if kind == "prescriber":
            from fv3net_torch.loaders.batches import ZarrMapper
            from fv3net_torch.runtime.steppers.prescriber import Prescriber

            steppers.append(
                Prescriber(
                    _getter(ZarrMapper(entry["dataset"]), config, timestep),
                    entry["variables"],
                    rename=entry.get("rename"),
                )
            )
        elif kind == "tendency_prescriber":
            raise not_ported(
                "the tendency_prescriber prephysics kind "
                "(runtime/steppers/tendency_prescriber.py)", 9)
        else:
            raise ValueError(f"unknown prephysics stepper kind {kind!r}")
    return steppers


def get_radiation_stepper(config: UserConfig, timestep: float,
                          dtype=None, device="cuda", impl: str = None):
    """The Python radiation stepper of ``radiation_scheme`` (it runs
    beside the model's own radiation, its fluxes as diagnostics), or
    None.  Its RRTMG driver computes in ``dtype`` on ``device``, its
    k-table selections in ``impl``'s version (None: the kernels on a
    CUDA device)."""
    rs = config.radiation_scheme
    if rs is None:
        return None
    if rs.kind != "python":
        raise ValueError(f"unknown radiation stepper kind {rs.kind!r}")
    from fv3net_torch.physics.radiation import Radiation, RadiationConfig
    from fv3net_torch.runtime.steppers.radiation import RadiationStepper

    return RadiationStepper(
        Radiation(
            RadiationConfig(scheme=rs.scheme, lookup_dir=rs.lookup_dir),
            timestep, dtype=dtype, device=device, impl=impl,
        ),
        apply_heating=rs.apply_heating,
    )


def get_microphysics_emulator(config: UserConfig, dtype=None,
                              device="cuda"):
    """``(emulator, target, piggy_back)`` of ``online_emulator``: the
    saved model (moved to ``device`` in ``dtype``) applied inside the
    physics step through the emulation hook slot, or ``(None,
    "microphysics", False)``."""
    oe = config.online_emulator
    if oe is None or not oe.enabled or not oe.url:
        return None, "microphysics", False
    from fv3net_torch.emulation import MicrophysicsEmulator
    from fv3net_torch.fit import io

    model = io.load(oe.url).to(device=device, dtype=dtype)
    return MicrophysicsEmulator(model), oe.target, oe.piggy_back


def check_unported_steppers(config: UserConfig) -> None:
    """Raise for a config that enables a stepper the port does not run:
    the top-level tendency prescriber, bias correction and the reservoir
    corrector."""
    if config.tendency_prescriber is not None:
        raise not_ported(
            "tendency_prescriber (runtime/steppers/tendency_prescriber.py)",
            9)
    if config.bias_correction is not None:
        raise not_ported(
            "bias_correction (runtime/steppers/{tendency_prescriber,"
            "combine}.py)", 9)
    if config.reservoir_corrector is not None:
        raise not_ported(
            "reservoir_corrector (runtime/steppers/reservoir.py)", 9)
