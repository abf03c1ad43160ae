"""Stepper factories: build the steppers a :class:`UserConfig` names
(port of ``fv3net_tpu/runtime/factories.py``; reference:
workflows/prognostic_c48_run/runtime/factories.py:60-150).

Ported: the ML corrector (``scikit_learn``: dense models in the
reference's artifact format) and the "prescriber" prephysics kind.  The
other steppers raise ``NotImplementedError`` naming their ROADMAP.md
item; configs that merely carry their keys without enabling them build
nothing, as in the reference.
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
                            dtype=None, device=None):
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


def check_unported_steppers(config: UserConfig) -> None:
    """Raise for a config that enables a stepper the port does not run:
    the Python radiation stepper, the top-level tendency prescriber, bias
    correction, the reservoir corrector and the online emulator."""
    rs = config.radiation_scheme
    if rs is not None:
        if rs.kind != "python":
            raise ValueError(f"unknown radiation stepper kind {rs.kind!r}")
        raise not_ported(
            "the radiation stepper (runtime/steppers/radiation.py)", 6)
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
    oe = config.online_emulator
    if oe is not None and oe.enabled and oe.url:
        raise not_ported("online_emulator (emulation/, the microphysics "
                          "emulator hooks)", 6)
