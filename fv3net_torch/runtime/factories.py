"""Stepper factories: build the steppers a :class:`UserConfig` names
(port of ``fv3net_tpu/runtime/factories.py``; reference:
workflows/prognostic_c48_run/runtime/factories.py:60-150).

Every stepper of the reference's time loop: the ML corrector
(``scikit_learn``: dense models in the reference's artifact format) or
the nudger (``nudging``), the "prescriber" and "tendency_prescriber"
prephysics kinds, the Python radiation stepper (``radiation_scheme``),
the top-level ``tendency_prescriber``, ``bias_correction``, the
reservoir corrector (``reservoir_corrector``: pure, hybrid and subdomain
reservoir models) and the online microphysics emulator
(``online_emulator``).  Configs that merely carry a key without enabling
it build nothing, as in the reference.
"""
from __future__ import annotations

import datetime
from typing import List

from fv3net_torch.runtime.config import UserConfig


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
    """The ML corrector from ``scikit_learn`` (its models loaded from
    their artifact directories and moved to ``device`` in ``dtype``), or
    else the nudger from ``nudging`` (its reference states read from the
    zarr store at ``restarts_path``, moved to the state's device each
    step), or None."""
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
        from fv3net_torch.loaders.batches import ZarrMapper
        from fv3net_torch.runtime.steppers.nudging import PureNudger

        mapper = ZarrMapper(config.nudging.restarts_path)
        timescales = {
            var: hours * 3600.0
            for var, hours in config.nudging.timescale_hours.items()
        }
        return PureNudger(_getter(mapper, config, timestep), timescales)
    return None


def get_prephysics_steppers(config: UserConfig, timestep: float,
                            device="cuda") -> List:
    """The prescriber chain of ``prephysics``: "prescriber" entries set
    state variables from their store, "tendency_prescriber" entries add
    its tendencies (clipped on ``device``, in the store's dtype)."""
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
            from fv3net_torch.loaders.batches import ZarrMapper
            from fv3net_torch.runtime.steppers.tendency_prescriber import (
                TendencyPrescriber,
            )

            steppers.append(
                TendencyPrescriber(
                    _getter(ZarrMapper(entry["dataset"]), config, timestep),
                    entry["variables"],
                    limit_quantiles=entry.get("limit_quantiles"),
                    device=device,
                )
            )
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


def get_tendency_prescriber(config: UserConfig, timestep: float,
                            device="cuda"):
    """The top-level ``tendency_prescriber``: a TendencyPrescriber after
    the physics, its tendencies clipped on ``device`` in the store's
    dtype, or None."""
    tp = config.tendency_prescriber
    if tp is None:
        return None
    from fv3net_torch.loaders.batches import ZarrMapper
    from fv3net_torch.runtime.steppers.tendency_prescriber import (
        TendencyPrescriber,
    )

    return TendencyPrescriber(
        _getter(ZarrMapper(tp.dataset), config, timestep),
        tp.variables,
        limit_quantiles=tp.limit_quantiles,
        device=device,
    )


def get_bias_correction(config: UserConfig, timestep: float,
                        device="cuda"):
    """``bias_correction``: a TendencyPrescriber of correction tendencies
    labelled "bias_correction", inside an IntervalStepper when
    ``apply_interval_seconds`` is set, or None."""
    bc = config.bias_correction
    if bc is None:
        return None
    from fv3net_torch.loaders.batches import ZarrMapper
    from fv3net_torch.runtime.steppers.combine import IntervalStepper
    from fv3net_torch.runtime.steppers.tendency_prescriber import (
        TendencyPrescriber,
    )

    stepper = TendencyPrescriber(
        _getter(ZarrMapper(bc.dataset), config, timestep),
        bc.variables,
        limit_quantiles=bc.limit_quantiles,
        device=device,
    )
    stepper.label = "bias_correction"
    if bc.apply_interval_seconds:
        stepper = IntervalStepper(bc.apply_interval_seconds, stepper)
    return stepper


def get_reservoir_steppers(config: UserConfig, timestep: float,
                           device="cuda"):
    """``reservoir_corrector`` -> the (incrementer, predictor) pair over
    one model loaded from ``model_path`` onto ``device`` (its arrays in
    the reference's float32), or (None, None)."""
    rc = config.reservoir_corrector
    if rc is None:
        return None, None
    from fv3net_torch.fit import io
    from fv3net_torch.runtime.steppers.reservoir import (
        ReservoirConfig,
        ReservoirIncrementOnlyStepper,
        ReservoirPredictStepper,
    )

    model = io.load(rc.model_path).to(device=device)
    cfg = ReservoirConfig(
        model_path=rc.model_path,
        synchronize_steps=rc.synchronize_steps,
        reservoir_timestep_seconds=rc.reservoir_timestep_seconds,
        rename_mapping=dict(rc.rename_mapping),
        diagnostic_only=rc.diagnostic_only,
        warm_start=rc.warm_start,
    )
    return (
        ReservoirIncrementOnlyStepper(model, cfg),
        ReservoirPredictStepper(model, cfg),
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
