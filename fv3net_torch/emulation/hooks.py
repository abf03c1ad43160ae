"""Emulation hooks: an emulator applied under masks, and state capture
(port of ``fv3net_tpu/emulation/hooks.py``; reference:
external/emulation/emulation/_emulate/microphysics.py:19-81,
emulation/masks.py:9-66, emulation/_monitor/monitor.py:26-154).

State here is a flat Dict[str, Tensor] of (..., nz) column fields, the
analog of the Fortran state dict the reference's hooks receive.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from fv3net_torch.core import zarrio

State = Dict[str, torch.Tensor]
Mask = Callable[[State, State], State]


def always_emulator(state: State, emulator: State) -> State:
    return emulator


def compose_masks(funcs: Iterable[Mask]) -> Mask:
    """Apply masks in order; each sees the original state and the
    (partly masked) emulator output."""
    funcs = list(funcs)

    def composed(state: State, emulator: State) -> State:
        out = emulator
        for f in funcs:
            out = f(state, out)
        return out

    return composed


class RangeMask:
    """Clip an emulated field to [min, max]."""

    def __init__(self, key: str, min: Optional[float] = None,
                 max: Optional[float] = None):
        self.key = key
        self.min = min
        self.max = max

    def __call__(self, state: State, emulator: State) -> State:
        out = dict(emulator)
        if self.key in out:
            out[self.key] = torch.clamp(out[self.key], self.min, self.max)
        return out


class LevelMask:
    """Keep the original (non-emulated) values outside levels
    [start, stop) of the last axis (level 0 = top); ``fill_value``
    replaces them instead when given."""

    def __init__(self, key: str, start: Optional[int] = None,
                 stop: Optional[int] = None,
                 fill_value: Optional[float] = None):
        self.key = key
        self.start = start
        self.stop = stop
        self.fill_value = fill_value

    def __call__(self, state: State, emulator: State) -> State:
        out = dict(emulator)
        if self.key not in out:
            return out
        emu = out[self.key]
        k = torch.arange(emu.shape[-1], device=emu.device)
        sel = torch.ones_like(k, dtype=torch.bool)
        if self.start is not None:
            sel = sel & (k >= self.start)
        if self.stop is not None:
            sel = sel & (k < self.stop)
        base = (torch.full_like(emu, self.fill_value)
                if self.fill_value is not None else state[self.key])
        out[self.key] = torch.where(sel, emu, base)
        return out


@dataclasses.dataclass
class IntervalSchedule:
    """1.0 within the first half of each ``period`` from
    ``initial_time``, else 0: alternates between the emulator and the
    scheme in time."""

    period: datetime.timedelta
    initial_time: datetime.datetime

    def __call__(self, time: datetime.datetime) -> float:
        elapsed = (time - self.initial_time).total_seconds()
        half = self.period.total_seconds() / 2
        return 1.0 if (elapsed % self.period.total_seconds()) < half else 0.0


@dataclasses.dataclass
class TimeMask:
    """Blend emulator and state by the schedule's alpha at ``time``."""

    schedule: IntervalSchedule
    time: Optional[datetime.datetime] = None

    def set_time(self, time: datetime.datetime) -> None:
        self.time = time

    def __call__(self, state: State, emulator: State) -> State:
        if self.time is None:
            return emulator
        alpha = self.schedule(self.time)
        return {key: (alpha * emu + (1.0 - alpha) * state[key]
                      if key in state else emu)
                for key, emu in emulator.items()}


class MicrophysicsEmulator:
    """A trained model applied to the physics state dict, gated by a
    mask.  The model maps Dict[str, [sample, nz]] inputs to outputs named
    by the state keys it overrides (``predict_arrays``, as
    :class:`~fv3net_torch.fit.dense.DenseModel`); the lead dims are
    flattened to samples and restored after."""

    def __init__(self, model, mask: Mask = always_emulator):
        self.model = model
        self.mask = mask

    def __call__(self, state: State) -> State:
        inputs = {k: state[k] for k in self.model.input_variables}
        lead_shape = tuple(next(iter(inputs.values())).shape[:-1])
        n = int(np.prod(lead_shape))
        flat = {k: v.reshape(n, v.shape[-1]) for k, v in inputs.items()}
        pred = self.model.predict_arrays(flat)
        emulator = {k: v.reshape(lead_shape + (v.shape[-1],))
                    for k, v in pred.items()}
        new_state = dict(state)
        new_state.update(self.mask(state, emulator))
        return new_state


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class StorageHook:
    """Physics-state snapshots for training data: every
    ``output_freq_sec`` from the first call (or ``initial_time``), the
    selected variables are appended to a zarr store with a leading time
    dimension, in float32.  A store that exists already (a resumed
    segment) is appended to."""

    def __init__(
        self,
        output_path: str,
        output_freq_sec: float,
        variables: Optional[List[str]] = None,
        initial_time: Optional[datetime.datetime] = None,
    ):
        self.output_path = output_path
        self.output_freq_sec = output_freq_sec
        self.variables = variables
        self._store: Optional[zarrio.ZarrGroup] = None
        self._n = 0
        self._initial_time = initial_time

    def _should_store(self, time: datetime.datetime) -> bool:
        if self._initial_time is None:
            self._initial_time = time
        elapsed = (time - self._initial_time).total_seconds()
        return abs(elapsed % self.output_freq_sec) < 1e-6

    def __call__(self, state: State, time: datetime.datetime) -> None:
        if not self._should_store(time):
            return
        names = self.variables or sorted(state)
        if self._store is None:
            existing = os.path.exists(
                os.path.join(self.output_path, ".zgroup"))
            if existing:
                self._store = zarrio.ZarrGroup(self.output_path)
                have = self._store.array_names()
                if have:
                    self._n = self._store[have[0]].shape[0]
            else:
                self._store = zarrio.ZarrGroup.create(self.output_path)
            for name in names:
                if existing and name in self._store.array_names():
                    continue
                arr = _host(state[name])
                self._store.create_array(
                    name,
                    shape=(self._n,) + arr.shape,
                    chunks=(1,) + arr.shape,
                    dtype="<f4",
                    dims=("time",) + tuple(f"dim_{i}"
                                           for i in range(arr.ndim)),
                )
        for name in names:
            za = self._store[name]
            za.resize_time(self._n + 1)
            za[(self._n,)] = _host(state[name]).astype(np.float32)
        self._n += 1


def get_hooks(config=None, config_path: str = "fv3config.yml",
              device="cuda", dtype=None):
    """The (gscond, microphysics, store) hook triple: the
    ``zhao_carr_emulation`` key of ``config_path`` (or ``config``, that
    key's dict) names the gscond and model artifacts (``path`` or
    ``url``) and the storage (``path``, ``output_freq_sec``).  Models
    load through :func:`fv3net_torch.fit.io.load` and move to ``device``
    (the card unless the caller asks for the CPU) and to ``dtype`` when
    given.  Each hook maps a state dict to a state
    dict (the identity when not configured); ``store(state, time)``
    captures snapshots (a no-op when not configured)."""
    if config is None:
        config = {}
        if os.path.exists(config_path):
            import yaml

            with open(config_path) as f:
                loaded = yaml.safe_load(f) or {}
            config = loaded.get("zhao_carr_emulation", {}) or {}

    def _identity(state: State) -> State:
        return state

    def _build(key):
        sub = config.get(key) or {}
        path = sub.get("path") or sub.get("url")
        if not path:
            return _identity
        from fv3net_torch.fit import io

        return MicrophysicsEmulator(io.load(path).to(device=device,
                                                     dtype=dtype))

    gscond_hook = _build("gscond")
    model_hook = _build("model")

    storage = config.get("storage") or {}
    if storage.get("output_freq_sec") or storage.get("path"):
        store = StorageHook(
            storage.get("path", "state_output.zarr"),
            output_freq_sec=float(storage.get("output_freq_sec", 900.0)),
        )
    else:
        def store(state, time):  # noqa: ANN001
            return None

    return gscond_hook, model_hook, store
