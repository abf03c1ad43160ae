"""Reservoir runtime steppers (port of
``fv3net_tpu/runtime/steppers/reservoir.py``; reference:
workflows/prognostic_c48_run/runtime/steppers/reservoir.py:
ReservoirConfig, _FiniteStateMachine:84 enforcing increment-before-
predict, TimeAverageInputs:123 (folded into the incrementer's
reservoir-timestep accumulation), ReservoirIncrementOnlyStepper:238 and
ReservoirPredictStepper:317).

One model covers all columns (the reference keeps one per rank).  Under
a sharded layout the column models run on the rank's block of columns;
the subdomain model gathers its input fields from every rank
(``parallel.sharded.gather``) and runs on the whole cube on every rank,
and the TimeLoop cuts its updates back to the block.  The saved
reservoir state is the whole cube's under any layout: a column model's
blocks are gathered to save and cut back to the block on a warm start.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit.packer import stack_columns, unstack_columns
from fv3net_torch.parallel import sharded
from fv3net_torch.runtime import names
from fv3net_torch.runtime.derived_state import DIMS_3D, DerivedState


@dataclasses.dataclass
class ReservoirConfig:
    """``rename_mapping`` maps model-side variable names to run-side state
    names; ``diagnostic_only`` emits predictions as diagnostics
    (``{name}_reservoir_prediction``) without touching the state;
    ``warm_start`` restores a pre-synchronized reservoir state saved
    next to the model (``reservoir_state.npz``) and skips the
    synchronization gate."""

    model_path: str = ""
    synchronize_steps: int = 1
    reservoir_timestep_seconds: float = 900.0
    rename_mapping: dict = dataclasses.field(default_factory=dict)
    diagnostic_only: bool = False
    warm_start: bool = False


class _FiniteStateMachine:
    """Tracks increment/predict call ordering, and the reservoir-timestep
    bookkeeping the incrementer and predictor share through the model."""

    INCREMENT = "increment"
    PREDICT = "predict"

    def __init__(self):
        self._last_called: Optional[str] = None
        self.completed_increments = 0
        self.accum = None
        self.accum_n = 0
        self.last_fire = None
        self.pending_predict = False

    def __call__(self, state: str) -> None:
        if state == self.INCREMENT:
            self._last_called = self.INCREMENT
            self.completed_increments += 1
        elif state == self.PREDICT:
            if self._last_called != self.INCREMENT:
                raise ValueError(
                    "reservoir must be incremented before every predict"
                )
            self._last_called = self.PREDICT
        else:
            raise ValueError(state)


class _ReservoirStepper:
    def __init__(self, model, config: ReservoirConfig,
                 input_variables: Optional[Sequence[str]] = None):
        self.model = model
        self.config = config
        rename = dict(config.rename_mapping)
        self.input_variables = [
            rename.get(v, v)
            for v in (input_variables or model.input_variables)
        ]
        self.output_renames = rename
        self._fsm = getattr(model, "_fsm", None) or _FiniteStateMachine()
        model._fsm = self._fsm
        if config.warm_start and not getattr(self._fsm, "warm_started", False):
            self._fsm.warm_started = True
            self._load_warm_state()

    def _load_warm_state(self) -> None:
        """Restore a saved reservoir state: skip synchronization."""
        path = os.path.join(self.config.model_path, "reservoir_state.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"warm_start=true but {path} does not exist; run "
                "save_reservoir_state after synchronizing, or disable "
                "warm_start"
            )
        device = getattr(getattr(self.model, "state", None), "device", None)
        with np.load(path) as z:
            state = torch.tensor(z["state"], device=device)
        mesh = sharded.active()
        if mesh is not None and not self._spatial and state.ndim == 2:
            state = _block_columns(state, mesh)
        self.model.state = state
        # mark synchronization as already complete
        self._fsm.completed_increments = max(
            self._fsm.completed_increments, self.config.synchronize_steps + 1
        )

    @property
    def _spatial(self) -> bool:
        """Subdomain models consume cube-shaped fields with the halo
        overlap (``CubeXYDivider``)."""
        return hasattr(self.model, "divider")

    def _pull_inputs(self, state: DerivedState) -> torch.Tensor:
        if self._spatial:
            mesh = sharded.active()
            fields = []
            for v in self.input_variables:
                arr = state[v].data  # [6(,z),y,x]
                if mesh is not None:
                    arr = sharded.gather(arr, mesh)
                if arr.ndim == 3:
                    arr = arr[:, None]
                fields.append(arr.movedim(1, -1))  # z last as features
            return torch.cat(fields, dim=-1)  # [6, y, x, nf]
        cols = []
        for v in self.input_variables:
            stacked = stack_columns(state[v].data)
            if stacked.ndim == 1:
                stacked = stacked[:, None]
            cols.append(stacked)
        return torch.cat(cols, dim=-1)

    @property
    def completed_sync_steps(self) -> int:
        return self._fsm.completed_increments


class ReservoirIncrementOnlyStepper(_ReservoirStepper):
    """Drive the reservoir with the model state averaged over the
    reservoir's own step, ``reservoir_timestep_seconds`` (a multiple of
    the model step): the inputs accumulate each call, and the first call
    and every call a reservoir step after the last firing increment with
    their mean."""

    label = "reservoir_incrementer"

    @torch.no_grad()
    def __call__(self, time, state: DerivedState):
        u = self._pull_inputs(state)
        f = self._fsm
        f.accum = u if f.accum is None else f.accum + u
        f.accum_n += 1
        rts = self.config.reservoir_timestep_seconds
        due = (
            f.last_fire is None
            or (time - f.last_fire).total_seconds() + 1e-6 >= rts
        )
        if due:
            u_avg = f.accum / f.accum_n
            if not self._spatial and (
                self.model.state.ndim < 2
                or self.model.state.shape[0] != u_avg.shape[0]
            ):
                self.model.reset_state(batch_shape=(u_avg.shape[0],))
            self.model.increment(u_avg)
            f(f.INCREMENT)
            f.accum = None
            f.accum_n = 0
            f.last_fire = time
            f.pending_predict = True
        return {}, {}, {}


class ReservoirPredictStepper(_ReservoirStepper):
    """Predict updated fields from the reservoir state after each
    increment, once the synchronization steps are done."""

    label = "reservoir_predictor"

    @torch.no_grad()
    def __call__(self, time, state: DerivedState):
        if not self._fsm.pending_predict:
            return {}, {}, {}  # between reservoir timesteps: no-op
        self._fsm.pending_predict = False
        self._fsm(self._fsm.PREDICT)
        if self._fsm.completed_increments <= self.config.synchronize_steps:
            return {}, {}, {}
        u = self._pull_inputs(state)
        pred = self.model.predict_from_state(u)
        state_updates = {}
        if self._spatial:
            nz = state[names.DELP].shape[1]
            n_out = len(self.model.output_variables)
            if pred.shape[-1] != n_out * nz:
                raise ValueError(
                    f"spatial reservoir prediction has {pred.shape[-1]} "
                    f"features but the run expects {n_out} x nz={nz} "
                    "(model trained on a different vertical grid?)"
                )
            start = 0
            for v in self.model.output_variables:
                chunk = pred[..., start: start + nz]  # [6, y, x, z]
                start += nz
                name = self.output_renames.get(v, v)
                state_updates[name] = Quantity(chunk.movedim(-1, 1),
                                               DIMS_3D)
            return self._route(state_updates)
        grid_shape = tuple(
            state[names.DELP].shape[i] for i in (0, 2, 3)
        )
        feats = getattr(self.model, "output_features", None)
        if not feats:
            if len(self.model.output_variables) == 1:
                feats = [pred.shape[-1]]  # one variable owns the vector
            else:
                raise ValueError(
                    "reservoir model lacks output_features metadata and "
                    "has multiple output variables; cannot split the "
                    "prediction unambiguously"
                )
        start = 0
        for v, nf in zip(self.model.output_variables, feats):
            chunk = pred[:, start: start + nf]
            start += nf
            name = self.output_renames.get(v, v)
            state_updates[name] = Quantity(
                unstack_columns(chunk, grid_shape), DIMS_3D
            )
        return self._route(state_updates)

    def _route(self, state_updates):
        """diagnostic_only stores the predictions as diagnostics instead
        of overwriting the model state."""
        if self.config.diagnostic_only:
            diags = {
                f"{name}_reservoir_prediction": q
                for name, q in state_updates.items()
            }
            return {}, diags, {}
        return {}, {}, state_updates


def _cube_side(n_columns: int, blocks: int) -> int:
    """C``n`` of a column state of ``n_columns`` columns that is one of
    ``blocks`` equal blocks of the 6 tiles."""
    n = math.isqrt(n_columns * blocks // 6)
    if 6 * n * n != n_columns * blocks:
        raise ValueError(f"{n_columns} columns are not 1/{blocks} of a cube")
    return n


def _global_columns(state: torch.Tensor, mesh) -> torch.Tensor:
    """A column model's state [6 my mx, S] of this rank's block -> the
    whole cube's [6 n n, S] in ``stack_columns``' order (on every
    rank)."""
    n = _cube_side(state.shape[0], mesh.size)
    ys, xs = mesh.block(n)
    block = unstack_columns(state, (6, ys.stop - ys.start,
                                    xs.stop - xs.start))  # [6, S, my, mx]
    return stack_columns(sharded.gather(block, mesh))


def _block_columns(state: torch.Tensor, mesh) -> torch.Tensor:
    """The whole cube's column state [6 n n, S] -> this rank's block."""
    n = _cube_side(state.shape[0], 1)
    ys, xs = mesh.block(n)
    return stack_columns(unstack_columns(state, (6, n, n))[..., ys, xs])


def save_reservoir_state(model, model_path: str) -> str:
    """Persist the reservoir's current state next to the model so later
    runs can ``warm_start``; returns the file's path.  The file holds the
    whole cube's state, as the reference's does: under a sharded layout
    every rank calls this, a column model's blocks are gathered in the
    global column order, rank 0 writes (a subdomain model's state is
    whole on every rank), and each rank returns once the file exists."""
    path = os.path.join(model_path, "reservoir_state.npz")
    mesh = sharded.active()
    state = model.state.detach()
    if mesh is not None and not hasattr(model, "divider") and state.ndim == 2:
        state = _global_columns(state, mesh)
    if mesh is None or mesh.rank == 0:
        np.savez(path, state=state.cpu().numpy())
    if mesh is not None:
        sharded.all_reduce(torch.zeros((), device=state.device))
    return path
