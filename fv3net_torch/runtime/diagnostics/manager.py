"""Diagnostic files: snapshots and running time averages written to zarr
(port of ``fv3net_tpu/runtime/diagnostics/manager.py``; reference:
workflows/prognostic_c48_run/runtime/diagnostics/manager.py:98-178).

A :class:`DiagnosticFile` selects observation times with its time
container and writes one zarr row per selected observation, or, for an
``interval-average`` file, one row per window when the window ends (the
first observation of the next window, or ``close()``).  Rows are stored
as float32.

On the card, a snapshot's variables are cast to the file's
``pull_dtype`` (or float32) and copied to the host as one buffer; an
average is summed on the device in float64 and copied once per window
(cast to ``pull_dtype`` for the copy, as the reference casts the sums it
pulls).  The reference's scheduling of those copies (buffers of
observations held on the device and drained later, its writer thread),
shaped by its TPU link, is not reproduced: a row is written when its
observation (or its window) is complete, and holds what the reference's
row holds.  A config's ``pull_buffer`` (the size of that buffer) is
parsed and has no effect here.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from fv3net_torch.core import zarrio
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.runtime import timing
from fv3net_torch.runtime.config import pull_torch_dtype
from fv3net_torch.runtime.diagnostics.times import (
    IntervalAveragedTimes,
    time_container_from_config,
)


def pull(arrays: Sequence[torch.Tensor], dtype=None) -> List[np.ndarray]:
    """The tensors as host arrays through ONE device->host copy: each is
    cast on its device to ``dtype`` (default float32) and the raveled
    casts are concatenated before the copy.  Float64 stays float64 on
    the host; narrower dtypes come back as float32."""
    if not arrays:
        return []
    dtype = torch.float32 if dtype is None else dtype
    with timing.phases.clock("pull_transfer"):
        flat = torch.cat([a.to(dtype).reshape(-1) for a in arrays])
        host = flat.cpu()
        if host.dtype != torch.float64:
            host = host.float()
        host = host.numpy()
    timing.add_counter("pull_bytes",
                       float(flat.numel() * flat.element_size()))
    out, off = [], 0
    for a in arrays:
        out.append(host[off:off + a.numel()].reshape(tuple(a.shape)))
        off += a.numel()
    return out


def _tensor(q) -> torch.Tensor:
    return torch.as_tensor(q.data if isinstance(q, Quantity) else q)


class DiagnosticFile:
    """One output zarr with its own variable set and time selection."""

    def __init__(self, path: str, variables: Sequence[str], times,
                 renames: Optional[Mapping[str, str]] = None,
                 chunks: Optional[Mapping[str, int]] = None,
                 pull_dtype: Optional[str] = None):
        self._path = path
        self._variables = list(variables)
        self._renames = dict(renames or {})
        self._chunks = dict(chunks or {})
        self._times = times
        self._averaging = isinstance(times, IntervalAveragedTimes)
        self._pull_dtype = (None if pull_dtype is None
                            else pull_torch_dtype(pull_dtype))
        self._sums: Dict[str, torch.Tensor] = {}  # float64, on the device
        self._dims: Dict[str, tuple] = {}
        self._counts = 0
        self._current_label: Optional[datetime.datetime] = None
        self._stored_times: List[datetime.datetime] = []
        self._store: Optional[zarrio.ZarrGroup] = None

    def observe(self, time: datetime.datetime,
                diagnostics: Mapping[str, Quantity]) -> None:
        label = self._times.indicator(time)
        if label is None:
            return
        present = [n for n in self._variables if n in diagnostics]
        if not self._averaging:
            if present:
                rows = pull([_tensor(diagnostics[n]) for n in present],
                            self._pull_dtype)
                self._write_row(
                    label,
                    {self._renames.get(n, n): r
                     for n, r in zip(present, rows)},
                    {self._renames.get(n, n): diagnostics[n].dims
                     for n in present})
            return
        if self._current_label is not None and label != self._current_label:
            self._flush()
        self._current_label = label
        for name in present:
            out = self._renames.get(name, name)
            x = _tensor(diagnostics[name]).to(torch.float64)
            self._sums[out] = (self._sums[out] + x if out in self._sums
                               else x.clone())
            self._dims[out] = diagnostics[name].dims
        self._counts += 1

    def _flush(self) -> None:
        """Write the current window's mean (averaging files)."""
        if self._counts and self._sums:
            names = list(self._sums)
            sums = pull([self._sums[n] for n in names],
                        self._pull_dtype or torch.float64)
            self._write_row(
                self._current_label,
                {n: s.astype(np.float64) / self._counts
                 for n, s in zip(names, sums)},
                self._dims)
        self._sums = {}
        self._counts = 0

    def _write_row(self, label, rows: Dict[str, np.ndarray],
                   dims: Mapping[str, tuple]) -> None:
        """Append one time row.  Under a sharded layout each rank holds its
        block of every field [..., my, mx]: rank 0 creates the store (one
        chunk per block along y and x) and grows the time axis, then each
        rank writes its region (``core.sharded_io.write_block``)."""
        import torch.distributed as dist

        from fv3net_torch.core.sharded_io import global_shape, write_block
        from fv3net_torch.parallel import sharded

        mesh = sharded.active()
        lead = mesh is None or mesh.rank == 0
        t_index = len(self._stored_times)
        if lead:
            if self._store is None:
                self._store = zarrio.ZarrGroup.create(self._path)
                for name, arr in rows.items():
                    full = ("time",) + tuple(dims[name])
                    if mesh is None:
                        shape, chunks = arr.shape, tuple(
                            min(self._chunks.get(d, s), s)
                            for d, s in zip(full[1:], arr.shape))
                    else:
                        shape, chunks = global_shape(arr.shape, mesh), \
                            arr.shape
                    self._store.create_array(
                        name,
                        shape=(0,) + shape,
                        chunks=(self._chunks.get("time", 1),) + chunks,
                        dtype="float32",
                        dims=full,
                        fill_value="NaN",
                    )
            for name in rows:
                self._store[name].resize_time(t_index + 1)
        if mesh is not None:
            dist.barrier(group=mesh.group)
            if self._store is None:
                self._store = zarrio.ZarrGroup(self._path)
        with timing.phases.clock("zarr_write"):
            for name, arr in rows.items():
                arr = arr.astype(np.float32, copy=False)
                if mesh is None:
                    self._store[name][(t_index,)] = arr
                else:
                    write_block(self._store[name], arr, mesh,
                                index=(t_index,))
        self._stored_times.append(label)
        if mesh is not None:
            dist.barrier(group=mesh.group)
        if lead:
            self._write_times()

    def _write_times(self) -> None:
        # time coordinate in hours since the first stored time
        t0 = self._stored_times[0]
        hours = np.array(
            [(t - t0).total_seconds() / 3600.0 for t in self._stored_times]
        )
        if "time" not in self._store.array_names():
            self._store.create_array(
                "time",
                shape=(0,),
                chunks=(1024,),
                dtype="float64",
                dims=("time",),
                attrs={"units": f"hours since {t0.isoformat()}"},
            )
        za = self._store["time"]
        za.resize_time(len(hours))
        za[:] = hours

    def close(self) -> None:
        if self._averaging:
            self._flush()


class DiagnosticsManager:
    """All configured diagnostic files (reference manager.py:181-200
    get_diagnostic_files).  Fortran diagnostic configs lower to ordinary
    files (``FortranFileConfig.to_diagnostic_config``); a ``tensorboard:
    true`` file is a TensorBoard event log instead of a zarr."""

    def __init__(self, configs, initial_time: datetime.datetime,
                 output_dir: str):
        self.files = []
        for cfg in configs:
            if hasattr(cfg, "to_diagnostic_config"):
                cfg = cfg.to_diagnostic_config()
            if getattr(cfg, "tensorboard", False):
                # tensorboard: true swaps the zarr file for a TensorBoard
                # event log under <output_dir>/tensorboard
                from fv3net_torch.runtime.diagnostics.tensorboard import (
                    TensorBoardSink,
                )

                self.files.append(TensorBoardSink(
                    os.path.join(output_dir, "tensorboard"), cfg.variables,
                    time_container_from_config(cfg.times, initial_time)))
                continue
            self.files.append(
                DiagnosticFile(
                    os.path.join(output_dir, cfg.name),
                    cfg.variables,
                    time_container_from_config(cfg.times, initial_time),
                    renames=getattr(cfg, "renames", None),
                    chunks=getattr(cfg, "chunks", None),
                    pull_dtype=getattr(cfg, "pull_dtype", None),
                )
            )

    def observe(self, time, diagnostics) -> None:
        for f in self.files:
            f.observe(time, diagnostics)

    def close(self) -> None:
        for f in self.files:
            f.close()
