"""Training dataset loaders, the fv3fit.data layer (port of
``fv3net_tpu/fit/data.py``; reference: external/fv3fit/fv3fit/data/
{base.py,batches.py,tfdataset.py,synthetic.py}): a ``TFDatasetLoader``
registry dispatched by ``from_dict``, ``FromBatches`` over the loaders'
configs, ``WindowedZarrLoader`` for time windows and ``SyntheticNoise``.
A "dataset" is a sequence of the port's Dataset batches; the reference's
names stay so configs carry over, and the windows and noise come from
``np.random.RandomState(seed)`` as the reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Type

import numpy as np

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity

__all__ = [
    "TFDatasetLoader",
    "register_tfdataset_loader",
    "tfdataset_loader_from_dict",
    "FromBatches",
    "WindowedZarrLoader",
    "SyntheticNoise",
]

_TFDATASET_LOADERS: List[Type["TFDatasetLoader"]] = []


class TFDatasetLoader:
    """ABC: ``open_tfdataset(local_download_path, variable_names)``
    returns a sequence of Dataset batches (reference data/base.py:9-27)."""

    def open_tfdataset(
        self, local_download_path: Optional[str], variable_names: Sequence[str]
    ):
        raise NotImplementedError

    @classmethod
    def from_dict(cls, d: dict) -> "TFDatasetLoader":
        raise NotImplementedError


def register_tfdataset_loader(loader_class: Type[TFDatasetLoader]):
    """Register a loader subclass for ``tfdataset_loader_from_dict``
    (reference data/base.py:30-38)."""
    _TFDATASET_LOADERS.append(loader_class)
    return loader_class


def tfdataset_loader_from_dict(d: dict) -> TFDatasetLoader:
    """Dispatch a config dict to the first registered loader that
    accepts it (reference data/base.py:41-60)."""
    for cls in _TFDATASET_LOADERS:
        try:
            return cls.from_dict(dict(d))
        except (TypeError, ValueError, AttributeError, KeyError):
            pass
    raise ValueError(f"invalid TFDatasetLoader dictionary: {d}")


@register_tfdataset_loader
@dataclasses.dataclass
class FromBatches(TFDatasetLoader):
    """Bridge from the loaders-package BatchesLoader configs
    (reference data/batches.py:17-41)."""

    batches_loader: "object"

    @classmethod
    def from_dict(cls, d: dict) -> "FromBatches":
        from fv3net_torch.loaders import BatchesLoader

        return cls(BatchesLoader.from_dict(d))

    def open_tfdataset(
        self,
        local_download_path: Optional[str],
        variable_names: Sequence[str],
    ):
        from fv3net_torch.loaders import sequences

        batches = self.batches_loader.load_batches(variables=variable_names)
        if local_download_path is not None:
            batches = sequences.to_local(batches, local_download_path)
        return batches


@register_tfdataset_loader
@dataclasses.dataclass
class WindowedZarrLoader(TFDatasetLoader):
    """Random time windows straight from zarr (reference
    data/tfdataset.py:105-175): each record has dims
    [sample=batch_size, window, *unstacked_dims]; window starts are
    sampled with replacement, and samples are drawn independently over
    the dims NOT listed in ``unstacked_dims`` (stacked into 'sample').
    Used by recurrent/reservoir training."""

    data_path: str
    unstacked_dims: Sequence[str]
    window_size: int
    batch_size: int = 1
    time_stride: int = 1
    n_windows: Optional[int] = None
    time_start_index: int = 0
    time_end_index: Optional[int] = None
    seed: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "WindowedZarrLoader":
        return cls(**d)

    def open_tfdataset(
        self,
        local_download_path: Optional[str],
        variable_names: Sequence[str],
    ):
        from fv3net_torch.core.zarrio import open_zarr
        from fv3net_torch.loaders.sequences import Map

        ds = open_zarr(self.data_path)
        ds = ds.isel(
            time=slice(self.time_start_index, self.time_end_index)
        )
        n_times = ds.dims["time"]
        span = (self.window_size - 1) * self.time_stride + 1
        if span > n_times:
            raise ValueError(
                f"window span {span} exceeds {n_times} available times"
            )
        n_windows = (
            self.n_windows
            if self.n_windows is not None
            else int(np.ceil(n_times / max(self.window_size - 1, 1)))
        )
        rng = np.random.RandomState(self.seed)
        starts = rng.randint(0, n_times - span + 1, size=n_windows)

        def make_record(start: int) -> Dataset:
            t_idx = start + np.arange(self.window_size) * self.time_stride
            out = {}
            sample_idx = None
            for name in variable_names:
                q = ds[name]
                if "time" not in q.dims:
                    raise ValueError(f"{name} has no time dimension")
                arr = np.asarray(q.data)
                t_ax = q.dims.index("time")
                win = np.take(arr, t_idx, axis=t_ax)
                win = np.moveaxis(win, t_ax, 0)  # [window, ...]
                rest = [d for d in q.dims if d != "time"]
                stacked_dims = [d for d in rest if d not in self.unstacked_dims]
                kept = [d for d in rest if d in self.unstacked_dims]
                perm = (
                    [0]
                    + [1 + rest.index(d) for d in stacked_dims]
                    + [1 + rest.index(d) for d in kept]
                )
                win = np.transpose(win, perm)
                n_stack = int(
                    np.prod([q.sizes[d] for d in stacked_dims], dtype=int)
                )
                win = win.reshape(
                    (self.window_size, n_stack)
                    + tuple(q.sizes[d] for d in kept)
                )
                if sample_idx is None:
                    sample_idx = rng.randint(
                        0, n_stack, size=self.batch_size
                    )
                win = win[:, sample_idx]  # [window, sample, *kept]
                win = np.swapaxes(win, 0, 1)  # [sample, window, *kept]
                out[name] = Quantity(
                    win, ("sample", "window") + tuple(kept), q.units
                )
            return Dataset(out)

        seq = Map(make_record, [int(s) for s in starts])
        if local_download_path is not None:
            from fv3net_torch.loaders.sequences import to_local

            return to_local(seq, local_download_path)
        return seq


@register_tfdataset_loader
@dataclasses.dataclass
class SyntheticNoise(TFDatasetLoader):
    """Random-noise records for trainer tests (reference
    data/synthetic.py:12-55)."""

    nsamples: int
    nbatch: int
    ntime: int
    nx: int
    nz: int
    noise_amplitude: float = 1.0
    seed: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "SyntheticNoise":
        return cls(**d)

    def open_tfdataset(
        self,
        local_download_path: Optional[str],
        variable_names: Sequence[str],
    ):
        from fv3net_torch.loaders.sequences import Map

        rng = np.random.RandomState(self.seed)
        records = []
        for _ in range(self.nsamples):
            out = {}
            for name in variable_names:
                arr = self.noise_amplitude * rng.randn(
                    self.nbatch, self.ntime, self.nx, self.nz
                ).astype(np.float32)
                out[name] = Quantity(arr, ("sample", "window", "x", "z"))
            records.append(Dataset(out))
        return Map(lambda i: records[i], list(range(self.nsamples)))
