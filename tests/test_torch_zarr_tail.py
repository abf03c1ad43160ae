"""The zarr tail of the port (``core/quantity.py::where``,
``core/zarrio.py::ZarrMapping`` and ``open_delayed``, the native chunk
I/O of ``fv3net_torch/native``) held against ``fv3net_tpu`` on seeded
numpy inputs: exact equality throughout (no arithmetic); stores written
by each package's native path read by the other's."""
import os

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (torch threads under xdist)

from fv3net_torch import native
from fv3net_torch.core import quantity, zarrio
from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity


def test_where_matches_reference():
    """Dim-aligned three-way ``where`` with tensors, numpy arrays and
    scalars, the output dims the union in order of appearance."""
    from fv3net_tpu.core import quantity as jquantity

    rng = np.random.RandomState(0)
    cond = rng.rand(3, 4) > 0.5
    x = rng.rand(4, 3, 2)
    y = rng.rand(2)
    cases = [
        ((cond, ("a", "b")), (x, ("b", "a", "c")), (y, ("c",))),
        ((cond, ("a", "b")), (x, ("b", "a", "c")), (-1.0, None)),
        ((cond.T, ("b", "a")), (2.5, None), (x, ("b", "a", "c"))),
    ]
    for case in cases:
        def args(make):
            return [make(v, d) if d is not None else v for v, d in case]

        want = jquantity.where(*args(jquantity.Quantity))
        got = quantity.where(*args(
            lambda v, d: Quantity(torch.tensor(v), d)))
        host = quantity.where(*args(Quantity))
        assert got.dims == host.dims == want.dims
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(host.data, np.asarray(want.data))
    with pytest.raises(TypeError):
        quantity.where(cond, x, y)


def _schema(rng):
    return Dataset({
        "a": Quantity(rng.rand(3, 4).astype(np.float32), ("y", "x"),
                      attrs={"units": "K"}),
        "b": Quantity(rng.rand(4), ("x",)),
    }, attrs={"source": "seeded"})


def test_zarr_mapping_matches_reference(tmp_path):
    """``ZarrMapping.from_schema`` prepends the managed dims with chunk 1
    and inserts datasets by key; the port's store and the reference's
    hold the same bytes, and each package reads the other's."""
    from fv3net_tpu.core import zarrio as jzarrio
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    rng = np.random.RandomState(1)
    schema = _schema(rng)
    jschema = JDataset({k: JQuantity(v.data, v.dims, attrs=dict(v.attrs))
                        for k, v in schema.items()}, attrs=dict(schema.attrs))
    times = ["20160801.000000", "20160801.003000"]
    m = zarrio.ZarrMapping.from_schema(str(tmp_path / "t"), schema,
                                       ["time"], {"time": times})
    jm = jzarrio.ZarrMapping.from_schema(str(tmp_path / "j"), jschema,
                                         ["time"], {"time": times})
    assert m.dims == jm.dims == ["time"]
    for i, t in enumerate(times):
        ds = Dataset({k: Quantity(v.data + i, v.dims)
                      for k, v in schema.items()})
        m[(t,)] = ds
        jm[(t,)] = JDataset({k: JQuantity(v.data + i, v.dims)
                             for k, v in schema.items()})
    assert zarrio.ZarrArray(str(tmp_path / "t" / "a")).chunks == (1, 3, 4)
    for k in ("a", "b"):
        got = zarrio.ZarrArray(str(tmp_path / "t" / k)).read()
        want = jzarrio.ZarrArray(str(tmp_path / "j" / k)).read()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[1], schema[k].data + 1)
    back = jzarrio.open_zarr(str(tmp_path / "t"))
    again = zarrio.open_zarr(str(tmp_path / "j"))
    for k in ("a", "b"):
        np.testing.assert_array_equal(np.asarray(back[k].data),
                                      np.asarray(again[k].data))
    assert m.coords["time"].tolist() == jm.coords["time"].tolist()


def test_open_delayed_matches_reference():
    """``open_delayed`` shares one thunk among the variables, keeps the
    schema's metadata and checks shapes against it, as the reference."""
    from fv3net_tpu.core import zarrio as jzarrio
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    rng = np.random.RandomState(2)
    schema = _schema(rng)
    loaded = Dataset({k: Quantity(v.data * 2, v.dims)
                      for k, v in schema.items()})
    calls = []

    def loader():
        calls.append(1)
        return loaded

    ds = zarrio.open_delayed(loader, schema)
    jds = jzarrio.open_delayed(lambda: JDataset(
        {k: JQuantity(v.data, v.dims) for k, v in loaded.items()}),
        JDataset({k: JQuantity(v.data, v.dims, attrs=dict(v.attrs))
                  for k, v in schema.items()}))
    assert not calls and sorted(ds) == sorted(jds)
    for k in ("a", "b"):
        assert ds[k].dims == jds[k].dims
        assert ds[k].attrs == jds[k].attrs
        np.testing.assert_array_equal(ds[k].data, np.asarray(jds[k].data))
    assert len(calls) == 1
    bad = zarrio.open_delayed(lambda: Dataset(
        {"a": Quantity(np.zeros((2, 2)), ("y", "x"))}), schema)
    with pytest.raises(ValueError, match="schema says"):
        bad["a"]


@pytest.mark.parametrize("compress", [False, True])
def test_native_stores_read_both_ways(tmp_path, compress):
    """Stores of several chunks written through each package's native
    writer are read by the other's native reader (the port counts its
    native calls); the bytes equal the Python path's; the port builds
    its library under ``fv3net_torch/_build``."""
    from fv3net_tpu.core import zarrio as jzarrio

    rng = np.random.RandomState(3)
    x = rng.rand(5, 6, 7).astype(np.float32)
    native.reset_counts()
    for pkg, root in ((zarrio, tmp_path / "t"), (jzarrio, tmp_path / "j")):
        arr = pkg.ZarrArray.create(str(root), shape=x.shape, dtype=x.dtype,
                                   chunks=(2, 6, 4), dims=("t", "y", "x"),
                                   compress=compress, fill_value=np.nan)
        arr[:] = x
    assert native.COUNTS["writes"] == 1
    assert native.COUNTS["written_chunks"] == 3 * 2
    got = zarrio.ZarrArray(str(tmp_path / "j")).read()
    want = jzarrio.ZarrArray(str(tmp_path / "t")).read()
    assert native.COUNTS["reads"] == 1
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(want, x)
    for name in sorted(os.listdir(tmp_path / "t")):
        if not name.startswith("."):
            a = (tmp_path / "t" / name).read_bytes()
            b = (tmp_path / "j" / name).read_bytes()
            assert a == b, name
    # the Python path (one chunk a write) gives the same bytes
    py = zarrio.ZarrArray(str(tmp_path / "t"))
    py._write_chunk((0, 0, 0), x[:2, :, :4])
    assert (tmp_path / "t" / "0.0.0").read_bytes() == \
        (tmp_path / "j" / "0.0.0").read_bytes()
    path = native.library_path()
    assert path.parent.name == "_build" and path.exists()
