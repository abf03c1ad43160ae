"""The sharded layout on torch.distributed, on 4 gloo CPU ranks spawned
once for the module (``parallel.sharded.launch`` running
``torch_port_util.sharded_worker``): the block halo exchange against the
reference's ``block_slice`` of its single-device halo append, exactly, at
layouts (2, 2), (4, 1) and (1, 4) and h = 1, 2, 3; the dry run
(``entry.dryrun_multigpu``) at the reference's bounds in float32 and
within 1e-10 in float64; the ``write_sharded`` / ``read_sharded`` round
trip; and a C8 ``run_segment`` on a (2, 2) layout whose stores and
RESTART equal the single-process run's."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (
    FAILING_RANK,
    SHARDED_HALOS,
    SHARDED_LAYOUTS,
    SHARDED_N,
    sharded_failing_worker,
    sharded_field,
    sharded_worker,
)

from fv3net_torch.core import zarrio
from fv3net_torch.entry import DRYRUN_BOUNDS
from fv3net_torch.physics.radiation.driver import RadiationDriver
from fv3net_torch.physics.radiation.rrtmg.driver import RRTMGDriver
from fv3net_torch.parallel import sharded

jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's readings from one launch of 4 gloo ranks, and the
    directory they wrote to."""
    out = tmp_path_factory.mktemp("sharded")
    threads = max(1, torch.get_num_threads() // 4)
    return sharded.launch(sharded_worker, 4, (str(out), threads)), out


@pytest.mark.parametrize("layout", SHARDED_LAYOUTS)
def test_block_exchange_equals_reference_block_slice(ranks, layout):
    """Each rank's extended block equals the reference's block_slice of its
    single-device halo_append, bit for bit, corners included, for h = 1,
    2, 3; the blocks' interiors reassemble the global field."""
    from fv3net_tpu.parallel.halo import halo_append
    from fv3net_tpu.parallel.shardmap_halo import block_slice

    results, _ = ranks
    py, px = layout
    my, mx = SHARDED_N // py, SHARDED_N // px
    for h in SHARDED_HALOS:
        f = sharded_field(h)
        ext = np.asarray(halo_append(jnp.asarray(f), h))
        for res in results:
            (r, c), got = res["halo"][layout, h]
            np.testing.assert_array_equal(
                got, block_slice(ext, r, c, my, h, mx),
                err_msg=f"layout {layout} h {h} block {(r, c)}")
    for res in results:
        np.testing.assert_array_equal(res["halo"][layout, "blocks"],
                                      sharded_field(3))


def _readings(summary, key):
    return summary[key]["max_rel_diff_vs_single_device"]


def test_dryrun_float32_meets_reference_bounds(ranks):
    """The dry run in float32 on the (2, 2) layout, C8, 32 levels: the
    nonhydrostatic RRTMG step within 2e-5, the 8-step production chunk
    within 5e-3 (relative to each field's scale), write_sharded exact,
    the data-parallel Adam step within 1e-5; every rank reads the same."""
    results, _ = ranks
    dry = results[0]["dry32"]
    assert dry["mesh_layout"] == [2, 2] and dry["npx"] == 8
    assert not dry["failures"], dry["failures"]
    for key, case in [("multichip_numerics", "step"),
                      ("production_chunk_numerics", "chunk"),
                      ("dp_training_step", "train")]:
        for k, r in _readings(dry, key).items():
            if k != "total_precipitation":
                assert r <= DRYRUN_BOUNDS[torch.float32][case], (case, k, r)
    write = dry["write_sharded_roundtrip"]["max_abs_diff_vs_single_device"]
    assert write == {"air_temperature": 0.0, "read_sharded": 0.0}
    for res in results[1:]:
        assert res["dry32"]["multichip_numerics"] == dry["multichip_numerics"]


def test_dryrun_float64_is_the_tight_control(ranks):
    """The same dry run in float64: step and chunk within 1e-10 of one
    device (the float32 readings are roundoff grown through the chunk,
    not a halo or collective fault), the training step within 1e-12."""
    results, _ = ranks
    dry = results[0]["dry64"]
    assert not dry["failures"], dry["failures"]
    for key, bound in [("multichip_numerics", 1e-10),
                       ("production_chunk_numerics", 1e-10),
                       ("dp_training_step", 1e-12)]:
        for k, r in _readings(dry, key).items():
            assert r <= bound, (key, k, r)


def test_write_and_read_sharded_round_trip(ranks):
    """write_sharded: each rank its region of one store chunked by block,
    read back whole exactly; read_sharded gives each rank its block."""
    results, _ = ranks
    rng = np.random.RandomState(7)
    full = rng.randn(6, 3, 8, 8)
    for res in results:
        io = res["io"]
        assert io["chunks"] == (6, 3, 4, 4)
        np.testing.assert_array_equal(io["whole"], full)
        np.testing.assert_array_equal(io["block"], io["want_block"])


def test_sharded_run_segment_equals_single_process(ranks):
    """A C8 run_segment on a (2, 2) layout (each rank its 4 x 4 blocks)
    writes the single-process run's diagnostics stores (every chunk and
    the interval average, float32) bit for bit, and its RESTART (rank 0,
    gathered; float64) within 1e-12 of scale: the global means of the
    stratospheric eddy damping sum in another order."""
    from fv3net_torch.runtime import checkpoint

    results, out = ranks
    for res in results:
        assert res["segment_counts"] == ((6, 8, 4, 4), (2, 2))
    for store in ("state.zarr", "diags.zarr"):
        a = zarrio.open_zarr(os.path.join(out, "sharded", store))
        b = zarrio.open_zarr(os.path.join(out, "single", store))
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k].values),
                                          np.asarray(b[k].values),
                                          err_msg=f"{store} {k}")
    sa, ta = checkpoint.load_state(os.path.join(out, "sharded", "RESTART"))
    sb, tb = checkpoint.load_state(os.path.join(out, "single", "RESTART"))
    assert ta == tb
    for k in ("delp", "pt", "wind"):
        x = getattr(sa.dycore, k).numpy()
        y = getattr(sb.dycore, k).numpy()
        assert np.abs(x - y).max() <= 1e-12 * np.abs(y).max(), k


def test_a_failing_rank_fails_every_rank(tmp_path):
    """Under a sharded layout a step that raises on one rank ends the run
    on every rank (the others wait in that step's halo exchanges): the
    launch raises that rank's error, and no partial segment is kept."""
    import time

    from torch.multiprocessing import ProcessRaisedException

    threads = max(1, torch.get_num_threads() // 4)
    t0 = time.perf_counter()
    with pytest.raises(ProcessRaisedException):
        sharded.launch(sharded_failing_worker, 4, (str(tmp_path), threads))
    assert time.perf_counter() - t0 < 120.0
    with open(os.path.join(tmp_path, f"rank{FAILING_RANK}.error")) as f:
        assert "injected failure in the second chunk" in f.read()
    assert not os.path.isdir(os.path.join(tmp_path, "RESTART"))


@pytest.mark.parametrize("driver, shapes, axis", [
    (RRTMGDriver, lambda ncol, nz: ((ncol, 140 * nz), (ncol, 112 * nz)), 0),
    (RadiationDriver, lambda ncol, nz: ((nz, ncol, 140), (nz, ncol, 112)),
     1),
])
def test_mcica_draws_in_slabs_keep_the_global_columns(monkeypatch, driver,
                                                      shapes, axis):
    """A McICA draw that holds at most DRAW_SLAB values is one torch.rand
    of its shapes; a larger one comes in slabs of whole columns, and the
    columns that ``keep`` names (a rank's block of the global order) are
    the whole draw's, so every block's draws reassemble it."""
    ncol, nz, fold = 6 * 4 * 4, 3, 11
    d = driver(device="cpu")
    gen = torch.Generator().manual_seed(d.config.mcica_seed * 1000003 + fold)
    whole = d.draw_mcica(fold, ncol, nz)
    for x, shape in zip(whole, shapes(ncol, nz)):
        assert x.shape == shape
    assert torch.equal(whole[0], torch.rand(shapes(ncol, nz)[0],
                                            generator=gen, dtype=d.dtype))
    cols = torch.arange(ncol).reshape(6, 4, 4)
    blocks = [cols[:, ys, xs].reshape(-1) for ys, xs in [
        (slice(0, 2), slice(0, 4)), (slice(2, 4), slice(0, 2)),
        (slice(2, 4), slice(2, 4))]]
    for slab in (None, 140 * nz * 5):  # one slab; 5 columns a slab
        if slab:
            monkeypatch.setattr(sharded, "DRAW_SLAB", slab)
        full = d.draw_mcica(fold, ncol, nz)
        for keep in blocks:
            part = d.draw_mcica(fold, ncol, nz, keep=keep)
            for got, want in zip(part, full):
                assert torch.equal(got, want.index_select(axis, keep))
