"""Shared inputs and comparisons for the ``tests/test_torch_*.py`` files,
which hold ``fv3net_torch`` against ``fv3net_tpu`` on the same numpy
inputs."""
import numpy as np


def make_state_numpy(npx: int, npz: int, seed: int = 0, moist: bool = False):
    """A perturbed, moving numpy state on the hybrid coordinate, plus its
    grid and (ak, bk).

    Starts from the reference's isothermal rest state (or, with
    ``moist``, a lapse-rate profile near saturation that triggers
    convection), then adds smooth winds, surface-pressure and theta_v
    structure and seeded noise.
    """
    from fv3net_torch.core.constants import KAPPA, RDGAS, RVGAS
    from fv3net_torch.dycore.vertical import hybrid_coordinate
    from fv3net_torch.grid.geometry import make_grid

    rng = np.random.RandomState(seed)
    grid = make_grid(npx)
    ak, bk = hybrid_coordinate(npz)
    n = grid.n
    lat, lon = grid.lat, grid.lon
    ps = 1.0e5 + 800.0 * np.cos(2 * lat) * np.sin(lon) + 50.0 * rng.randn(6, n, n)
    pe = ak[None, :, None, None] + bk[None, :, None, None] * ps[:, None]
    delp = np.diff(pe, axis=1)
    pmid = delp / np.diff(np.log(pe), axis=1)
    if moist:
        T = np.maximum(300.0 * (pmid / 1.0e5) ** 0.22, 205.0)
        T = T - 10.0 * np.sin(lat[:, None]) ** 2
        es = 610.94 * np.exp(17.625 * (T - 273.15) / (T - 273.15 + 243.04))
        qsat = 0.622 * es / (pmid - 0.378 * es)
        q = 0.9 * qsat * (pmid / 1.0e5) ** 0.5 * (1 + 0.05 * rng.rand(*T.shape))
        q = np.minimum(q, 0.03)
    else:
        T = 280.0 + 8.0 * np.cos(lat[:, None]) ** 2 + 0.2 * rng.randn(6, npz, n, n)
        es = 610.94 * np.exp(17.625 * (280.0 - 273.15) / (280.0 - 273.15 + 243.04))
        q = 0.5 * 0.622 * es / (pmid - 0.378 * es) * (pmid / 1.0e5) ** 2
        q = q * (1 + 0.2 * rng.rand(*q.shape))
    tv = T * (1.0 + (RVGAS / RDGAS - 1.0) * q)
    pt = tv * (1.0e5 / pmid) ** KAPPA
    u = (15.0 * np.cos(lat) + rng.randn(6, n, n))[:, None] * np.linspace(0.3, 1.0, npz)[None, :, None, None]
    v = (3.0 * np.sin(2 * lon) * np.cos(lat))[:, None] + 0.5 * rng.randn(6, npz, n, n)
    east = np.moveaxis(grid.east, -1, 0)[:, :, None]
    north = np.moveaxis(grid.north, -1, 0)[:, :, None]
    wind = u[None] * east + v[None] * north
    state = {
        "delp": delp,
        "pt": pt,
        "wind": wind,
        "tracers": {
            "sphum": q,
            "cloud_water": 1e-5 * rng.rand(6, npz, n, n),
        },
        "phis": np.zeros((6, n, n)),
    }
    return state, grid, ak, bk


def jax_state(state, dtype):
    """The numpy state as the reference package's DycoreState."""
    import jax.numpy as jnp
    from fv3net_tpu.dycore.state import DycoreState

    return DycoreState(
        delp=jnp.asarray(state["delp"], dtype),
        pt=jnp.asarray(state["pt"], dtype),
        wind=jnp.asarray(state["wind"], dtype),
        tracers={k: jnp.asarray(v, dtype) for k, v in state["tracers"].items()},
        phis=jnp.asarray(state["phis"], dtype),
    )


def flat_fields(state):
    """name -> numpy array for either package's state."""
    out = {
        "delp": np.asarray(state.delp),
        "pt": np.asarray(state.pt),
        "wind": np.asarray(state.wind),
    }
    for k, v in state.tracers.items():
        out[k] = np.asarray(v)
    return out


def rel_diff(got, want):
    """max |got - want| / max |want| (the field's scale)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-300)
    return np.abs(got - want).max() / scale


def assert_states_close(got, want, rtol, fields=None):
    """Each field's max abs difference is within ``rtol`` of its scale."""
    g = flat_fields(got)
    w = flat_fields(want)
    assert set(g) == set(w), (sorted(g), sorted(w))
    diffs = {k: rel_diff(g[k], w[k]) for k in (fields or w)}
    bad = {k: d for k, d in diffs.items() if not d <= rtol}
    assert not bad, f"fields beyond rel {rtol}: {bad} (all: {diffs})"
    return diffs


def column_state(C, L, seed=0):
    """Radiation-driver inputs of C seeded columns of L levels on the
    hybrid coordinate (z index 0 = model top), with clouds in half the
    layers; returns ``(state, cosz)``."""
    from fv3net_torch.dycore.vertical import hybrid_coordinate

    rng = np.random.RandomState(seed)
    ak, bk = hybrid_coordinate(L)
    pe = ak[None] + bk[None] * (1e5 + 3000 * rng.randn(C))[:, None]
    pmid = 0.5 * (pe[:, 1:] + pe[:, :-1])
    T = np.maximum(290 * (pmid / 1e5) ** 0.2, 200) + 3 * rng.randn(C, L)
    lat = rng.uniform(-1.4, 1.4, C)
    lon = rng.uniform(0, 6.28, C)
    state = {
        "air_temperature": T,
        "pressure_thickness_of_atmospheric_layer": np.diff(pe, axis=1),
        "specific_humidity": 0.02 * (pmid / 1e5) ** 3 * rng.rand(C, L) ** 2,
        "cloud_water_mixing_ratio": 1e-4 * rng.rand(C, L) * (
            rng.rand(C, L) > 0.5),
        "surface_temperature": T[:, -1] + 1,
        "latitude": lat,
        "longitude": lon,
        "land_sea_mask": (rng.rand(C) > 0.7).astype(np.float64),
    }
    return state, np.clip(np.cos(lat) * np.cos(lon), -0.3, 1)
