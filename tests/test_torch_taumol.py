"""The one-launch LW gas optics (K2, ``lwrad(taumol="mega")``): its table
and point packing, its routing, its plain version against the
reference's megakernel in interpret mode, and the kernel source's
arithmetic, built for the host with g++, against the plain version; on
the card, the kernel itself against its plain version.

On a machine without jax (the card's), only the card tests run:
``python -m pytest --noconftest tests/test_torch_taumol.py -m gpu``.
"""
import ctypes
import datetime
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from test_rrtmg_oracle import _profiles

    jax.config.update("jax_enable_x64", True)
except ImportError:  # the card's machine has no jax
    jax = jnp = _profiles = None

from fv3net_torch import entry
from torch_port_util import column_state
from fv3net_torch.ops import cuda_build
from fv3net_torch.physics.radiation.rrtmg import driver as tdrv
from fv3net_torch.physics.radiation.rrtmg import lw as tlw
from fv3net_torch.physics.radiation.rrtmg import params as P
from fv3net_torch.physics.radiation.rrtmg import tables as ttab
from fv3net_torch.physics.radiation.rrtmg import taumol_cuda as tc

TORCH = {"float64": torch.float64, "float32": torch.float32}
LW_ARGS = ("plyr", "plvl", "tlyr", "tlvl", "qlyr", "olyr", "gasvmr",
           "clouds", "aerosols", "sfemis", "sfgtmp", "delp", "rand2d")
REFERENCE_RTOL = 1e-10  # float64, reassociated sums
# the kernel against the plain version, of each output's scale: the kernel
# sums a point's terms in an order of its own
HOST_RTOL = {"float64": 1e-12, "float32": 2e-6}
# and value by value (every term of a tau is positive, so reordering costs
# a few ulps; readings 4e-16 and 2.3e-7): at float64 this bound sees a
# wrong reference ratio in one minor gas of one band (2e-11), which hides
# below 1e-12 of the band's scale
VALUE_RTOL = {"float64": 1e-13, "float32": 2e-6}


def _lw_inputs(rich=False):
    """The oracle profile battery; ``rich`` multiplies co2 by 8 and n2o by
    4 in half the layers, so that every gas-amount adjustment takes both
    of its branches."""
    if jax is None:
        pytest.skip("needs jax (the oracle battery of the reference's tests)")
    pr = {k: np.array(v) for k, v in _profiles().items()}
    if rich:
        pr["gasvmr"][:, ::2, 0] *= 8.0
        pr["gasvmr"][:, ::2, 1] *= 4.0
    return [pr[k] for k in LW_ARGS]


@functools.lru_cache(maxsize=None)
def _tables(dtype):
    return tlw.prep_lw_tables(ttab.make_lw_tables(seed=0), dtype=TORCH[dtype])


def _capture_taumol(dtype, rich=False):
    """The arguments ``lwrad`` hands to its gas optics on the oracle
    battery."""
    seen = []
    orig = tlw.taumol_lw

    def wrapped(*args):
        seen.append(args[:7])
        return orig(*args)

    tlw.taumol_lw = wrapped
    try:
        tlw.lwrad(*[torch.tensor(x, dtype=TORCH[dtype])
                    for x in _lw_inputs(rich)], _tables(dtype))
    finally:
        tlw.taumol_lw = orig
    return seen[0]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mega_route_on_cpu_is_the_ktable_route(dtype):
    """On CPU tensors both routes run the plain version: every output of
    ``lwrad`` is equal bit for bit."""
    args = [torch.tensor(x, dtype=TORCH[dtype]) for x in _lw_inputs()]
    a = tlw.lwrad(*args, _tables(dtype), taumol="ktable")
    b = tlw.lwrad(*args, _tables(dtype), taumol="mega")
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    c = tlw.lwrad(*args, _tables(dtype), taumol="mega", impl="torch")
    assert torch.equal(a["hlwc"], c["hlwc"])


def test_taumol_options_raise():
    args = [torch.tensor(x) for x in _lw_inputs()]
    with pytest.raises(ValueError, match="taumol"):
        tlw.lwrad(*args, _tables("float64"), taumol="pallas")
    with pytest.raises(ValueError, match="lw_taumol"):
        tdrv.RRTMGDriver(tdrv.RRTMGConfig(), device="cpu", lw_taumol="fast")
    with pytest.raises(ValueError, match="impl"):
        tlw.taumol_lw_mega(*_capture_taumol("float64"), impl="tpu")


def test_mega_with_the_kernel_forced_raises_without_a_card():
    """``impl="cuda"`` asks for the kernel: on CPU tensors it raises, it
    does not fall back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    args = [torch.tensor(x) for x in _lw_inputs()]
    before = tc.TAUMOL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tlw.lwrad(*args, _tables("float64"), taumol="mega", impl="cuda")
    assert tc.TAUMOL_LAUNCHES == before


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_table_packing_round_trips(dtype):
    """Every table and reference ratio read back from the flat buffer
    through the layout equals its source; the header and the descriptors
    point inside the buffer."""
    T = _tables(dtype)
    flat, meta, layout = tc.pack_tables(T)
    assert tc.pack_tables(T)[0] is flat  # made once per table dict
    assert flat.dtype == TORCH[dtype] and meta.dtype == torch.int32

    def read(name):
        off, shape = layout[name]
        return flat[off:off + int(np.prod(shape))].reshape(shape)

    sources = {k: T[k] for k in ("chi_rows", "mtab_lo1", "mtab_hi1",
                                 "selfref_all", "forref_all", "minor1_all")}
    sources.update({f"flat_lo{i}": t for i, t in T["flat_lo"].items()})
    sources.update({f"flat_hi{i}": t for i, t in T["flat_hi"].items()})
    sources["b15_absb01"] = T["bands"][15]["absb"][:2]
    for name in layout:
        if name.startswith("b") and name != "b15_absb01":
            i, key = name[1:].split("_", 1)
            sources[name] = T["bands"][int(i)][key]
    chi = T["chi_mls"]
    sources["refrat"] = torch.stack([chi[a, lev] / chi[b, lev]
                                     for a, b, lev in tc.REFRAT])
    assert sorted(sources) == sorted(layout)
    for name, want in sources.items():
        assert torch.equal(read(name), want), name
    assert len(tc.REFRAT) == 18
    # the band-3 lower Planck ratio, as lw.taumol_lw states it
    assert read("refrat")[0] == chi[0, 8] / chi[1, 8]

    m = meta.numpy()
    assert list(m[tc.M_NG:tc.M_NG + 16]) == list(P.NG_LW)
    assert list(m[tc.M_NS:tc.M_NS + 16]) == list(P.NS_LW)
    assert m[tc.M_SELF] == layout["selfref_all"][0]
    assert m[tc.M_CHI] == layout["chi_rows"][0]
    assert (m[tc.M_NBASE_LO], m[tc.M_NBASE_HI]) == (70, T["nbase_hi"])
    assert m.size == tc.M_DESC + 32 * tc.DESC_LEN
    for b in range(16):
        ng = P.NG_LW[b]
        for upper in (0, 1):
            d = m[tc.M_DESC + (2 * b + upper) * tc.DESC_LEN:][:tc.DESC_LEN]
            if d[tc.D_MAJOR]:
                rows = 2 if d[tc.D_MAJOR] == 2 else (
                    T["nbase_hi"] if upper else 70)
                width = 9 * ng if d[tc.D_MPOS] else ng
                if upper and d[tc.D_MPOS]:
                    width = 5 * ng
                assert d[tc.D_MOFF] + (rows - 1) * d[tc.D_MROW] + width \
                    <= flat.numel()
            assert d[tc.D_NMINOR] <= 3 and d[tc.D_NHALO] <= 2
            if d[tc.D_FRAC]:
                name = f"b{b}_fracref" + ("ab"[upper] if b != 5 else "a")
                assert d[tc.D_FOFF] == layout[name][0]
                assert d[tc.D_FRAC] == len(layout[name][1])
    # band 4's upper atmosphere carries the co2 adjustment, its lower none
    d4 = m[tc.M_DESC + 6 * tc.DESC_LEN:]
    assert d4[tc.D_CO2ADJ] == -1
    assert d4[tc.DESC_LEN + tc.D_CO2ADJ] == layout["b3_co2adj"][0]


def _read_plane(ptr, stride, n, ctype):
    """n values at ``ptr`` every ``stride`` elements of ``ctype``."""
    size = ctypes.sizeof(ctype)
    return [ctype.from_address(ptr + k * stride * size).value
            for k in range(n)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_point_packing(dtype):
    """The plane struct points at the caller's own tensors with their
    element strides (``colamt``, ``wx``, ``tauaer``, ``rfrate`` in their
    [C, L, k] layouts) and carries every value the kernel reads, in its
    order; nothing is copied."""
    c, colamt, coldry, colbrd, wx, tauaer, T = _capture_taumol(dtype)
    flat = tc.pack_tables(T)[0]
    planes, keep = tc.pack_planes(c, colamt, coldry, colbrd, wx, tauaer,
                                  flat)
    assert keep == []
    N = coldry.numel()
    assert len(planes.f) == len(tc.FLOAT_PLANES) == 53
    assert len(planes.i) == len(tc.INT_PLANES) == 7
    f = dict(zip(tc.FLOAT_PLANES, zip(planes.f, planes.fs)))
    size = colamt.element_size()
    assert f["pavel"] == (c["pavel"].data_ptr(), 1)
    assert f["rfrate51"] == (c["rfrate"].data_ptr() + 11 * size, 12)
    assert f["colamt6"] == (colamt.data_ptr() + 6 * size, 7)
    assert f["colbrd"] == (colbrd.data_ptr(), 1)
    assert f["wx3"] == (wx.data_ptr() + 3 * size, 4)
    assert f["tauaer15"] == (tauaer.data_ptr() + 15 * size, 16)
    ctype = ctypes.c_double if dtype == "float64" else ctypes.c_float
    for name, want in (("rfrate51", c["rfrate"][..., 5, 1]),
                       ("tauaer15", tauaer[..., 15]),
                       ("fac11", c["fac11"])):
        got = _read_plane(*f[name], N, ctype)
        assert got == want.reshape(-1).tolist(), name
    i = dict(zip(tc.INT_PLANES, zip(planes.i, planes.istride, planes.iw)))
    assert i["jt1"] == (c["jt1"].data_ptr(), 1, 8)
    assert i["tropo"] == (c["tropo"].data_ptr(), 1, 1)
    assert _read_plane(i["tropo"][0], 1, N, ctypes.c_bool) == \
        c["tropo"].reshape(-1).tolist()


def test_point_packing_copies_only_uneven_planes():
    """A plane that is not evenly strided over the points (a [C, L] view
    of a transposed [L, C] tensor) is copied; a plane of another dtype, or
    an index plane of a float dtype, is refused."""
    c, colamt, coldry, colbrd, wx, tauaer, T = _capture_taumol("float64")
    flat = tc.pack_tables(T)[0]
    c = dict(c, pavel=c["pavel"].T.contiguous().T,
             jp=c["jp"].to(torch.int32))
    planes, keep = tc.pack_planes(c, colamt, coldry, colbrd, wx, tauaer,
                                  flat)
    assert len(keep) == 1 and torch.equal(keep[0], c["pavel"])
    f = dict(zip(tc.FLOAT_PLANES, zip(planes.f, planes.fs)))
    assert f["pavel"] == (keep[0].data_ptr(), 1)
    assert (planes.i[0], planes.iw[0]) == (c["jp"].data_ptr(), 4)
    with pytest.raises(TypeError, match="plane fac00"):
        tc.pack_planes(dict(c, fac00=c["fac00"].float()), colamt, coldry,
                       colbrd, wx, tauaer, flat)
    with pytest.raises(TypeError, match="index plane jt"):
        tc.pack_planes(dict(c, jt=c["jt"].double()), colamt, coldry,
                       colbrd, wx, tauaer, flat)
    with pytest.raises(ValueError, match="shape"):
        tc.pack_planes(c, colamt, coldry[:, :-1], colbrd, wx, tauaer, flat)


def test_taumol_lw_matches_reference_megakernel():
    """The port's gas optics (its k-table route and its plain version of
    K2) against the reference's megakernel in interpret mode (2 columns
    per block), float64, on the reference's own setcoef values."""
    from fv3net_tpu.physics.radiation.rrtmg import lw as jlw
    from fv3net_tpu.physics.radiation.rrtmg import pallas_taumol

    T = jlw.prep_lw_tables(ttab.make_lw_tables(seed=0), dtype="float64")
    seen = []
    orig = jlw.taumol_lw

    def wrapped(*args, **kwargs):
        seen.append(args[:6])
        return orig(*args, **kwargs)

    jlw.taumol_lw = wrapped
    jlw.set_pallas_ktable("off")
    try:
        jlw.lwrad(*[jnp.asarray(x, jnp.float64) for x in _lw_inputs()], T,
                  fast_exp=True)
    finally:
        jlw.taumol_lw = orig
        jlw.set_pallas_ktable("auto")
    jargs = seen[0]
    want = pallas_taumol.taumol_lw_megakernel(*jargs, T, block=2,
                                              interpret=True)

    def to_torch(x):
        if isinstance(x, dict):
            return {k: to_torch(v) for k, v in x.items()}
        a = np.asarray(x)
        return torch.tensor(a.astype(np.int64) if a.dtype.kind in "iu"
                            else a)

    targs = [to_torch(x) for x in jargs]
    for fn in (tlw.taumol_lw, tlw.taumol_lw_plain, tlw.taumol_lw_mega):
        got = fn(*targs, _tables("float64"))
        for g, w, name in zip(got, want, ("fracs", "tautot")):
            w = np.asarray(w)
            assert g.shape == w.shape
            err = np.abs(g.numpy() - w).max()
            assert err <= REFERENCE_RTOL * np.abs(w).max(), (fn, name, err)


# ------------------------------------------------- the kernel source on the host
# the kernel source's host program: the kernel's tiles, bands and
# two phases as loops over the source's own device-agnostic functions
HOST_PROGRAM = r"""
#include <vector>
#include "%s"

namespace {

template <typename T>
int host_taumol(const Planes& pl, const void* tab_, const void* meta_,
                void* fracs_, void* tautot_, long long N, double oneminus) {
  const T* tab = (const T*)tab_;
  const int* meta = (const int*)meta_;
  T* fracs = (T*)fracs_;
  T* tautot = (T*)tautot_;
  const T om = (T)oneminus;
  std::vector<Common<T>> sc(kP);
  std::vector<BandRec<T>> sb(kP);
  std::vector<Point<T>> pts(kP);
  for (long long n0 = 0; n0 < N; n0 += kP) {
    const int np = (N - n0 < kP) ? (int)(N - n0) : kP;
    for (int q = 0; q < np; ++q) {
      load_point(pl, n0 + q, pts[q]);
      common_point(pl, meta, n0 + q, pts[q], sc[q]);
    }
    for (int b = 0; b < kBands; ++b) {
      for (int q = 0; q < np; ++q)
        band_point(b, pts[q], sc[q], tab, meta, om, sb[q]);
      const int ng = meta[M_NG + b];
      const int ns = meta[M_NS + b];
      for (int t = 0; t < np * ng; ++t) {
        const int q = t / ng;
        const int ig = t - q * ng;
        T tau, frac;
        eval_point(b, ig, sc[q], sb[q], tab, meta, pl, n0 + q, tau, frac);
        tautot[(n0 + q) * kG + ns + ig] = tau;
        fracs[(n0 + q) * kG + ns + ig] = frac;
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" int fv3_taumol_lw_host_f32(Planes pl, const void* tab,
                                      const void* meta, void* fracs,
                                      void* tautot, long long N,
                                      double oneminus) {
  return host_taumol<float>(pl, tab, meta, fracs, tautot, N, oneminus);
}

extern "C" int fv3_taumol_lw_host_f64(Planes pl, const void* tab,
                                      const void* meta, void* fracs,
                                      void* tautot, long long N,
                                      double oneminus) {
  return host_taumol<double>(pl, tab, meta, fracs, tautot, N, oneminus);
}
"""


@functools.lru_cache(maxsize=None)
def _host_library(build_dir):
    """``HOST_PROGRAM`` around ``csrc/taumol_lw.cu``, built with g++.  (The
    kernel itself, its tiles and barriers, runs on the CPU in
    ``tests/test_torch_kernel_emulation.py``.)"""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    src = f"{build_dir}/taumol_lw_host.cpp"
    lib = f"{build_dir}/libtaumol_lw_host.so"
    with open(src, "w") as f:
        f.write(HOST_PROGRAM % (cuda_build.CSRC / tc.SOURCE))
    subprocess.run(
        [gxx, "-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
         src, "-o", lib],
        check=True, capture_output=True, text=True, timeout=300,
    )
    return lib


def _host_taumol(lib_path, c, colamt, coldry, colbrd, wx, tauaer, T):
    lib = ctypes.CDLL(lib_path)
    flat, meta, _ = tc.pack_tables(T)
    planes, keep = tc.pack_planes(c, colamt, coldry, colbrd, wx, tauaer,
                                  flat)
    fracs = torch.empty(coldry.shape + (P.NGPT_LW,), dtype=flat.dtype)
    tautot = torch.empty_like(fracs)
    fn = getattr(lib, "fv3_taumol_lw_host_"
                 + {torch.float32: "f32", torch.float64: "f64"}[flat.dtype])
    fn.argtypes = [tc.Planes] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                                         ctypes.c_double]
    fn.restype = ctypes.c_int
    err = fn(planes, flat.data_ptr(), meta.data_ptr(), fracs.data_ptr(),
             tautot.data_ptr(), coldry.numel(), float(P.ONEMINUS))
    assert err == 0
    return fracs, tautot


@pytest.mark.parametrize("rich", [False, True], ids=["battery", "rich"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_source_on_the_host_matches_plain(tmp_path_factory, dtype,
                                                 rich):
    """Phase 1 and phase 2 of the kernel source, compiled for the host,
    against ``taumol_lw_plain`` per band and atmosphere, within
    ``HOST_RTOL`` of each band's scale; Planck fractions equal."""
    lib = _host_library(str(tmp_path_factory.getbasetemp()))
    if lib is None:
        pytest.skip("needs g++")
    args = _capture_taumol(dtype, rich)
    c = args[0]
    assert c["tropo"].any() and (~c["tropo"]).any()
    if rich:  # both branches of the co2 and n2o adjustments are taken
        co2 = args[1][..., 1] / (args[2] * 3.55e-4)
        assert (co2 > 3.0).any() and (co2 <= 3.0).any()
    want = tlw.taumol_lw_plain(*args)
    got = _host_taumol(lib, *args)
    for g, w, name in zip(got, want, ("fracs", "tautot")):
        assert torch.isfinite(w).all() and torch.isfinite(g).all()
        for b in range(P.NBANDS_LW):
            sl = slice(P.NS_LW[b], P.NS_LW[b] + P.NG_LW[b])
            for upper in (False, True):
                at = c["tropo"] != upper
                gb, wb = g[..., sl][at], w[..., sl][at]
                err = (gb - wb).abs().max().item()
                scale = wb.abs().max().item()
                where = (name, b + 1, "upper" if upper else "lower")
                assert err <= HOST_RTOL[dtype] * scale, (where, err, scale)
                assert ((gb - wb).abs() <= VALUE_RTOL[dtype] * wb.abs()).all(), \
                    where
    assert torch.equal(got[0], want[0])


def test_entry_flagship_mega_route_on_cpu():
    """``flagship(lw_taumol="mega")`` as a 2-step float64 chunk on the
    CPU equals the default route bit for bit, with no kernel launch."""
    out = {}
    before = tc.TAUMOL_LAUNCHES
    for route in ("ktable", "mega"):
        step, (state, ml_params, sst, cosz) = entry.flagship(
            npx=4, npz=8, chunk=2, radiation_interval=1, dtype=torch.float64,
            device="cpu", lw_taumol=route)
        out[route] = step(state, ml_params, sst, cosz)
    assert tc.TAUMOL_LAUNCHES == before
    for name in ("delp", "pt", "wind"):
        assert torch.equal(getattr(out["mega"], name),
                           getattr(out["ktable"], name)), name
    assert not torch.equal(out["mega"].pt, state.pt)


# ---------------------------------------------------------------- the card
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_taumol_kernel_matches_plain_on_card(dtype):
    """K2 on the card, inside one driver call at 1,000 columns x 32
    levels (a ragged last tile of points), against its plain version on
    the same CUDA arguments; the launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tdt = TORCH[dtype]
    seen = []
    orig = tc.taumol_lw_cuda

    def wrapped(*args):
        out = orig(*args)
        seen.append((args, out))
        return out

    state, cosz = column_state(1000, 32)
    driver = tdrv.RRTMGDriver(tdrv.RRTMGConfig(), dtype=tdt, device="cuda",
                              lw_taumol="mega")
    before = tc.TAUMOL_LAUNCHES
    tc.taumol_lw_cuda = wrapped
    try:
        out = driver(datetime.datetime(2016, 7, 1),
                     {k: torch.tensor(v, dtype=tdt, device="cuda")
                      for k, v in state.items()},
                     cosz=torch.tensor(cosz, dtype=tdt, device="cuda"))
    finally:
        tc.taumol_lw_cuda = orig
    torch.cuda.synchronize()
    assert tc.TAUMOL_LAUNCHES == before + 1
    assert torch.isfinite(
        out["total_sky_longwave_heating_rate_python"]).all()
    args, got = seen[0]
    want = tlw.taumol_lw_plain(*args)
    tropo = args[0]["tropo"]
    assert tropo.any() and (~tropo).any()
    for g, w, name in zip(got, want, ("fracs", "tautot")):
        assert torch.isfinite(g).all() and torch.isfinite(w).all()
        err = (g - w).abs().max().item()
        assert err <= HOST_RTOL[dtype] * w.abs().max().item(), (name, err)
        assert ((g - w).abs() <= VALUE_RTOL[dtype] * w.abs()).all(), name
