"""Wrapper of the CUDA LW gas-optics kernel ``csrc/taumol_lw.cu`` (K2).

K2 replaces the TPU kernel ``fv3net_tpu/physics/radiation/rrtmg/
pallas_taumol.py::taumol_lw_megakernel``: all of ``lw.py::taumol_lw``, 16
bands and 140 g-points, in one launch.  Its plain PyTorch version is
``lw.py::taumol_lw_plain``; ``lwrad(..., taumol="mega")`` calls this
wrapper on CUDA tensors.

:func:`pack_tables` lays every table the kernel reads into one flat
buffer, beside an integer array that says where each lies and what each
(band, atmosphere) sums (the descriptors the kernel's second phase
interprets); it runs once per ``prep_lw_tables`` result and is kept on
that dict.  :func:`pack_planes` hands the kernel the per-point values
where the caller holds them, a pointer and an element stride per plane in
a :class:`Planes` struct passed by value (only a plane that is not evenly
strided over the points is copied); :func:`taumol_lw_launch` launches
the kernel on them.

Build: :func:`fv3net_torch.ops.cuda_build.build` compiles the source at
first use, without fused multiply-adds (see the source).  There is no
fallback: a missing compiler, a failed build or a failed launch raises.
``TAUMOL_LAUNCHES`` counts the launches of this process.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from fv3net_torch.ops import cuda_build
from fv3net_torch.ops.cuda_build import check_tensor
from fv3net_torch.physics.radiation.rrtmg import params as P

SOURCE = "taumol_lw.cu"
EXTRA_FLAGS = ("-fmad=false",)

TAUMOL_LAUNCHES = 0

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_PACK_KEY = "_taumol_pack"

# float planes of the points, in the kernel's order (F_* in the source)
FLOAT_PLANES = (
    ["fac00", "fac01", "fac10", "fac11", "pavel", "scaleminor",
     "scaleminorn2", "selffac", "selffrac", "forfac", "forfrac",
     "minorfrac"]
    + [f"rfrate{m}{k}" for m in range(P.NRATES) for k in range(2)]
    + [f"colamt{i}" for i in range(P.MAXGAS)]
    + ["coldry", "colbrd"]
    + [f"wx{i}" for i in range(P.MAXXSEC)]
    + [f"tauaer{i}" for i in range(P.NBANDS_LW)]
)
INT_PLANES = ["jp", "jt", "jt1", "indself", "indfor", "indminor", "tropo"]
# bytes of an index the kernel reads, by dtype
_INDEX_WIDTH = {torch.int32: 4, torch.int64: 8, torch.bool: 1}


class Planes(ctypes.Structure):
    """The point planes as the kernel takes them (``csrc/taumol_lw.cu``):
    per plane a pointer and an element stride (plane k's value at point n
    lies at ``f[k] + n * fs[k]``), float planes in ``FLOAT_PLANES``' order
    and in the tables' dtype, index planes in ``INT_PLANES``' order with
    their bytes per index (4, 8 or 1 for bool)."""

    _fields_ = [("f", ctypes.c_void_p * len(FLOAT_PLANES)),
                ("i", ctypes.c_void_p * len(INT_PLANES)),
                ("fs", ctypes.c_longlong * len(FLOAT_PLANES)),
                ("istride", ctypes.c_longlong * len(INT_PLANES)),
                ("iw", ctypes.c_int * len(INT_PLANES))]

# reference amount ratios chi_mls[a, level] / chi_mls[b, level] at fixed
# levels, in the kernel's order (R_* in the source): (a, b, level)
REFRAT = [
    (0, 1, 8), (0, 1, 12), (0, 1, 2), (0, 1, 12),  # band 3 pl_a pl_b m_a m_b
    (0, 1, 10), (2, 1, 12),                        # band 4 pl_a pl_b
    (0, 1, 4), (2, 1, 42), (0, 1, 6),              # band 5 pl_a pl_b m_a
    (0, 2, 2),                                     # band 7
    (0, 5, 8), (0, 5, 2),                          # band 9 pl_a m_a
    (0, 1, 9),                                     # band 12
    (0, 3, 4), (0, 3, 0), (0, 3, 2),               # band 13 pl_a m_a m_a3
    (3, 1, 0),                                     # band 15
    (0, 5, 5),                                     # band 16
]

# meta layout (M_* and D_* in the source)
M_NG, M_NS, M_SELF, M_FOR, M_CHI, M_REFRAT = 0, 16, 32, 33, 34, 35
M_NBASE_LO, M_NBASE_HI, M_DESC = 36, 37, 40
DESC_LEN = 24
(D_MAJOR, D_MOFF, D_MROW, D_MPOS, D_SELF, D_FOR, D_NMINOR, D_MINOR) = range(8)
D_NHALO, D_HALO, D_CO2ADJ, D_FRAC, D_FOFF = 16, 17, 21, 22, 23

# what each band sums per atmosphere (lw.py:472-753), 0-based bands:
# major "single" (merged single-species table), "spec" (species-
# interpolated band table), "rows01" (band 16's collapsed upper rows) or
# None; minors as table keys (2-D keys are 1-D minors of minor1_all, 3-D
# ones bilinear); halo as (wx index, key); frac "a"/"b" (a vector, or
# rows interpolated over the species parameter when the table is 2-D) or
# None (zero).
_LOWER = {
    0: dict(major="single", self_for=(1, 1), minors=["ka_mn2"], frac="a"),
    1: dict(major="single", self_for=(1, 1), frac="a"),
    2: dict(major="spec", self_for=(1, 1), minors=["ka_mn2o"], frac="a"),
    3: dict(major="spec", self_for=(1, 1), frac="a"),
    4: dict(major="spec", self_for=(1, 1), minors=["ka_mo3"],
            halo=[(0, "ccl4")], frac="a"),
    5: dict(major="single", self_for=(1, 1), minors=["ka_mco2"],
            halo=[(1, "cfc11adj"), (2, "cfc12")], frac="a"),
    6: dict(major="spec", self_for=(1, 1), minors=["ka_mco2"], frac="a"),
    7: dict(major="single", self_for=(1, 1),
            minors=["ka_mco2", "ka_mo3", "ka_mn2o"],
            halo=[(2, "cfc12"), (3, "cfc22adj")], frac="a"),
    8: dict(major="spec", self_for=(1, 1), minors=["ka_mn2o"], frac="a"),
    9: dict(major="single", self_for=(1, 1), frac="a"),
    10: dict(major="single", self_for=(1, 1), minors=["ka_mo2"], frac="a"),
    11: dict(major="spec", self_for=(1, 1), frac="a"),
    12: dict(major="spec", self_for=(1, 1), minors=["ka_mco2", "ka_mco"],
             frac="a"),
    13: dict(major="single", self_for=(1, 1), frac="a"),
    14: dict(major="spec", self_for=(1, 1), minors=["ka_mn2"], frac="a"),
    15: dict(major="spec", self_for=(1, 1), frac="a"),
}
_UPPER = {
    0: dict(major="single", self_for=(0, 1), minors=["ka_mn2"], frac="b"),
    1: dict(major="single", self_for=(0, 1), frac="b"),
    2: dict(major="spec", self_for=(0, 1), minors=["kb_mn2o"], frac="b"),
    3: dict(major="spec", co2adj=True, frac="b"),
    4: dict(major="spec", halo=[(0, "ccl4")], frac="b"),
    5: dict(halo=[(1, "cfc11adj"), (2, "cfc12")], frac="a"),
    6: dict(major="single", minors=["kb_mco2"], co2adj=True, frac="b"),
    7: dict(major="single", minors=["kb_mco2", "kb_mn2o"],
            halo=[(2, "cfc12"), (3, "cfc22adj")], frac="b"),
    8: dict(major="single", minors=["kb_mn2o"], frac="b"),
    9: dict(major="single", self_for=(0, 1), frac="b"),
    10: dict(major="single", self_for=(0, 1), minors=["kb_mo2"], frac="b"),
    11: dict(),
    12: dict(minors=["kb_mo3"], frac="b"),
    13: dict(major="single", frac="b"),
    14: dict(),
    15: dict(major="rows01", frac="b"),
}


def build() -> cuda_build.BuildInfo:
    """Compile the kernel library if needed; returns its build info."""
    return cuda_build.build(SOURCE, EXTRA_FLAGS)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    ptr = ctypes.c_void_p
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fv3_taumol_lw_{sfx}")
        fn.argtypes = [Planes] + [ptr] * 4 + [ctypes.c_longlong,
                                               ctypes.c_double, ptr]
        fn.restype = ctypes.c_int
    lib.fv3_taumol_lw_plan.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.fv3_taumol_lw_plan.restype = ctypes.c_int
    return lib


def _col_offsets(bands) -> Dict[int, int]:
    out, off = {}, 0
    for i in bands:
        out[i] = off
        off += P.NG_LW[i]
    return out


def pack_tables(T: Dict) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """(flat, meta, layout) of a ``prep_lw_tables`` result, made once and
    kept on ``T``.

    flat: every table the kernel reads, in ``T``'s dtype on its device;
    meta: int32 array (the kernel's ``M_*`` header and one ``D_*``
    descriptor per (band, atmosphere)); layout: name -> (offset, shape)
    of each table in ``flat`` (bands' tables as ``"b<i>_<key>"``)."""
    # lw.py imports this module; its groupings of the merged tables are
    # read here, when the first table dict is packed
    from fv3net_torch.physics.radiation.rrtmg import lw

    if _PACK_KEY in T:
        return T[_PACK_KEY]
    chi = T["chi_mls"]
    B = T["bands"]
    pieces: List[torch.Tensor] = []
    layout: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
    size = 0

    def put(name, tensor):
        nonlocal size
        layout[name] = (size, tuple(tensor.shape))
        pieces.append(tensor.reshape(-1))
        size += tensor.numel()
        return layout[name][0]

    put("chi_rows", T["chi_rows"])
    put("refrat", torch.stack([chi[a, lev] / chi[b, lev]
                               for a, b, lev in REFRAT]))
    for key in ("mtab_lo1", "mtab_hi1", "selfref_all", "forref_all",
                "minor1_all"):
        put(key, T[key])
    for i, tab in T["flat_lo"].items():
        put(f"flat_lo{i}", tab)
    for i, tab in T["flat_hi"].items():
        put(f"flat_hi{i}", tab)
    put("b15_absb01", B[15]["absb"][:2])
    used = set()
    for spec in list(_LOWER.values()) + list(_UPPER.values()):
        used.update(spec.get("minors", []))
        used.update(k for _, k in spec.get("halo", []))
    for i, band in enumerate(B):
        for key, tab in band.items():
            if key in ("fracrefa", "fracrefb", "co2adj") or (
                    key in used and tab.ndim != 2):
                put(f"b{i}_{key}", tab)
    flat = torch.cat(pieces).contiguous()

    meta = np.zeros(M_DESC + 2 * P.NBANDS_LW * DESC_LEN, np.int32)
    meta[M_NG:M_NG + 16] = P.NG_LW
    meta[M_NS:M_NS + 16] = P.NS_LW
    meta[M_SELF] = layout["selfref_all"][0]
    meta[M_FOR] = layout["forref_all"][0]
    meta[M_CHI] = layout["chi_rows"][0]
    meta[M_REFRAT] = layout["refrat"][0]
    meta[M_NBASE_LO] = T["mtab_lo1"].shape[0]
    meta[M_NBASE_HI] = T["mtab_hi1"].shape[0]
    single = {0: ("mtab_lo1", _col_offsets(lw._SINGLE_LO)),
              1: ("mtab_hi1", _col_offsets(lw._SINGLE_HI))}
    m1_off = {}
    off = 0
    for i, key in lw._MINOR1_KEYS:
        m1_off[(i, key)] = off
        off += P.NG_LW[i]
    for b in range(P.NBANDS_LW):
        ng = P.NG_LW[b]
        for upper, spec in ((0, _LOWER[b]), (1, _UPPER[b])):
            d = meta[M_DESC + (2 * b + upper) * DESC_LEN:][:DESC_LEN]
            major = spec.get("major")
            if major == "single":
                name, cols = single[upper]
                d[D_MAJOR] = 1
                d[D_MOFF] = layout[name][0] + cols[b]
                d[D_MROW] = layout[name][1][1]
            elif major == "spec":
                name = f"flat_hi{b}" if upper else f"flat_lo{b}"
                d[D_MAJOR] = 1
                d[D_MOFF] = layout[name][0]
                d[D_MROW] = layout[name][1][1]
                d[D_MPOS] = ng
            elif major == "rows01":
                d[D_MAJOR] = 2
                d[D_MOFF] = layout["b15_absb01"][0]
                d[D_MROW] = ng
            d[D_SELF], d[D_FOR] = spec.get("self_for", (0, 0))
            minors = spec.get("minors", [])
            d[D_NMINOR] = len(minors)
            for k, key in enumerate(minors):
                m = d[D_MINOR + 3 * k:]
                if B[b][key].ndim == 2:  # a 1-D minor, inside minor1_all
                    m[0] = 1
                    m[1] = layout["minor1_all"][0] + m1_off[(b, key)]
                    m[2] = layout["minor1_all"][1][1]
                else:
                    m[0] = 2
                    m[1] = layout[f"b{b}_{key}"][0]
                    m[2] = ng
            halo = spec.get("halo", [])
            d[D_NHALO] = len(halo)
            for k, (wx_index, key) in enumerate(halo):
                d[D_HALO + 2 * k] = wx_index
                d[D_HALO + 2 * k + 1] = layout[f"b{b}_{key}"][0]
            d[D_CO2ADJ] = (layout[f"b{b}_co2adj"][0]
                           if spec.get("co2adj") else -1)
            frac = spec.get("frac")
            if frac is not None:
                name = f"b{b}_fracref{frac}"
                d[D_FRAC] = 1 if len(layout[name][1]) == 1 else 2
                d[D_FOFF] = layout[name][0]
    T[_PACK_KEY] = (flat, torch.as_tensor(meta, device=flat.device), layout)
    return T[_PACK_KEY]


def _even_stride(shape, strides):
    """The element stride s with which the value at flat index n over
    ``shape`` lies n * s elements from the first, given the dimensions'
    ``strides``, or None where there is none."""
    dims = [(n, st) for n, st in zip(shape, strides) if n != 1]
    if not dims:
        return 1
    step = expect = dims[-1][1]
    for n, st in reversed(dims):
        if st != expect:
            return None
        expect = st * n
    return step


def _planes(kernel: str, name: str, x: torch.Tensor, lead: Tuple[int, ...],
            device, keep: List[torch.Tensor]):
    """(pointers, element stride) of the planes of ``x`` [*lead, *rest], in
    C order over rest; ``x`` is copied (and kept in ``keep``) only if its
    planes are not evenly strided over the points."""
    if tuple(x.shape[:len(lead)]) != lead:
        raise ValueError(f"{kernel} kernel: {name} has shape "
                         f"{tuple(x.shape)}, the points {lead}")
    if x.device != device:
        raise ValueError(f"{kernel} kernel: {name} is on {x.device}, the "
                         f"tables on {device}")
    rest = tuple(x.shape[len(lead):])
    step = _even_stride(lead, x.stride()[:len(lead)])
    if step is None:
        x = x.contiguous()
        keep.append(x)
        step = _even_stride(lead, x.stride()[:len(lead)])
    base, size = x.data_ptr(), x.element_size()
    inner = x.stride()[len(lead):]
    return [base + size * sum(i * st for i, st in zip(idx, inner))
            for idx in itertools.product(*map(range, rest))], step


def pack_planes(c: Dict, colamt, coldry, colbrd, wx, tauaer,
                flat: torch.Tensor) -> Tuple[Planes, List[torch.Tensor]]:
    """The per-point values of ``lw.taumol_lw``'s arguments as a
    :class:`Planes` struct: each plane where the caller holds it
    (``colamt``, ``wx``, ``tauaer`` and ``c["rfrate"]`` in their
    [C, L, k] layouts), float planes in ``flat``'s dtype, index planes
    int32, int64 or bool, all over ``coldry``'s shape on ``flat``'s
    device.  Returns ``(struct, keep)``: ``keep`` holds the copies the
    struct points into (of planes not evenly strided), which must live
    until the launch is done."""
    kernel = "taumol_lw"
    lead = tuple(coldry.shape)
    # the float planes' sources, in FLOAT_PLANES' order
    floats = ([(k, c[k]) for k in FLOAT_PLANES[:12]]
              + [("rfrate", c["rfrate"]), ("colamt", colamt),
                 ("coldry", coldry), ("colbrd", colbrd), ("wx", wx),
                 ("tauaer", tauaer)])
    keep = []
    f, fs = [], []
    for name, x in floats:
        if x.dtype != flat.dtype:
            raise TypeError(f"{kernel} kernel: plane {name} is {x.dtype}, "
                            f"the tables {flat.dtype}")
        ptrs, step = _planes(kernel, name, x, lead, flat.device, keep)
        f += ptrs
        fs += [step] * len(ptrs)
    if len(f) != len(FLOAT_PLANES):
        raise ValueError(f"{kernel} kernel: {len(f)} float planes, not "
                         f"{len(FLOAT_PLANES)}")
    i, istride, iw = [], [], []
    for name in INT_PLANES:
        x = c[name]
        if x.dtype not in _INDEX_WIDTH:
            raise TypeError(f"{kernel} kernel: index plane {name} is "
                            f"{x.dtype}, not int32, int64 or bool")
        (ptr,), step = _planes(kernel, name, x, lead, flat.device, keep)
        i.append(ptr)
        istride.append(step)
        iw.append(_INDEX_WIDTH[x.dtype])
    return Planes(tuple(f), tuple(i), tuple(fs), tuple(istride),
                  tuple(iw)), keep


def taumol_lw_launch(planes: Planes, flat: torch.Tensor, meta: torch.Tensor,
                     lead: Tuple[int, ...]) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """K2 on the point planes of :func:`pack_planes` (N = prod(lead)
    points) and the tables of :func:`pack_tables`, contiguous on one CUDA
    device.  Returns ``(fracs, tautot)``, each ``lead + (140,)``."""
    global TAUMOL_LAUNCHES
    kernel = "taumol_lw"
    if flat.dtype not in _SUFFIX:
        raise TypeError(f"{kernel} kernel takes float32 or float64 tables, "
                        f"got {flat.dtype}")
    check_tensor(kernel, "tables", flat, flat.shape, flat.dtype, flat.device)
    check_tensor(kernel, "table description", meta, meta.shape, torch.int32,
                 flat.device)
    fracs = torch.empty(tuple(lead) + (P.NGPT_LW,), dtype=flat.dtype,
                        device=flat.device)
    tautot = torch.empty_like(fracs)
    N = math.prod(lead)
    if N == 0:
        return fracs, tautot
    fn = getattr(_library(), f"fv3_taumol_lw_{_SUFFIX[flat.dtype]}")
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = fn(planes, flat.data_ptr(), meta.data_ptr(), fracs.data_ptr(),
                 tautot.data_ptr(), N, float(P.ONEMINUS), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")
    TAUMOL_LAUNCHES += 1
    return fracs, tautot


def taumol_lw_cuda(c: Dict, colamt, coldry, colbrd, wx, tauaer,
                   T: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: ``(fracs, tautot)``, each [C, L, 140], of ``lw.taumol_lw``'s
    arguments, all on one CUDA device in the tables' dtype (float32 or
    float64; index planes int32, int64 or bool)."""
    flat, meta, _ = pack_tables(T)
    planes, keep = pack_planes(c, colamt, coldry, colbrd, wx, tauaer, flat)
    return taumol_lw_launch(planes, flat, meta, tuple(coldry.shape))


def launch_plan(dtype: torch.dtype) -> dict:
    """How K2 launches on the current card in ``dtype``: a block's shared
    bytes, its threads and the blocks an SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    smem = ctypes.c_longlong()
    threads, per_sm = ctypes.c_int(), ctypes.c_int()
    err = _library().fv3_taumol_lw_plan(
        int(dtype == torch.float64), ctypes.byref(smem),
        ctypes.byref(threads), ctypes.byref(per_sm))
    if err != 0:
        raise RuntimeError(f"taumol_lw kernel plan failed: cudaError {err}")
    return {"smem_bytes": smem.value, "threads": threads.value,
            "blocks_per_sm": per_sm.value}
