"""The GFS radiation-driver chain (port of
``fv3net_tpu/physics/radiation/gfs_driver.py``): batched over columns,
every stage of the reference port's
``RadiationDriver._GFS_radiation_driver`` (radiation_driver.py:380)
between the GFS state and the RRTMG solvers --

- the profile: pressures in mb, the bounded specific humidity (the
  QME5/QME6 walk), virtual temperature, interface temperatures by
  log-pressure interpolation; the tabulated saturation vapor pressure
  ``fpvs`` (funcphys.py:6) is here too, though the relative humidity the
  reference forms from it feeds no solver input;
- astronomy: the Julian-day ephemeris, equation of time, declination,
  the distance-adjusted solar constant and ``coszmn``'s mean cosine over
  the SW interval (radiation_astronomy.py:65-590);
- ``getgases`` (prescribed means), ``progcld4`` (the Zhao/Moorthi+GFDL
  cloud preparation), ``setalb`` (the ialbflg=0 climatological surface
  albedo) and ``setemis`` (the iemsflg=1 index-map emissivity with snow
  blending);

then the port's ``lwrad``/``swrad`` with the reference's lookup-table
transmittances (``fast_exp=False``, the reference solvers' default), so
that their k-table selections run K4 and K3 (their float64 instances at
the chain's default float64).  Aerosols ride as zeros (iaer=0).

Vertical convention: the GFS ``ivflip=1`` one, layer index 0 at the
surface.  The astronomy and the constants are host numpy, copied from
the reference module.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

# physical constants (NCEP physcons values, reference phys_const.py)
CON_PI = 3.1415926535897931
CON_G = 9.80665
CON_RD = 2.8705e2
CON_RV = 4.6150e2
CON_TTP = 2.7316e2
CON_T0C = 2.7315e2
CON_TICE = 2.7120e2
CON_PSAT = 6.1078e2
CON_CVAP = 1.8460e3
CON_CLIQ = 4.1855e3
CON_CSOL = 2.1060e3
CON_HVAP = 2.5000e6
CON_HFUS = 3.3358e5
CON_SOLR = 1.3608e3
CON_SOLR_OLD = 1.3660e3
CON_EPS = CON_RD / CON_RV
CON_EPSM1 = CON_RD / CON_RV - 1.0
CON_FVIRT = CON_RV / CON_RD - 1.0
CON_ROCP = CON_RD / 1.0046e3
CON_ROG = CON_RD / CON_G

QMIN = 1.0e-10
QME5 = 1.0e-7
QME6 = 1.0e-7

# getgases prescribed defaults (radiation_gases.py:10-26)
GAS_DEFAULTS = (
    350.0e-6,  # co2
    0.31e-6,   # n2o
    1.50e-6,   # ch4
    0.209,     # o2
    1.50e-8,   # co
    3.520e-10,  # cfc11
    6.358e-10,  # cfc12
    1.500e-10,  # cfc22
    1.397e-10,  # ccl4
    8.2000e-11,  # cfc113
)

# progcld4 defaults (radiation_clouds.py module constants)
RELIQ_DEF = 10.0
REICE_DEF = 50.0
RRAIN_DEF = 1000.0
RSNOW_DEF = 250.0
CLIMIT = 0.001
CLIMIT2 = 0.05
GFAC = 1.0e5 / CON_G
GORD = CON_G / CON_RD
# cloud-domain top pressures [4 domains x (low-lat, pole)] (ptopc)
PTOPC = np.array([[1050.0, 1050.0], [642.0, 750.0],
                  [350.0, 500.0], [150.0, 150.0]])

# setemis reference emissivities (radiation_sfc.py:410)
EMSREF = np.array([0.97, 0.95, 0.94, 0.90, 0.93, 0.96, 0.96, 0.99])


# ---------------------------------------------------------------------------
# saturation vapor pressure (funcphys fpvs: 7501-entry table + lerp)
# ---------------------------------------------------------------------------

_PVS_XMIN, _PVS_XMAX, _PVS_N = 180.0, 330.0, 7501


def _fpvsx(t: np.ndarray) -> np.ndarray:
    """Exact Clausius-Clapeyron saturation pressure with liquid/ice
    phases and a linear blend 20 K below the triple point."""
    tliq = CON_TTP
    tice = CON_TTP - 20.0
    dldtl = CON_CVAP - CON_CLIQ
    xponal = -dldtl / CON_RV
    xponbl = -dldtl / CON_RV + CON_HVAP / (CON_RV * CON_TTP)
    dldti = CON_CVAP - CON_CSOL
    heati = CON_HVAP + CON_HFUS
    xponai = -dldti / CON_RV
    xponbi = -dldti / CON_RV + heati / (CON_RV * CON_TTP)
    tr = CON_TTP / t
    pvl = CON_PSAT * (tr ** xponal) * np.exp(xponbl * (1.0 - tr))
    pvi = CON_PSAT * (tr ** xponai) * np.exp(xponbi * (1.0 - tr))
    w = (t - tice) / (tliq - tice)
    return np.where(t >= tliq, pvl,
                    np.where(t < tice, pvi, w * pvl + (1.0 - w) * pvi))


_TBPVS = _fpvsx(np.linspace(_PVS_XMIN, _PVS_XMAX, _PVS_N))




def fpvs(t):
    """Tabulated saturation vapor pressure [Pa] of a tensor of
    temperatures, linear interpolation, out-of-range temperatures clamped
    to the table's ends."""
    xinc = (_PVS_XMAX - _PVS_XMIN) / (_PVS_N - 1)
    c2 = 1.0 / xinc
    c1 = 1.0 - _PVS_XMIN * c2
    xj = (c1 + c2 * t).clamp(1.0, float(_PVS_N))
    j = xj.clamp(max=_PVS_N - 1).to(torch.int64)
    dtype = t.dtype if t.dtype == torch.float64 else torch.float32
    tb = torch.as_tensor(_TBPVS, dtype=dtype, device=t.device)
    return tb[j - 1] + (xj - j) * (tb[j] - tb[j - 1])


# ---------------------------------------------------------------------------
# astronomy (sol_update / solar / coszmn)
# ---------------------------------------------------------------------------


def julian_day(year: int, month: int, day: int) -> int:
    """NCEP iw3jdn Julian day number."""
    def d(a, b):  # integer division truncating toward zero
        q = abs(a) // abs(b)
        return q if (a >= 0) == (b >= 0) else -q

    return (
        day - 32075
        + d(1461 * (year + 4800 + d(month - 14, 12)), 4)
        + d(367 * (month - 2 - d(month - 14, 12) * 12), 12)
        - d(3 * d(year + 4900 + d(month - 14, 12), 100), 4)
    )


def solar_ephemeris(jd: int, fjd: float):
    """(r1, sollag, sindec, cosdec): earth-sun radius factor, equation
    of time [rad], and solar declination — the reference ``solar()``
    orbital-elements computation (radiation_astronomy.py:360-477)."""
    cyear = 365.25
    ccr = 1.3e-6
    tpp = 1.55
    jdor = 2415020
    tpi = 2.0 * CON_PI

    t1 = float(jd - jdor) / 36525.0
    year = 0.25964134 + 0.304e-5 * t1
    tyear = 0.24219879 - 0.614e-5 * t1
    ec = 0.01675104 - (0.418e-4 + 0.126e-6 * t1) * t1
    angin = 23.452294 - (0.0130125 + 0.164e-5 * t1) * t1
    jdoe = int(jdor + (78.035 * cyear) / (year - tyear))
    deleqn = float(jdoe - jd) * (year - tyear) / cyear
    year = year + 365.0
    sni = np.sin(np.deg2rad(angin))
    tini = 1.0 / np.tan(np.deg2rad(angin))
    er = np.sqrt((1.0 + ec) / (1.0 - ec))
    qq = deleqn * tpi / year

    # true anomaly at equinox (Newton)
    e1, cd = 1.0, 1.0
    it = 0
    while cd > ccr and it <= 10:
        ep = e1 - (e1 - ec * np.sin(e1) - qq) / (1.0 - ec * np.cos(e1))
        cd = abs(e1 - ep)
        e1 = ep
        it += 1
    eq = 2.0 * np.arctan(er * np.tan(0.5 * e1))

    dat = float(jd - jdor) - tpp + fjd
    date = dat % year
    em = tpi * date / year
    e1, cr = 1.0, 1.0
    it = 0
    while cr > ccr and it <= 10:
        ep = e1 - (e1 - ec * np.sin(e1) - em) / (1.0 - ec * np.cos(e1))
        cr = abs(e1 - ep)
        e1 = ep
        it += 1
    w1 = 2.0 * np.arctan(er * np.tan(0.5 * e1))
    r1 = 1.0 - ec * np.cos(e1)
    sindec = sni * np.sin(w1 - eq)
    cosdec = np.sqrt(1.0 - sindec * sindec)
    dlt = np.arcsin(sindec)
    alp = np.arcsin(np.tan(dlt) * tini)
    if np.cos(w1 - eq) < 0.0:
        alp = CON_PI - alp
    if alp < 0.0:
        alp = alp + tpi
    sun = tpi * (date - deleqn) / year
    if sun < 0.0:
        sun += tpi
    sollag = sun - alp - 0.03255
    return r1, sollag, sindec, cosdec


@dataclasses.dataclass
class Astronomy:
    """radupdate's solar state (isolar=0: the fixed old solar constant)."""

    slag: float
    sdec: float
    cdec: float
    solcon: float
    anginc: float
    nstp: int

    @classmethod
    def update(cls, jdate, deltsw: float, deltim: float,
               solc0: float = CON_SOLR_OLD) -> "Astronomy":
        """sol_update (radiation_astronomy.py:65-239), isolar=0 path:
        jdate = (year, month, day, hour, minute, second)."""
        year, month, day, hour, minute, second = jdate
        jd1 = julian_day(year, month, day)
        if hour < 12:
            jd1 -= 1
            fjd1 = 0.5 + hour / 24.0 + minute / 1440.0 + second / 86400.0
        else:
            fjd1 = (hour - 12) / 24.0 + minute / 1440.0 + second / 86400.0
        fjd1 += jd1
        jd = int(fjd1)
        fjd = fjd1 - jd
        r1, sollag, sindec, cosdec = solar_ephemeris(jd, fjd)
        solcon = solc0 / (r1 * r1)
        nswr = max(1, int(round(deltsw / deltim)))
        dtswh = deltsw / 3600.0
        nstp = max(6, nswr)
        anginc = (CON_PI / 12.0) * dtswh / float(nstp)
        return cls(sollag, sindec, cosdec, solcon, anginc, nstp)

    def coszmn(self, xlon, sinlat, coslat, solhr: float):
        """Mean cos(zenith) over the SW interval (astronomy.py:534-590):
        (coszen, the daytime-only mean; coszdg, the whole interval's)."""
        solang = (CON_PI / 12.0) * (solhr - 12.0)
        czlimt = 0.0001
        total = torch.zeros_like(xlon)
        nsun = torch.zeros_like(xlon)
        for it in range(self.nstp):
            cns = solang + (it + 0.5) * self.anginc + self.slag
            coszn = self.sdec * sinlat + self.cdec * coslat * torch.cos(
                cns + xlon)
            total = total + coszn.clamp(min=0.0)
            nsun = nsun + (coszn > czlimt)
        coszdg = total / float(self.nstp)
        coszen = torch.where(nsun > 0, total / nsun.clamp(min=1), 0.0)
        return coszen, coszdg


# ---------------------------------------------------------------------------
# gases / clouds / surface
# ---------------------------------------------------------------------------


def getgases(shape, dtype=torch.float64, device=None) -> torch.Tensor:
    """[C, L, 10] prescribed gas vmrs (getgases, ico2flg=0)."""
    C, L = shape
    return torch.as_tensor(GAS_DEFAULTS, dtype=dtype, device=device).expand(
        C, L, 10)


def progcld4(plyr, tlyr, tvly, clw, cnvw, cldtot, xlat, slmsk, delp,
             lcnorm: bool = False):
    """[C, L, 9] cloud state for the solvers (radiation_clouds.py:693):
    (fraction, lwp, re_liq, iwp, re_ice, [rrp], re_rain, [rsp],
    re_snow).  ``cldtot`` is the GFDL cloud-amount tracer; ``clw`` the
    total condensate."""
    tem2d = ((CON_TTP - tlyr) * 0.05).clamp(0.0, 1.0)
    clwt = (clw + cnvw).clamp(min=0.0) * GFAC * delp
    cip = clwt * tem2d
    cwp = clwt - cip
    land = torch.round(slmsk) == 1
    rew = torch.where(land[:, None], 5.0 + 5.0 * tem2d, RELIQ_DEF)
    cloudy = cldtot >= CLIMIT
    cwp = torch.where(cloudy, cwp, 0.0)
    cip = torch.where(cloudy, cip, 0.0)
    if lcnorm:
        inv = 1.0 / cldtot.clamp(min=CLIMIT2)
        cwp = torch.where(cloudy, cwp * inv, cwp)
        cip = torch.where(cloudy, cip * inv, cip)
    # ice effective radius from the ice water content (Heymsfield and
    # McFarquhar bands)
    tem2 = tlyr - CON_TTP
    tem3 = GORD * cip * plyr / (delp * tvly)
    rei_raw = torch.where(
        tem2 < -50.0, (1250.0 / 9.917) * tem3 ** 0.109,
        torch.where(
            tem2 < -40.0, (1250.0 / 9.337) * tem3 ** 0.08,
            torch.where(
                tem2 < -30.0, (1250.0 / 9.208) * tem3 ** 0.055,
                (1250.0 / 9.387) * tem3 ** 0.031,
            ),
        ),
    )
    rei = torch.where(cip > 0.0, rei_raw.clamp(10.0, 150.0), REICE_DEF)
    zero = torch.zeros_like(plyr)
    return torch.stack([cldtot.to(plyr.dtype), cwp, rew, cip, rei, zero,
                        zero + RRAIN_DEF, zero, zero + RSNOW_DEF], dim=-1)


def setalb(slmsk, snowf, zorlf, coszf, tsknf, hprif, alvsf, alnsf,
           alvwf, alnwf, facsf, facwf, fice, tisfc):
    """[C, 4] surface albedo (nir-beam, nir-diff, vis-beam, vis-diff),
    the ialbflg=0 climatological scheme (radiation_sfc.py:141-237)."""
    asnow = 0.02 * snowf
    argh = (0.01 * zorlf).clamp(0.025, 0.50)
    hrgh = (1.0577 - 1.1538e-3 * hprif).clamp(0.20, 1.0)
    fsno0 = asnow / (argh + asnow) * hrgh
    sea = torch.round(slmsk) == 0
    ice = torch.round(slmsk) == 2
    fsno0 = torch.where(sea & (tsknf > CON_TICE), 0.0, fsno0)
    fsno1 = 1.0 - fsno0
    flnd0 = (facsf + facwf).clamp(max=1.0)
    fsea0 = (1.0 - flnd0).clamp(min=0.0)
    fsno = fsno0
    fsea = fsea0 * fsno1
    flnd = flnd0 * fsno1

    # diffuse sea albedo
    a1 = (tsknf - 271.1) ** 2
    asevd = torch.where(tsknf >= 271.5, 0.06,
                        torch.where(tsknf < 271.1, 0.70, 0.7 - 4.0 * a1))
    asend = torch.where(tsknf >= 271.5, 0.06,
                        torch.where(tsknf < 271.1, 0.65,
                                    0.65 - 3.6875 * a1))
    # diffuse snow albedo (ice points blend with open water)
    ffw = 1.0 - fice
    dtgd = (CON_TTP - tisfc).clamp(0.0, 5.0)
    b1 = torch.where(ffw < 1.0, 0.03 * dtgd, 0.0)
    b3 = 0.06 * ffw
    asnvd = torch.where(ice, (0.70 + b1) * fice + b3, 0.90)
    asnnd = torch.where(ice, (0.60 + b1) * fice + b3, 0.75)
    asevd = torch.where(ice, 0.70 * fice + b3, asevd)
    asend = torch.where(ice, 0.60 * fice + b3, asend)
    # direct snow albedo
    csnow = 0.5 * (3.0 / (1.0 + 4.0 * coszf) - 1.0)
    asnvb = torch.where(coszf < 0.5,
                        (asnvd + (1.0 - asnvd) * csnow).clamp(max=0.98),
                        asnvd)
    asnnb = torch.where(coszf < 0.5,
                        (asnnd + (1.0 - asnnd) * csnow).clamp(max=0.98),
                        asnnd)
    # direct sea albedo
    day = coszf > 0.0001
    rfcs = torch.where(day, 1.4 / (1.0 + 0.8 * coszf), 1.0)
    rfcw = torch.where(day, 1.1 / (1.0 + 0.2 * coszf), 1.0)
    warm = tsknf >= CON_T0C
    asevb_w = torch.maximum(
        asevd,
        0.026 / (coszf ** 1.7 + 0.065)
        + 0.15 * (coszf - 0.1) * (coszf - 0.5) * (coszf - 1.0),
    )
    asevb = torch.where(day & warm, asevb_w, asevd)
    asenb = torch.where(day & warm, asevb_w, asend)

    a1 = alvsf * facsf
    b1 = alvwf * facwf
    a2 = alnsf * facsf
    b2 = alnwf * facwf
    ab1bm = a1 * rfcs + b1 * rfcw
    ab2bm = a2 * rfcs + b2 * rfcw
    return torch.stack([
        ab2bm.clamp(max=0.99) * flnd + asenb * fsea + asnnb * fsno,
        (a2 + b2) * 0.96 * flnd + asend * fsea + asnnd * fsno,
        ab1bm.clamp(max=0.99) * flnd + asevb * fsea + asnvb * fsno,
        (a1 + b1) * 0.96 * flnd + asevd * fsea + asnvd * fsno,
    ], dim=-1)


def setemis(xlon, xlat, slmsk, snowf, zorlf, tsknf, hprif, idxems):
    """[C] LW surface emissivity, the iemsflg=1 index-map mode with
    snow-cover blending (radiation_sfc.py:361-485).  ``idxems``:
    [360, 180] surface-type index map (1 degree)."""
    sea = torch.round(slmsk) == 0
    ice = torch.round(slmsk) == 2
    rad2dg = 180.0 / CON_PI
    lon_deg = xlon * rad2dg
    lon_deg = torch.where(lon_deg < 0.0, lon_deg + 360.0, lon_deg)
    lat_deg = xlat * rad2dg
    # nearest 1-degree boxes: the reference scans for the first index
    # with |x - (i*dlt + dlt/2)| <= dlt/2, which resolves exact box
    # boundaries downward in longitude and upward in latitude index
    i2 = (torch.ceil(lon_deg).to(torch.int64) - 1).clamp(0, 359)
    j2 = torch.ceil(89.5 - lat_deg).to(torch.int64).clamp(0, 179)
    idx = idxems[i2, j2].clamp(min=2) - 1
    idx = torch.where(idx >= 6, 1, idx)
    emsref = torch.as_tensor(EMSREF, dtype=tsknf.dtype, device=tsknf.device)
    emis = emsref[idx]
    emis = torch.where(sea, EMSREF[0], torch.where(ice, EMSREF[6], emis))
    # snow blending from the snow depth (the ialbflg=0 path)
    asnow = 0.02 * snowf
    argh = (0.01 * zorlf).clamp(0.025, 0.50)
    hrgh = (1.0577 - 1.1538e-3 * hprif).clamp(0.20, 1.0)
    fsno0 = asnow / (argh + asnow) * hrgh
    fsno0 = torch.where(sea & (tsknf > 271.2), 0.0, fsno0)
    fsno0 = torch.where(snowf > 0.0, fsno0, 0.0)
    return emis * (1.0 - fsno0) + EMSREF[7] * fsno0


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GFSDriverConfig:
    """The flag subset of the reference driver this chain implements."""

    levs: int
    fhswr: float = 3600.0
    fhlwr: float = 3600.0
    lcnorm: bool = False
    solc0: float = CON_SOLR_OLD  # isolar=0


class GFSRadiationDriver:
    """The reference-shaped radiation driver over the port's RRTMG
    solvers, on ``device`` (the card unless the caller asks for the CPU)
    in ``dtype`` (float64, the reference's default).  ``impl`` picks the
    k-table selections' version (None: the CUDA kernels on a CUDA
    device).

    Call layout (GFS ivflip=1, layer 0 at the surface):
      statein: prsi [C, L+1] Pa, prsl [C, L] Pa, tgrs [C, L], qgrs
        [C, L, ntrac] (0 = sphum, and the GFDL five species and the cloud
        amount at the nt* indices)
      sfcprop: tsfc, slmsk, snowd, zorl, hprime, alvsf, alnsf, alvwf,
        alnwf, facsf, facwf, fice, tisfc (all [C])
      grid: xlon, xlat [C] (radians)
    and ``rand_lw`` [C, 140 L], ``rand_sw`` [C, 112 L], the McICA
    uniforms (the SW rows are taken by each daylit column's position
    among the daylit columns, as the reference's swrad packs them).
    """

    def __init__(self, cfg: GFSDriverConfig, lw_tables, sw_tables,
                 idxems, ntoz=1, ntcw=2, ntiw=3, ntrw=4, ntsw=5,
                 ntgl=6, ntclamt=7, dtype=torch.float64, device="cuda",
                 impl: str = None):
        from fv3net_torch.physics.radiation.rrtmg import lw as rlw
        from fv3net_torch.physics.radiation.rrtmg import sw as rsw

        self.cfg = cfg
        self.device = torch.empty(0, device=device).device
        self.dtype = dtype
        self.impl = impl
        self.Tlw = rlw.prep_lw_tables(lw_tables, dtype, self.device)
        self.Tsw = rsw.prep_sw_tables(sw_tables, dtype, self.device)
        self.idxems = torch.as_tensor(np.asarray(idxems, np.int64),
                                      device=self.device)
        self.nt = dict(ntoz=ntoz, ntcw=ntcw, ntiw=ntiw, ntrw=ntrw,
                       ntsw=ntsw, ntgl=ntgl, ntclamt=ntclamt)
        self.sol: Optional[Astronomy] = None

    def radupdate(self, jdate, deltim: float):
        self.sol = Astronomy.update(jdate, self.cfg.fhswr, deltim,
                                    solc0=self.cfg.solc0)
        return self.sol

    def __call__(self, statein: Dict, sfcprop: Dict, grid: Dict,
                 solhr: float, rand_lw, rand_sw) -> Dict:
        from fv3net_torch.physics.radiation.rrtmg import lw as rlw
        from fv3net_torch.physics.radiation.rrtmg import sw as rsw

        nt = self.nt

        def j(x):
            return torch.as_tensor(x, dtype=self.dtype, device=self.device)

        prsi, prsl = j(statein["prsi"]), j(statein["prsl"])
        tgrs, qgrs = j(statein["tgrs"]), j(statein["qgrs"])
        C, L = prsl.shape
        tskn = j(sfcprop["tsfc"])
        tsfg = tskn

        # the profile (driver.py:520-705, ivflip=1)
        plvl = prsi * 0.01
        plyr = prsl * 0.01
        tlyr = tgrs
        # (the reference's relative humidity from fpvs feeds no solver
        # input and is not formed here)
        tracer1 = qgrs[..., 1:].clamp(min=0.0)  # positive tracers
        olyr = tracer1[..., nt["ntoz"] - 1].clamp(min=QMIN)

        xlon, xlat = j(grid["xlon"]), j(grid["xlat"])
        coszen, coszdg = self.sol.coszmn(xlon, torch.sin(xlat),
                                         torch.cos(xlat), solhr)
        gasvmr = getgases((C, L), self.dtype, self.device)

        # the bounded qlyr walk from the top layer down (driver.py:683):
        # layer k takes max(floor, q), and the floor below it is
        # min(QME5, that value).  The floor starts at QME6 and, since
        # QME5 == QME6, stays there (max(QME6, q) >= QME5), so the walk
        # is max(QME6, q) on every layer, exactly
        qlyr = qgrs[..., 0].clamp(min=QME6)
        tvly = tgrs * (1.0 + CON_FVIRT * qlyr)
        delp = plvl[:, :-1] - plvl[:, 1:]

        # interface temperatures by log-p interpolation
        tem2da = torch.log(plyr)
        tem2db = torch.log(plvl.clamp(min=1.0e-6))
        tlvl_mid = tlyr[:, :-1] + (tlyr[:, 1:] - tlyr[:, :-1]) * (
            tem2db[:, 1:-1] - tem2da[:, :-1]
        ) / (tem2da[:, 1:] - tem2da[:, :-1])
        tlvl = torch.cat([tskn[:, None], tlvl_mid, tlyr[:, -1:]], dim=1)

        # GFDL-MP condensate and cloud amount (imp_physics=11,
        # lgfdlmprad=False: the sum of the five species)
        ccnd = (tracer1[..., nt["ntcw"] - 1] + tracer1[..., nt["ntrw"] - 1]
                + tracer1[..., nt["ntiw"] - 1] + tracer1[..., nt["ntsw"] - 1]
                + tracer1[..., nt["ntgl"] - 1])
        ccnd = torch.where(ccnd < 1.0e-12, 0.0, ccnd)
        cldcov = tracer1[..., nt["ntclamt"] - 1]
        cnvw = torch.zeros_like(ccnd)

        slmsk = j(sfcprop["slmsk"])
        clouds = progcld4(plyr, tlyr, tvly, ccnd, cnvw, cldcov, xlat,
                          slmsk, delp, lcnorm=self.cfg.lcnorm)
        zero_aer_sw = torch.zeros((C, L, 14, 3), dtype=self.dtype,
                                  device=self.device)
        zero_aer_lw = torch.zeros((C, L, 16, 3), dtype=self.dtype,
                                  device=self.device)

        sfcalb = setalb(
            slmsk, j(sfcprop["snowd"]), j(sfcprop["zorl"]), coszen, tskn,
            j(sfcprop["hprime"]), j(sfcprop["alvsf"]), j(sfcprop["alnsf"]),
            j(sfcprop["alvwf"]), j(sfcprop["alnwf"]), j(sfcprop["facsf"]),
            j(sfcprop["facwf"]), j(sfcprop["fice"]), j(sfcprop["tisfc"]),
        )
        sfalb = (0.5 * (sfcalb[:, 1] + sfcalb[:, 3])).clamp(min=0.01)

        # the reference's swrad packs the daylit columns and draws each
        # column's McICA uniforms by its compressed day position
        # (radsw_main.py:780); the rows are permuted so that column j
        # sees those draws
        day = coszen >= 0.0001
        pos = (torch.cumsum(day.to(torch.int64), 0) - 1).clamp(min=0)
        rand_sw_used = j(rand_sw).index_select(0, pos)
        sw = rsw.swrad(
            plyr, plvl, tlyr, tlvl, qlyr, olyr, gasvmr, clouds,
            zero_aer_sw, sfcalb, delp, coszen, self.sol.solcon,
            rand_sw_used, self.Tsw, fast_exp=False, compress_daylight=False,
            impl=self.impl,
        )
        semis = setemis(xlon, xlat, slmsk, j(sfcprop["snowd"]),
                        j(sfcprop["zorl"]), tsfg, j(sfcprop["hprime"]),
                        self.idxems)
        lw = rlw.lwrad(
            plyr, plvl, tlyr, tlvl, qlyr, olyr, gasvmr, clouds,
            zero_aer_lw, semis, tsfg, delp, j(rand_lw), self.Tlw,
            fast_exp=False, impl=self.impl,
        )
        return {
            "coszen": coszen,
            "coszdg": coszdg,
            "solcon": self.sol.solcon,
            "sfalb": sfalb,
            "sfcalb": sfcalb,
            "semis": semis,
            "clouds": clouds,
            "htrsw": sw["hswc"],
            "swhc": sw["hsw0"],
            "topfsw_upfxc": sw["ftoauc"],
            "topfsw_dnfxc": sw["ftoadc"],
            "topfsw_upfx0": sw["ftoau0"],
            "sfcfsw_upfxc": sw["fsfcuc"],
            "sfcfsw_dnfxc": sw["fsfcdc"],
            "sfcfsw_upfx0": sw["fsfcu0"],
            "sfcfsw_dnfx0": sw["fsfcd0"],
            "htrlw": lw["hlwc"],
            "lwhc": lw["hlw0"],
            "topflw_upfxc": lw["upfxc_t"],
            "topflw_upfx0": lw["upfx0_t"],
            "sfcflw_upfxc": lw["upfxc_s"],
            "sfcflw_upfx0": lw["upfx0_s"],
            "sfcflw_dnfxc": lw["dnfxc_s"],
            "sfcflw_dnfx0": lw["dnfx0_s"],
        }
