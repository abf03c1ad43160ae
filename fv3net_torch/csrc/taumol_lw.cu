// RRTMG-LW gas optics of all 16 bands in one kernel (K2) for NVIDIA Hopper,
// sm_90a.
//
// Replaces fv3net_tpu/physics/radiation/rrtmg/pallas_taumol.py::
// taumol_lw_megakernel (the whole of lw.py::taumol_lw as one Pallas call
// over column blocks).  Its plain PyTorch statement is
// fv3net_torch/physics/radiation/rrtmg/lw.py::taumol_lw_plain: for every
// atmosphere point n of N = columns x layers,
//
//   tautot[n, g] = gas optical depth of g-point g + tauaer[n, band(g)]
//   fracs[n, g]  = Planck fraction of g-point g            g = 0 .. 139
//
// from ~60 per-point values (interpolation factors and indices of
// setcoef_lw, gas column amounts, aerosol optical depths) and the
// k-tables (about 147,000 values).
//
// It is a gather kernel.  The TPU kernel selected table rows with one-hot
// matrix products because it had no gather, padded the columns to whole
// blocks and kept every band's interpolation planes in VMEM; none of that
// is carried over.  Each point computes only its own atmosphere (lower:
// troposphere, upper: above it), where the plain version computes both
// and selects.
//
// Design.  A block owns a tile of 128 consecutive points and walks the 16
// bands.  Per band, phase 1 runs one thread per point: the species
// ratios, stencil positions and weights, gas-amount adjustments and
// pressure corrections of that band go into a small record in shared
// memory (the per-point rows and weights that all bands share are written
// once, before the loop).  Phase 2 runs the block's threads over
// (point, g) of the band: each reads its point's record, gathers the
// table values it names and writes tautot and fracs, ng consecutive
// values per point.  What each (band, atmosphere) sums is described by 24
// integers ("descriptor") that the wrapper builds beside the packed
// tables (taumol_cuda.py::pack_tables); phase 2 interprets them.
//
// What bounds it: memory traffic.  Per point it reads 60 values and writes
// 280; the tables (0.6 MB in float32) stay in L2/L1 and are read through
// the read-only cache.  Arithmetic is ~2,000 flops per point.
//
// The source is compiled without fused multiply-adds (-fmad=false), so
// the integer parts of the species parameters, which pick table rows, are
// those of the plain version's separate multiply and add.
//
// Everything but the kernel and its launcher is plain C++ (FV3_DEV,
// FV3_LDG), so a host program can include this file and run load_point,
// common_point, band_point and eval_point in loops; the tests do that
// with g++ -ffp-contract=off to hold phase 1 and phase 2 against the
// plain version where there is no card.

#include <math.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FV3_DEV __device__ __forceinline__
#define FV3_LDG(p) __ldg(p)
#else
#define FV3_DEV inline
#define FV3_LDG(p) (*(p))
#endif

namespace {

constexpr int kP = 128;      // points per tile (threads per block)
constexpr int kBands = 16;
constexpr int kG = 140;      // g-points of all bands
constexpr int kNI = 19;      // temperature rows of the minor-gas tables

// float planes [kNF, N] and integer planes [kNI_PLANES, N] of the points
enum {
  F_FAC00 = 0, F_FAC01, F_FAC10, F_FAC11, F_PAVEL, F_SCALEMINOR,
  F_SCALEMINORN2, F_SELFFAC, F_SELFFRAC, F_FORFAC, F_FORFRAC, F_MINORFRAC,
  F_RFRATE = 12,   // 6 rates x 2 pressure paths
  F_COLAMT = 24,   // h2o co2 o3 n2o ch4 o2 co
  F_COLDRY = 31, F_COLBRD = 32,
  F_WX = 33,       // ccl4 cfc11 cfc12 cfc22
  F_TAUAER = 37,   // 16 bands
};
enum { I_JP = 0, I_JT, I_JT1, I_INDSELF, I_INDFOR, I_INDMINOR, I_TROPO };

// meta: integer description of the packed tables
enum {
  M_NG = 0, M_NS = 16, M_SELF = 32, M_FOR, M_CHI, M_REFRAT, M_NBASE_LO,
  M_NBASE_HI, M_DESC = 40,
};
// descriptor of one (band, atmosphere)
enum {
  D_MAJOR = 0,  // 0 none, 1 the point's base rows, 2 rows 0 and 1
  D_MOFF, D_MROW, D_MPOS,
  D_SELF, D_FOR,
  D_NMINOR, D_MINOR = 7,  // 3 x (kind 1 linear / 2 bilinear, offset, row length)
  D_NHALO = 16, D_HALO = 17,  // 2 x (wx index, offset)
  D_CO2ADJ = 21,  // offset or -1
  D_FRAC = 22,    // 0 zero, 1 vector, 2 rows interpolated over the species
  D_FOFF = 23,
  kDesc = 24,
};
// reference amount ratios at fixed levels (taumol_cuda.py::REFRAT)
enum {
  R_B3_PLA = 0, R_B3_PLB, R_B3_MA, R_B3_MB, R_B4_PLA, R_B4_PLB, R_B5_PLA,
  R_B5_PLB, R_B5_MA, R_B7_A, R_B9_PLA, R_B9_MA, R_B12_PLA, R_B13_PLA,
  R_B13_MA, R_B13_MA3, R_B15_A, R_B16_PLA,
};

template <typename T>
struct Point {
  T fac00, fac01, fac10, fac11, pavel, scaleminor, scaleminorn2, minorfrac;
  T rf[12];
  T col[7];
  T coldry, colbrd;
  int jp;
};

// what every band of a point shares
template <typename T>
struct Common {
  T fac[4];    // path 0: fac00, fac10; path 1: fac01, fac11
  T selfw[2], forw[2], m1w[2];
  T mf;        // minorfrac
  int row[4];  // base rows of the two paths in the point's atmosphere
  int selfi[2], fori[2], m1i[2];
  int imc;     // clamp(indminor - 1, 0, 17)
  int upper;   // 0 troposphere, 1 above it
};

// one band of a point
template <typename T>
struct BandRec {
  T sw[6];      // stencil weights times the path's scale, path-major
  T mscale[3];  // minor-gas column factors
  T mfm[2];     // bilinear minors' species weight
  T corr;       // pressure correction (1 where the band has none)
  T fpl;        // Planck-fraction weight
  int pos[6];   // stencil positions
  int mbase[2]; // bilinear minors' base row, jmc * 19 + imc
  int fj[2];    // Planck-fraction rows
  int ns;       // stencil points per path (0: no major species)
};

FV3_DEV int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// truncation toward zero; NaN gives 0, as the card's conversion does
template <typename T>
FV3_DEV int trunc_int(T x) {
  return (x == x) ? (int)x : 0;
}

// floored remainder of x by 1 (torch.remainder(x, 1.0))
template <typename T>
FV3_DEV T frac1(T x) {
  T m = fmod(x, T(1));
  if (m != T(0) && m < T(0)) m += T(1);
  return m;
}

// min(x, hi) that keeps NaN (Tensor.clamp(max=hi))
template <typename T>
FV3_DEV T clamp_max(T x, T hi) {
  return (x > hi) ? hi : x;
}

template <typename T>
struct Spec {
  T comb, parm, fs;
  int js;  // 1-based
};

// lw.py::_spec
template <typename T>
FV3_DEV Spec<T> spec(T a, T b, T rate, T mult, T om) {
  Spec<T> s;
  s.comb = a + rate * b;
  s.parm = a / s.comb;
  const T sm = mult * clamp_max(s.parm, om);
  s.js = 1 + trunc_int(sm);
  s.fs = frac1(sm);
  return s;
}

// lw.py::_stencil3_terms, with its where(... == 0) forms, times the
// path's scale
template <typename T>
FV3_DEV void stencil3(const Spec<T>& s, BandRec<T>& r, int path) {
  const bool lo = s.parm < T(0.125);
  const bool hi = s.parm > T(0.875);
  const bool edge = lo || hi;
  const T zero = T(0), one = T(1);
  const T fs = s.fs;
  T p = (lo ? fs - one : zero) + (hi ? -fs : zero);
  if (p == zero) p = zero;
  const T pp4 = pow(p, T(4));
  T p4 = edge ? pp4 : zero;
  if (p4 == zero) p4 = zero;
  T fk0 = (lo ? p4 : zero) + (hi ? pp4 : zero);
  if (fk0 == zero) fk0 = one - fs;
  T fk1 = edge ? (one - p - T(2) * p4) : zero;
  if (fk1 == zero) fk1 = fs;
  T fk2 = edge ? (p + p4) : zero;
  if (fk2 == zero) fk2 = zero;
  const int j = s.js - 1;
  const int d0 = hi ? 1 : 0;
  const int o = path * 3;
  r.pos[o] = clampi(j + d0, 0, 8);
  r.pos[o + 1] = clampi(j + 1 - d0, 0, 8);
  r.pos[o + 2] = clampi(j + (hi ? -1 : 2), 0, 8);
  r.sw[o] = s.comb * fk0;
  r.sw[o + 1] = s.comb * fk1;
  r.sw[o + 2] = s.comb * fk2;
}

// lw.py::_stencil2_terms (5 upper species rows), times the path's scale
template <typename T>
FV3_DEV void stencil2(const Spec<T>& s, BandRec<T>& r, int path) {
  const int j = s.js - 1;
  const int o = path * 3;
  r.pos[o] = clampi(j, 0, 4);
  r.pos[o + 1] = clampi(j + 1, 0, 4);
  r.sw[o] = s.comb * (T(1) - s.fs);
  r.sw[o + 1] = s.comb * s.fs;
}

// the gas-amount adjustments: the column where its ratio to the reference
// amount is at most `thresh`, else (add + (ratio - add) ** expo) * ref
template <typename T>
FV3_DEV T adjust(T col, T ref, T thresh, T add, T expo) {
  const T rat = col / ref;
  return (rat > thresh) ? (add + pow(rat - add, expo)) * ref : col;
}

template <typename T>
FV3_DEV void load_point(const T* __restrict__ fp, const int* __restrict__ ip,
                        long long N, long long n, Point<T>& p) {
  p.fac00 = FV3_LDG(fp + F_FAC00 * N + n);
  p.fac01 = FV3_LDG(fp + F_FAC01 * N + n);
  p.fac10 = FV3_LDG(fp + F_FAC10 * N + n);
  p.fac11 = FV3_LDG(fp + F_FAC11 * N + n);
  p.pavel = FV3_LDG(fp + F_PAVEL * N + n);
  p.scaleminor = FV3_LDG(fp + F_SCALEMINOR * N + n);
  p.scaleminorn2 = FV3_LDG(fp + F_SCALEMINORN2 * N + n);
  p.minorfrac = FV3_LDG(fp + F_MINORFRAC * N + n);
  for (int k = 0; k < 12; ++k) p.rf[k] = FV3_LDG(fp + (F_RFRATE + k) * N + n);
  for (int k = 0; k < 7; ++k) p.col[k] = FV3_LDG(fp + (F_COLAMT + k) * N + n);
  p.coldry = FV3_LDG(fp + F_COLDRY * N + n);
  p.colbrd = FV3_LDG(fp + F_COLBRD * N + n);
  p.jp = FV3_LDG(ip + I_JP * N + n);
}

// the rows and weights every band of the point shares (lw.py:411-438)
template <typename T>
FV3_DEV void common_point(const T* __restrict__ fp, const int* __restrict__ ip,
                          const int* __restrict__ meta, long long N,
                          long long n, const Point<T>& p, Common<T>& c) {
  const int jt = FV3_LDG(ip + I_JT * N + n);
  const int jt1 = FV3_LDG(ip + I_JT1 * N + n);
  const int upper = FV3_LDG(ip + I_TROPO * N + n) ? 0 : 1;
  c.upper = upper;
  c.fac[0] = p.fac00;
  c.fac[1] = p.fac10;
  c.fac[2] = p.fac01;
  c.fac[3] = p.fac11;
  int b0, b1, top;
  if (upper) {
    b0 = (p.jp - 13) * 5 + (jt - 1);
    b1 = (p.jp - 12) * 5 + (jt1 - 1);
    top = FV3_LDG(meta + M_NBASE_HI) - 1;
  } else {
    b0 = (p.jp - 1) * 5 + (jt - 1);
    b1 = p.jp * 5 + (jt1 - 1);
    top = FV3_LDG(meta + M_NBASE_LO) - 1;
  }
  c.row[0] = clampi(b0, 0, top);
  c.row[1] = clampi(b0 + 1, 0, top);
  c.row[2] = clampi(b1, 0, top);
  c.row[3] = clampi(b1 + 1, 0, top);
  const int inds = FV3_LDG(ip + I_INDSELF * N + n) - 1;
  const T sfac = FV3_LDG(fp + F_SELFFAC * N + n);
  const T sfrac = FV3_LDG(fp + F_SELFFRAC * N + n);
  c.selfi[0] = clampi(inds, 0, 9);
  c.selfi[1] = clampi(inds + 1, 0, 9);
  c.selfw[0] = sfac * (T(1) - sfrac);
  c.selfw[1] = sfac * sfrac;
  const int indf = FV3_LDG(ip + I_INDFOR * N + n) - 1;
  const T ffac = FV3_LDG(fp + F_FORFAC * N + n);
  const T ffrac = FV3_LDG(fp + F_FORFRAC * N + n);
  c.fori[0] = clampi(indf, 0, 3);
  c.fori[1] = clampi(indf + 1, 0, 3);
  c.forw[0] = ffac * (T(1) - ffrac);
  c.forw[1] = ffac * ffrac;
  const int im = FV3_LDG(ip + I_INDMINOR * N + n) - 1;
  c.m1i[0] = clampi(im, 0, kNI - 1);
  c.m1i[1] = clampi(im + 1, 0, kNI - 1);
  c.m1w[0] = T(1) - p.minorfrac;
  c.m1w[1] = p.minorfrac;
  c.mf = p.minorfrac;
  c.imc = clampi(im, 0, kNI - 2);
}

// phase 1: band b of one point in its atmosphere (lw.py:472-753)
template <typename T>
FV3_DEV void band_point(int b, const Point<T>& p, const Common<T>& c,
                        const T* __restrict__ tab,
                        const int* __restrict__ meta, T om, BandRec<T>& r) {
  const T* refrat = tab + FV3_LDG(meta + M_REFRAT);
  // chi_mls rows [59, 7]; the 1-based jp is used as a 0-based row
  const T* chi_jp = tab + FV3_LDG(meta + M_CHI) + clampi(p.jp, 0, 58) * 7;
  const T* chi_jp1 = tab + FV3_LDG(meta + M_CHI) + clampi(p.jp + 1, 0, 58) * 7;
  const T h2o = p.col[0], co2 = p.col[1], o3 = p.col[2], n2o = p.col[3],
          ch4 = p.col[4];
  const bool up = c.upper != 0;
  const T one = T(1);

  r.ns = 0;
  r.corr = one;
  r.fpl = T(0);
  r.fj[0] = r.fj[1] = 0;
  r.mbase[0] = r.mbase[1] = 0;
  r.mfm[0] = r.mfm[1] = T(0);
  r.mscale[0] = r.mscale[1] = r.mscale[2] = T(0);
  for (int k = 0; k < 6; ++k) {
    r.pos[k] = 0;
    r.sw[k] = T(0);
  }

  // species-interpolated major gases: rate m of the lower (9 rows, 3-point
  // stencil) or upper (5 rows, 2-point stencil) atmosphere
  auto lower_pair = [&](T a, T bb, int m) {
    stencil3(spec(a, bb, p.rf[2 * m], T(8), om), r, 0);
    stencil3(spec(a, bb, p.rf[2 * m + 1], T(8), om), r, 1);
    r.ns = 3;
  };
  auto upper_pair = [&](T a, T bb, int m) {
    stencil2(spec(a, bb, p.rf[2 * m], T(4), om), r, 0);
    stencil2(spec(a, bb, p.rf[2 * m + 1], T(4), om), r, 1);
    r.ns = 2;
  };
  auto single = [&](T col) {
    r.ns = 1;
    r.sw[0] = r.sw[3] = col;
  };
  // lw.py::_jpl: the Planck-fraction rows over the species parameter
  auto planck = [&](T a, T bb, int ref, T mult, int rows) {
    const T sm =
        mult * clamp_max(a / (a + FV3_LDG(refrat + ref) * bb), om);
    const int j = trunc_int(sm);
    r.fpl = frac1(sm);
    r.fj[0] = clampi(j, 0, rows - 1);
    r.fj[1] = clampi(j + 1, 0, rows - 1);
  };
  // lw.py::_minor2's species rows (nj of them) and weight
  auto bilinear = [&](int k, T a, T bb, int ref, T mult, int nj) {
    const T sm =
        mult * clamp_max(a / (a + FV3_LDG(refrat + ref) * bb), om);
    r.mfm[k] = frac1(sm);
    r.mbase[k] = clampi(trunc_int(sm), 0, nj - 2) * kNI + c.imc;
  };
  auto adjcoln2o = [&]() {
    return adjust(n2o, p.coldry * FV3_LDG(chi_jp + 3), T(1.5), T(0.5),
                  T(0.65));
  };

  switch (b) {
    case 0:  // band 1: h2o, minor n2
      single(h2o);
      r.mscale[0] = p.colbrd * p.scaleminorn2;
      if (up) {
        r.corr = one - T(0.15) * (p.pavel / T(95.6));
      } else if (p.pavel < T(250)) {
        r.corr = one - T(0.15) * (T(250) - p.pavel) / T(154.4);
      }
      break;
    case 1:  // band 2: h2o
      single(h2o);
      if (!up) r.corr = one - T(0.05) * (p.pavel - T(100)) / T(900);
      break;
    case 2:  // band 3: h2o + co2, minor n2o
      r.mscale[0] = adjcoln2o();
      if (up) {
        upper_pair(h2o, co2, 0);
        bilinear(0, h2o, co2, R_B3_MB, T(4), 5);
        planck(h2o, co2, R_B3_PLB, T(4), 5);
      } else {
        lower_pair(h2o, co2, 0);
        bilinear(0, h2o, co2, R_B3_MA, T(8), 9);
        planck(h2o, co2, R_B3_PLA, T(8), 9);
      }
      break;
    case 3:  // band 4: h2o + co2 / o3 + co2
      if (up) {
        upper_pair(o3, co2, 5);
        planck(o3, co2, R_B4_PLB, T(4), 5);
      } else {
        lower_pair(h2o, co2, 0);
        planck(h2o, co2, R_B4_PLA, T(8), 9);
      }
      break;
    case 4:  // band 5: h2o + co2 (minor o3) / o3 + co2; ccl4
      if (up) {
        upper_pair(o3, co2, 5);
        planck(o3, co2, R_B5_PLB, T(4), 5);
      } else {
        lower_pair(h2o, co2, 0);
        bilinear(0, h2o, co2, R_B5_MA, T(8), 9);
        r.mscale[0] = o3;
        planck(h2o, co2, R_B5_PLA, T(8), 9);
      }
      break;
    case 5:  // band 6: h2o (minor co2); cfc11, cfc12
      if (!up) {
        single(h2o);
        r.mscale[0] = adjust(co2, p.coldry * FV3_LDG(chi_jp1 + 1), T(3),
                             T(2), T(0.77));
      }
      break;
    case 6: {  // band 7: h2o + o3 (minor co2) / o3 (minor co2)
      const T ref = p.coldry * FV3_LDG(chi_jp + 1);
      if (up) {
        single(o3);
        r.mscale[0] = adjust(co2, ref, T(3), T(2), T(0.79));
      } else {
        lower_pair(h2o, o3, 1);
        bilinear(0, h2o, o3, R_B7_A, T(8), 9);
        r.mscale[0] = adjust(co2, ref, T(3), T(3), T(0.79));
        planck(h2o, o3, R_B7_A, T(8), 9);
      }
      break;
    }
    case 7: {  // band 8: h2o (minors co2, o3, n2o) / o3 (minors co2, n2o)
      const T adj = adjust(co2, p.coldry * FV3_LDG(chi_jp + 1), T(3), T(2),
                           T(0.65));
      r.mscale[0] = adj;
      if (up) {
        single(o3);
        r.mscale[1] = n2o;
      } else {
        single(h2o);
        r.mscale[1] = o3;
        r.mscale[2] = n2o;
      }
      break;
    }
    case 8:  // band 9: h2o + ch4 (minor n2o) / ch4 (minor n2o)
      r.mscale[0] = adjcoln2o();
      if (up) {
        single(ch4);
      } else {
        lower_pair(h2o, ch4, 3);
        bilinear(0, h2o, ch4, R_B9_MA, T(8), 9);
        planck(h2o, ch4, R_B9_PLA, T(8), 9);
      }
      break;
    case 9:  // band 10: h2o
      single(h2o);
      break;
    case 10:  // band 11: h2o, minor o2
      single(h2o);
      r.mscale[0] = p.col[5] * p.scaleminor;
      break;
    case 11:  // band 12: h2o + co2 / nothing
      if (!up) {
        lower_pair(h2o, co2, 0);
        // the Planck parameter is clamped before it is multiplied, with
        // >= (the reference's form of this band)
        T spk = h2o / (h2o + FV3_LDG(refrat + R_B12_PLA) * co2);
        if (spk >= om) spk = om;
        const T smk = T(8) * spk;
        const int j = trunc_int(smk);
        r.fpl = frac1(smk);
        r.fj[0] = clampi(j, 0, 8);
        r.fj[1] = clampi(j + 1, 0, 8);
      }
      break;
    case 12:  // band 13: h2o + n2o (minors co2, co) / minor o3
      if (up) {
        r.mscale[0] = o3;
      } else {
        lower_pair(h2o, n2o, 2);
        bilinear(0, h2o, n2o, R_B13_MA, T(8), 9);
        bilinear(1, h2o, n2o, R_B13_MA3, T(8), 9);
        r.mscale[0] = adjust(co2, p.coldry * T(3.55e-4), T(3), T(2),
                             T(0.68));
        r.mscale[1] = p.col[6];
        planck(h2o, n2o, R_B13_PLA, T(8), 9);
      }
      break;
    case 13:  // band 14: co2
      single(co2);
      break;
    case 14:  // band 15: n2o + co2 (minor n2) / nothing
      if (!up) {
        lower_pair(n2o, co2, 4);
        bilinear(0, n2o, co2, R_B15_A, T(8), 9);
        r.mscale[0] = p.colbrd * p.scaleminor;
        planck(n2o, co2, R_B15_A, T(8), 9);
      }
      break;
    default:  // band 16: h2o + ch4 / ch4 on the table's first two rows
      if (up) {
        single(ch4);
      } else {
        lower_pair(h2o, ch4, 3);
        planck(h2o, ch4, R_B16_PLA, T(8), 9);
      }
      break;
  }
}

// phase 2: g-point ig of band b at one point
template <typename T>
FV3_DEV void eval_point(int b, int ig, const Common<T>& c,
                        const BandRec<T>& r, const T* __restrict__ tab,
                        const int* __restrict__ meta,
                        const T* __restrict__ fp, long long N, long long n,
                        T& tau, T& frac) {
  const int* d = meta + M_DESC + (b * 2 + c.upper) * kDesc;
  const int g = FV3_LDG(meta + M_NS + b) + ig;
  T acc = T(0);

  const int major = FV3_LDG(d + D_MAJOR);
  if (major) {
    const T* t = tab + FV3_LDG(d + D_MOFF) + ig;
    const int rowlen = FV3_LDG(d + D_MROW);
    const int step = FV3_LDG(d + D_MPOS);
    for (int path = 0; path < 2; ++path) {
      const int ra = (major == 2) ? 0 : c.row[2 * path];
      const int rb = (major == 2) ? 1 : c.row[2 * path + 1];
      const T* ta = t + ra * rowlen;
      const T* tb = t + rb * rowlen;
      for (int s = 0; s < r.ns; ++s) {
        const int off = r.pos[path * 3 + s] * step;
        const T a = c.fac[2 * path] * FV3_LDG(ta + off) +
                    c.fac[2 * path + 1] * FV3_LDG(tb + off);
        acc = acc + r.sw[path * 3 + s] * a;
      }
    }
  }
  if (FV3_LDG(d + D_SELF)) {
    const T* t = tab + FV3_LDG(meta + M_SELF) + g;
    acc = acc + (c.selfw[0] * FV3_LDG(t + c.selfi[0] * kG) +
                 c.selfw[1] * FV3_LDG(t + c.selfi[1] * kG));
  }
  if (FV3_LDG(d + D_FOR)) {
    const T* t = tab + FV3_LDG(meta + M_FOR) + g;
    acc = acc + (c.forw[0] * FV3_LDG(t + c.fori[0] * kG) +
                 c.forw[1] * FV3_LDG(t + c.fori[1] * kG));
  }
  const int n_minor = FV3_LDG(d + D_NMINOR);
  int slot = 0;  // the band's bilinear minors, in order
  for (int k = 0; k < n_minor; ++k) {
    const int* m = d + D_MINOR + 3 * k;
    const T* t = tab + FV3_LDG(m + 1) + ig;
    const int rowlen = FV3_LDG(m + 2);
    T v;
    if (FV3_LDG(m) == 1) {
      v = c.m1w[0] * FV3_LDG(t + c.m1i[0] * rowlen) +
          c.m1w[1] * FV3_LDG(t + c.m1i[1] * rowlen);
    } else {
      const T fm = r.mfm[slot];
      const T fm1 = T(1) - fm;
      const T mf1 = T(1) - c.mf;
      const T* tb = t + r.mbase[slot] * rowlen;
      ++slot;
      v = (fm1 * mf1) * FV3_LDG(tb) + (fm * mf1) * FV3_LDG(tb + kNI * rowlen) +
          (fm1 * c.mf) * FV3_LDG(tb + rowlen) +
          (fm * c.mf) * FV3_LDG(tb + (kNI + 1) * rowlen);
    }
    acc = acc + r.mscale[k] * v;
  }
  const int n_halo = FV3_LDG(d + D_NHALO);
  if (n_halo) {
    T h = FV3_LDG(fp + (F_WX + FV3_LDG(d + D_HALO)) * N + n) *
          FV3_LDG(tab + FV3_LDG(d + D_HALO + 1) + ig);
    if (n_halo > 1) {
      h = h + FV3_LDG(fp + (F_WX + FV3_LDG(d + D_HALO + 2)) * N + n) *
                  FV3_LDG(tab + FV3_LDG(d + D_HALO + 3) + ig);
    }
    acc = acc + h;
  }
  acc = r.corr * acc;
  const int co2adj = FV3_LDG(d + D_CO2ADJ);
  if (co2adj >= 0) acc = acc * FV3_LDG(tab + co2adj + ig);
  tau = acc + FV3_LDG(fp + (F_TAUAER + b) * N + n);

  const int fkind = FV3_LDG(d + D_FRAC);
  const T* ft = tab + FV3_LDG(d + D_FOFF) + ig;
  if (fkind == 0) {
    frac = T(0);
  } else if (fkind == 1) {
    frac = FV3_LDG(ft);
  } else {
    const int ng = FV3_LDG(meta + M_NG + b);
    frac = (T(1) - r.fpl) * FV3_LDG(ft + r.fj[0] * ng) +
           r.fpl * FV3_LDG(ft + r.fj[1] * ng);
  }
}

#ifdef __CUDACC__

template <typename T>
__global__ void __launch_bounds__(kP)
taumol_lw_kernel(const T* __restrict__ fp, const int* __restrict__ ip,
                 const T* __restrict__ tab, const int* __restrict__ meta,
                 T* __restrict__ fracs, T* __restrict__ tautot, long long N,
                 T om) {
  __shared__ Common<T> sc[kP];
  __shared__ BandRec<T> sb[kP];
  const int tid = threadIdx.x;
  const long long n0 = (long long)blockIdx.x * kP;
  const long long n = n0 + tid;
  const bool live = n < N;
  const int np = (N - n0 < kP) ? (int)(N - n0) : kP;
  Point<T> pt;
  if (live) {
    load_point(fp, ip, N, n, pt);
    common_point(fp, ip, meta, N, n, pt, sc[tid]);
  }
  for (int b = 0; b < kBands; ++b) {
    __syncthreads();  // the previous band's readers are done
    if (live) band_point(b, pt, sc[tid], tab, meta, om, sb[tid]);
    __syncthreads();
    const int ng = __ldg(meta + M_NG + b);
    const int ns = __ldg(meta + M_NS + b);
    const int total = np * ng;
    for (int t = tid; t < total; t += kP) {
      const int q = t / ng;
      const int ig = t - q * ng;
      T tau, frac;
      eval_point(b, ig, sc[q], sb[q], tab, meta, fp, N, n0 + q, tau, frac);
      const long long o = (n0 + q) * kG + ns + ig;
      tautot[o] = tau;
      fracs[o] = frac;
    }
  }
}

template <typename T>
int launch_taumol(const void* fp, const void* ip, const void* tab,
                  const void* meta, void* fracs, void* tautot, long long N,
                  double oneminus, void* stream) {
  if (N == 0) return 0;
  const long long blocks = (N + kP - 1) / kP;
  if (N < 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  taumol_lw_kernel<T><<<(unsigned int)blocks, kP, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      (const T*)fp, (const int*)ip, (const T*)tab, (const int*)meta,
      (T*)fracs, (T*)tautot, N, (T)oneminus);
  return (int)cudaGetLastError();
}

#endif

}  // namespace

#ifdef __CUDACC__

extern "C" int fv3_taumol_lw_f32(const void* fp, const void* ip,
                                 const void* tab, const void* meta,
                                 void* fracs, void* tautot, long long N,
                                 double oneminus, void* stream) {
  return launch_taumol<float>(fp, ip, tab, meta, fracs, tautot, N, oneminus,
                              stream);
}

extern "C" int fv3_taumol_lw_f64(const void* fp, const void* ip,
                                 const void* tab, const void* meta,
                                 void* fracs, void* tautot, long long N,
                                 double oneminus, void* stream) {
  return launch_taumol<double>(fp, ip, tab, meta, fracs, tautot, N, oneminus,
                               stream);
}

#endif
