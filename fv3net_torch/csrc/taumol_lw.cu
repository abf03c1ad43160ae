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
// Design.  A block owns a tile of kP = 32 consecutive points and walks
// the 16 bands in groups of 8 (float32) or 4 (float64) bands, a warp a
// band.  Per group, phase 1 runs one thread per (point, band): the species
// ratios, stencil positions and weights, gas-amount adjustments and
// pressure corrections of that band go into a small record in shared
// memory (each point's values and the rows and weights that all bands
// share are loaded once, before the loop).  Phase 2 runs the block's
// threads over (band, point, g) of the group: each reads its point's
// record, gathers the table values it names and puts tautot and fracs in
// the tile's [kP, 140] rows in shared memory.  After the last group the
// tile's rows, one contiguous range of each output, go out as 16-byte
// stores.  What each (band, atmosphere) sums is described by 24 integers
// ("descriptor") that the wrapper builds beside the packed tables
// (taumol_cuda.py::pack_tables); phase 2 interprets them.  The
// descriptors and the point planes' pointers are read into shared memory
// once per block, and the blocks are persistent (as many as are resident,
// walking the tiles).  The planes come as the caller holds them: a
// pointer and an element stride each, the index planes int32, int64 or
// bool (taumol_cuda.py::pack_planes).  A float32 block has 512 threads
// and must fit 3 to an SM (its tile takes 71 KB of shared memory), which
// holds a thread to 40 registers; a float64 block 128 threads, 2 to an SM.
//
// What bounds it: memory traffic.  Per point it reads 53 values and 7
// indices and writes 280 values; the tables (0.4 MB in float32) stay in
// L2/L1 and are read through the read-only cache.  Arithmetic is ~2,000
// flops per point.  What holds it back is latency, in phase 1 as much as
// in phase 2: each output gathers 10-30 table values in a chain that
// starts from its point's record, and each band record is a chain of
// divisions, pow and fmod with its point's atmosphere diverging in the
// warp.  On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
// --kernel-times, float32, N = 442,368), running one phase twice added
// 1.2 ms (phase 1), 1.1 ms (phase 2), 0.17 ms (the point loads) and
// 0.07 ms (the stores) to a 1.78 ms launch, and the launch fell as the
// warps an SM holds grew: 12 warps 2.87 ms, 24 2.13, 36 1.89, 48 1.78
// (640 threads a block, 60 warps, spill registers and read 1.94).
//
// The bfloat16 instance (the RRTMG bf16 storage mode, T float) is the
// reference's megakernel under its bf16 storage: phase 1 as above, with
// the stencil weights kept apart from their path scales; phase 2
// (eval_point_bf16) reads the table rows the reference selects in
// bfloat16 from a bfloat16 copy of the tables, sums each selection in
// float32 and rounds it once (a software round to nearest even), and the
// tile's rows go out as bfloat16, 8 a 16-byte store.  It moves 0.35 GB per
// C48 call (outputs at 2 B a value) and, like the float32 instance, is
// held back by latency, not bytes: 2.70-2.79 ms a launch on an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py phase 18), 1.5x the float32
// instance, whose rounding work per g-point it repeats.
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
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FV3_DEV __device__ __forceinline__
#define FV3_LDG(p) __ldg(p)
#else
#define FV3_DEV inline
#define FV3_LDG(p) (*(p))
#endif

// The point planes as the wrapper packs them (taumol_cuda.py::Planes),
// passed by value: plane k's value at point n is f[k][n * fs[k]], in the
// compute type or (fw[k] == 2, the bfloat16 instance's aerosol taus)
// bfloat16; the index planes hold int32, int64 or bool (iw bytes).
constexpr int kFloatPlanes = 53;  // F_* below
constexpr int kIndexPlanes = 7;   // I_* below
struct Planes {
  const void* f[kFloatPlanes];
  const void* i[kIndexPlanes];
  long long fs[kFloatPlanes];
  long long is[kIndexPlanes];
  int iw[kIndexPlanes];
  int fw[kFloatPlanes];
};

namespace {

constexpr int kP = 32;       // points per tile
constexpr int kBands = 16;
constexpr int kG = 140;      // g-points of all bands
constexpr int kNI = 19;      // temperature rows of the minor-gas tables

// the float planes (F_*) and index planes (I_*) of the points
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
static_assert(F_TAUAER + kBands == kFloatPlanes, "float planes");
static_assert(I_TROPO + 1 == kIndexPlanes, "index planes");

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
constexpr int kMeta = M_DESC + 2 * kBands * kDesc;
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
  T sw[6];      // stencil weights times the path's scale, path-major (the
                // bfloat16 instance: the weights alone, rounded, by
                // ascending position)
  T sc[2];      // the bfloat16 instance: each path's scale
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

// bfloat16 <-> float as torch and XLA convert: a bfloat16 is the high half
// of a float, and a float rounds to the nearest bfloat16, ties to even
FV3_DEV float bf16_to_float(unsigned short h) {
  const unsigned int u = (unsigned int)h << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

FV3_DEV unsigned short float_to_bf16(float f) {
  unsigned int u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u)  // NaN: quiet, sign kept
    return (unsigned short)((u >> 16) | 0x40u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return (unsigned short)(u >> 16);
}

FV3_DEV float round_bf16(float f) { return bf16_to_float(float_to_bf16(f)); }

// the bfloat16 instance's stencil of one path, n points (lw.py::
// _tau_spec_mega): the weights rounded to bfloat16; a position met again
// takes the bfloat16 sum of its weights in the order the terms come (the
// later entry keeps weight 0); then the entries by ascending position, the
// order of the reference's float32 sum
template <typename T>
FV3_DEV void stencil_bf16(int n, int* pos, T* w) {
  for (int k = 0; k < n; ++k) w[k] = round_bf16(w[k]);
  for (int k = 1; k < n; ++k) {
    for (int m = 0; m < k; ++m) {
      if (pos[m] == pos[k] && w[k] != T(0)) {
        w[m] = round_bf16(w[m] + w[k]);
        w[k] = T(0);
      }
    }
  }
  for (int k = 1; k < n; ++k) {
    for (int m = k; m > 0 && pos[m - 1] > pos[m]; --m) {
      const int tp = pos[m];
      pos[m] = pos[m - 1];
      pos[m - 1] = tp;
      const T tw = w[m];
      w[m] = w[m - 1];
      w[m - 1] = tw;
    }
  }
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
// path's scale (H, the bfloat16 instance: see stencil_bf16)
template <typename T, bool H>
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
  if (H) {
    r.sw[o] = fk0;
    r.sw[o + 1] = fk1;
    r.sw[o + 2] = fk2;
    r.sc[path] = s.comb;
    stencil_bf16(3, r.pos + o, r.sw + o);
    return;
  }
  r.sw[o] = s.comb * fk0;
  r.sw[o + 1] = s.comb * fk1;
  r.sw[o + 2] = s.comb * fk2;
}

// lw.py::_stencil2_terms (5 upper species rows), times the path's scale
template <typename T, bool H>
FV3_DEV void stencil2(const Spec<T>& s, BandRec<T>& r, int path) {
  const int j = s.js - 1;
  const int o = path * 3;
  r.pos[o] = clampi(j, 0, 4);
  r.pos[o + 1] = clampi(j + 1, 0, 4);
  if (H) {
    r.sw[o] = T(1) - s.fs;
    r.sw[o + 1] = s.fs;
    r.sc[path] = s.comb;
    stencil_bf16(2, r.pos + o, r.sw + o);
    return;
  }
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

// float plane k at point n
template <typename T>
FV3_DEV T plane(const Planes& pl, int k, long long n) {
  const long long o = n * pl.fs[k];
  if (pl.fw[k] == 2)
    return (T)bf16_to_float(
        FV3_LDG(static_cast<const unsigned short*>(pl.f[k]) + o));
  return FV3_LDG(static_cast<const T*>(pl.f[k]) + o);
}

// index plane k at point n
FV3_DEV int index_plane(const Planes& pl, int k, long long n) {
  const long long o = n * pl.is[k];
  if (pl.iw[k] == 8)
    return (int)FV3_LDG(static_cast<const long long*>(pl.i[k]) + o);
  if (pl.iw[k] == 1)
    return (int)FV3_LDG(static_cast<const unsigned char*>(pl.i[k]) + o);
  return FV3_LDG(static_cast<const int*>(pl.i[k]) + o);
}

template <typename T>
FV3_DEV void load_point(const Planes& pl, long long n, Point<T>& p) {
  p.fac00 = plane<T>(pl, F_FAC00, n);
  p.fac01 = plane<T>(pl, F_FAC01, n);
  p.fac10 = plane<T>(pl, F_FAC10, n);
  p.fac11 = plane<T>(pl, F_FAC11, n);
  p.pavel = plane<T>(pl, F_PAVEL, n);
  p.scaleminor = plane<T>(pl, F_SCALEMINOR, n);
  p.scaleminorn2 = plane<T>(pl, F_SCALEMINORN2, n);
  p.minorfrac = plane<T>(pl, F_MINORFRAC, n);
  for (int k = 0; k < 12; ++k) p.rf[k] = plane<T>(pl, F_RFRATE + k, n);
  for (int k = 0; k < 7; ++k) p.col[k] = plane<T>(pl, F_COLAMT + k, n);
  p.coldry = plane<T>(pl, F_COLDRY, n);
  p.colbrd = plane<T>(pl, F_COLBRD, n);
  p.jp = index_plane(pl, I_JP, n);
}

// the rows and weights every band of the point shares (lw.py:411-438);
// meta: the table description, in device or shared memory
template <typename T>
FV3_DEV void common_point(const Planes& pl, const int* meta, long long n,
                          const Point<T>& p, Common<T>& c) {
  const int jt = index_plane(pl, I_JT, n);
  const int jt1 = index_plane(pl, I_JT1, n);
  const int upper = index_plane(pl, I_TROPO, n) ? 0 : 1;
  c.upper = upper;
  c.fac[0] = p.fac00;
  c.fac[1] = p.fac10;
  c.fac[2] = p.fac01;
  c.fac[3] = p.fac11;
  int b0, b1, top;
  if (upper) {
    b0 = (p.jp - 13) * 5 + (jt - 1);
    b1 = (p.jp - 12) * 5 + (jt1 - 1);
    top = meta[M_NBASE_HI] - 1;
  } else {
    b0 = (p.jp - 1) * 5 + (jt - 1);
    b1 = p.jp * 5 + (jt1 - 1);
    top = meta[M_NBASE_LO] - 1;
  }
  c.row[0] = clampi(b0, 0, top);
  c.row[1] = clampi(b0 + 1, 0, top);
  c.row[2] = clampi(b1, 0, top);
  c.row[3] = clampi(b1 + 1, 0, top);
  const int inds = index_plane(pl, I_INDSELF, n) - 1;
  const T sfac = plane<T>(pl, F_SELFFAC, n);
  const T sfrac = plane<T>(pl, F_SELFFRAC, n);
  c.selfi[0] = clampi(inds, 0, 9);
  c.selfi[1] = clampi(inds + 1, 0, 9);
  c.selfw[0] = sfac * (T(1) - sfrac);
  c.selfw[1] = sfac * sfrac;
  const int indf = index_plane(pl, I_INDFOR, n) - 1;
  const T ffac = plane<T>(pl, F_FORFAC, n);
  const T ffrac = plane<T>(pl, F_FORFRAC, n);
  c.fori[0] = clampi(indf, 0, 3);
  c.fori[1] = clampi(indf + 1, 0, 3);
  c.forw[0] = ffac * (T(1) - ffrac);
  c.forw[1] = ffac * ffrac;
  const int im = index_plane(pl, I_INDMINOR, n) - 1;
  c.m1i[0] = clampi(im, 0, kNI - 1);
  c.m1i[1] = clampi(im + 1, 0, kNI - 1);
  c.m1w[0] = T(1) - p.minorfrac;
  c.m1w[1] = p.minorfrac;
  c.mf = p.minorfrac;
  c.imc = clampi(im, 0, kNI - 2);
}

// phase 1: band b of one point in its atmosphere (lw.py:472-753); H, the
// bfloat16 instance, reads the reference amounts from the bfloat16 copy of
// the tables, tabh, and keeps the stencil weights apart from their scales
template <typename T, bool H = false>
FV3_DEV void band_point(int b, const Point<T>& p, const Common<T>& c,
                        const T* __restrict__ tab,
                        const unsigned short* __restrict__ tabh,
                        const int* meta, T om, BandRec<T>& r) {
  const T* refrat = tab + meta[M_REFRAT];
  // chi_mls rows [59, 7]; the 1-based jp is used as a 0-based row
  auto chi = [&](int row, int gas) -> T {
    const int i = meta[M_CHI] + clampi(row, 0, 58) * 7 + gas;
    return H ? (T)bf16_to_float(FV3_LDG(tabh + i)) : FV3_LDG(tab + i);
  };
  const T h2o = p.col[0], co2 = p.col[1], o3 = p.col[2], n2o = p.col[3],
          ch4 = p.col[4];
  const bool up = c.upper != 0;
  const T one = T(1);

  r.ns = 0;
  r.sc[0] = r.sc[1] = T(0);
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
    stencil3<T, H>(spec(a, bb, p.rf[2 * m], T(8), om), r, 0);
    stencil3<T, H>(spec(a, bb, p.rf[2 * m + 1], T(8), om), r, 1);
    r.ns = 3;
  };
  auto upper_pair = [&](T a, T bb, int m) {
    stencil2<T, H>(spec(a, bb, p.rf[2 * m], T(4), om), r, 0);
    stencil2<T, H>(spec(a, bb, p.rf[2 * m + 1], T(4), om), r, 1);
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
    return adjust(n2o, p.coldry * chi(p.jp, 3), T(1.5), T(0.5), T(0.65));
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
        r.mscale[0] = adjust(co2, p.coldry * chi(p.jp + 1, 1), T(3), T(2),
                             T(0.77));
      }
      break;
    case 6: {  // band 7: h2o + o3 (minor co2) / o3 (minor co2)
      const T ref = p.coldry * chi(p.jp, 1);
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
      const T adj = adjust(co2, p.coldry * chi(p.jp, 1), T(3), T(2),
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
                        const int* meta, const Planes& pl, long long n,
                        T& tau, T& frac) {
  const int* d = meta + M_DESC + (b * 2 + c.upper) * kDesc;
  const int g = meta[M_NS + b] + ig;
  T acc = T(0);

  const int major = d[D_MAJOR];
  if (major) {
    const T* t = tab + d[D_MOFF] + ig;
    const int rowlen = d[D_MROW];
    const int step = d[D_MPOS];
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
  if (d[D_SELF]) {
    const T* t = tab + meta[M_SELF] + g;
    acc = acc + (c.selfw[0] * FV3_LDG(t + c.selfi[0] * kG) +
                 c.selfw[1] * FV3_LDG(t + c.selfi[1] * kG));
  }
  if (d[D_FOR]) {
    const T* t = tab + meta[M_FOR] + g;
    acc = acc + (c.forw[0] * FV3_LDG(t + c.fori[0] * kG) +
                 c.forw[1] * FV3_LDG(t + c.fori[1] * kG));
  }
  const int n_minor = d[D_NMINOR];
  int slot = 0;  // the band's bilinear minors, in order
  for (int k = 0; k < n_minor; ++k) {
    const int* m = d + D_MINOR + 3 * k;
    const T* t = tab + m[1] + ig;
    const int rowlen = m[2];
    T v;
    if (m[0] == 1) {
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
  const int n_halo = d[D_NHALO];
  if (n_halo) {
    T h = plane<T>(pl, F_WX + d[D_HALO], n) *
          FV3_LDG(tab + d[D_HALO + 1] + ig);
    if (n_halo > 1) {
      h = h + plane<T>(pl, F_WX + d[D_HALO + 2], n) *
                  FV3_LDG(tab + d[D_HALO + 3] + ig);
    }
    acc = acc + h;
  }
  acc = r.corr * acc;
  const int co2adj = d[D_CO2ADJ];
  if (co2adj >= 0) acc = acc * FV3_LDG(tab + co2adj + ig);
  tau = acc + plane<T>(pl, F_TAUAER + b, n);

  const int fkind = d[D_FRAC];
  const T* ft = tab + d[D_FOFF] + ig;
  if (fkind == 0) {
    frac = T(0);
  } else if (fkind == 1) {
    frac = FV3_LDG(ft);
  } else {
    const int ng = meta[M_NG + b];
    frac = (T(1) - r.fpl) * FV3_LDG(ft + r.fj[0] * ng) +
           r.fpl * FV3_LDG(ft + r.fj[1] * ng);
  }
}

// phase 2 of the bfloat16 instance (lw.py::taumol_lw_plain under bfloat16
// storage, the reference's megakernel under its bf16 storage): the float32
// sums of eval_point, rounded to bfloat16 where the megakernel rounds.
// tabh is the bfloat16 copy of the tables: every table row the reference
// selects by a one-hot product is read there and each selection's float32
// sum (its products exact) is rounded once; the interpolated species rows
// are rounded before the stencil sums them; the constants it reads in
// float32 (halocarbons, co2adj, Planck vectors, band 16's two rows) come
// from tab.  Outputs are bfloat16 values held in floats.
FV3_DEV void eval_point_bf16(int b, int ig, const Common<float>& c,
                             const BandRec<float>& r,
                             const float* __restrict__ tab,
                             const unsigned short* __restrict__ tabh,
                             const int* meta, const Planes& pl, long long n,
                             float& tau, float& frac) {
  auto h = [&](int i) { return bf16_to_float(FV3_LDG(tabh + i)); };
  const int* d = meta + M_DESC + (b * 2 + c.upper) * kDesc;
  const int g = meta[M_NS + b] + ig;
  float acc = 0.0f;

  const int major = d[D_MAJOR];
  if (major == 2) {  // band 16 upper: rows 0 and 1 in float32
    const float* t = tab + d[D_MOFF] + ig;
    acc = r.sw[0] * ((c.fac[0] + c.fac[2]) * FV3_LDG(t) +
                     (c.fac[1] + c.fac[3]) * FV3_LDG(t + d[D_MROW]));
  } else if (major == 1 && r.ns == 1) {  // one selection of 4 rows
    const int t = d[D_MOFF] + ig;
    const int rowlen = d[D_MROW];
    float s4 = round_bf16(c.fac[0]) * h(t + c.row[0] * rowlen);
    for (int k = 1; k < 4; ++k)
      s4 = s4 + round_bf16(c.fac[k]) * h(t + c.row[k] * rowlen);
    acc = r.sw[0] * round_bf16(s4);
  } else if (major == 1) {  // species stencil of two pressure paths
    const int t = d[D_MOFF] + ig;
    const int rowlen = d[D_MROW];
    const int step = d[D_MPOS];
    for (int path = 0; path < 2; ++path) {
      const float wa = round_bf16(c.fac[2 * path]);
      const float wb = round_bf16(c.fac[2 * path + 1]);
      const int ta = t + c.row[2 * path] * rowlen;
      const int tb = t + c.row[2 * path + 1] * rowlen;
      float sum = 0.0f;
      for (int s = 0; s < r.ns; ++s) {
        const int off = r.pos[path * 3 + s] * step;
        const float a = round_bf16(wa * h(ta + off) + wb * h(tb + off));
        sum = sum + r.sw[path * 3 + s] * a;
      }
      const float term = r.sc[path] * sum;
      acc = path == 0 ? term : acc + term;
    }
  }
  if (d[D_SELF]) {
    const int t = meta[M_SELF] + g;
    acc = acc + round_bf16(round_bf16(c.selfw[0]) * h(t + c.selfi[0] * kG) +
                           round_bf16(c.selfw[1]) * h(t + c.selfi[1] * kG));
  }
  if (d[D_FOR]) {
    const int t = meta[M_FOR] + g;
    acc = acc + round_bf16(round_bf16(c.forw[0]) * h(t + c.fori[0] * kG) +
                           round_bf16(c.forw[1]) * h(t + c.fori[1] * kG));
  }
  const int n_minor = d[D_NMINOR];
  int slot = 0;
  for (int k = 0; k < n_minor; ++k) {
    const int* m = d + D_MINOR + 3 * k;
    const int t = m[1] + ig;
    const int rowlen = m[2];
    float v;
    if (m[0] == 1) {  // two rows fetched alone, lerped in float32
      const float h0 = h(t + c.m1i[0] * rowlen);
      const float h1 = h(t + c.m1i[1] * rowlen);
      v = h0 + c.mf * round_bf16(h1 - h0);
    } else {  // one selection of 4 rows, by ascending row
      const float fm = r.mfm[slot];
      const float fm1 = 1.0f - fm;
      const float mf1 = 1.0f - c.mf;
      const int tb = t + r.mbase[slot] * rowlen;
      ++slot;
      float sv = round_bf16(fm1 * mf1) * h(tb);
      sv = sv + round_bf16(fm1 * c.mf) * h(tb + rowlen);
      sv = sv + round_bf16(fm * mf1) * h(tb + kNI * rowlen);
      sv = sv + round_bf16(fm * c.mf) * h(tb + (kNI + 1) * rowlen);
      v = round_bf16(sv);
    }
    acc = acc + r.mscale[k] * v;
  }
  const int n_halo = d[D_NHALO];
  if (n_halo) {
    float hv = plane<float>(pl, F_WX + d[D_HALO], n) *
               FV3_LDG(tab + d[D_HALO + 1] + ig);
    if (n_halo > 1) {
      hv = hv + plane<float>(pl, F_WX + d[D_HALO + 2], n) *
                    FV3_LDG(tab + d[D_HALO + 3] + ig);
    }
    acc = acc + hv;
  }
  acc = r.corr * acc;
  const int co2adj = d[D_CO2ADJ];
  if (co2adj >= 0) acc = acc * FV3_LDG(tab + co2adj + ig);
  tau = round_bf16(acc + plane<float>(pl, F_TAUAER + b, n));

  const int fkind = d[D_FRAC];
  if (fkind == 0) {
    frac = 0.0f;
  } else if (fkind == 1) {
    frac = round_bf16(FV3_LDG(tab + d[D_FOFF] + ig));
  } else {
    const int ng = meta[M_NG + b];
    const int t = d[D_FOFF] + ig;
    const float h0 = h(t + r.fj[0] * ng);
    const float h1 = h(t + r.fj[1] * ng);
    frac = round_bf16(h0 + r.fpl * round_bf16(h1 - h0));
  }
}

#ifdef __CUDACC__

// a block's threads, and the bands a phase-1 round takes (a warp each)
template <typename T>
struct Shape {
  static constexpr int threads = sizeof(T) == 4 ? 512 : 128;
  static constexpr int group = sizeof(T) == 4 ? 8 : 4;
  // blocks an SM must hold: caps the registers a thread may use
  static constexpr int min_blocks = sizeof(T) == 4 ? 3 : 2;
};

// a block's shared memory: the tile's output rows, its points' values and
// records, the plane pointers and the table description
template <typename T>
struct Tile {
  T tau[kP * kG];
  T frac[kP * kG];
  Point<T> pt[kP];
  Common<T> c[kP];
  BandRec<T> rec[Shape<T>::group][kP];
  Planes planes;
  int meta[kMeta];
};

// H: the bfloat16 instance (T float, tabh the bfloat16 copy of the tables,
// bfloat16 outputs); else tabh is unused and the outputs are T
template <typename T, bool H>
__global__ void __launch_bounds__(Shape<T>::threads, Shape<T>::min_blocks)
taumol_lw_kernel(const Planes planes, const T* __restrict__ tab,
                 const unsigned short* __restrict__ tabh,
                 const int* __restrict__ meta, void* __restrict__ fracs,
                 void* __restrict__ tautot, long long N, T om) {
  constexpr int kGroup = Shape<T>::group;
  constexpr int kThreads = Shape<T>::threads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile<T>& s = *reinterpret_cast<Tile<T>*>(smem_raw);
  const int tid = threadIdx.x;
  for (int i = tid; i < kMeta; i += kThreads) s.meta[i] = __ldg(meta + i);
  if (tid == 0) s.planes = planes;
  const long long tiles = (N + kP - 1) / kP;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long n0 = tile * kP;
    const int np = (int)min((long long)kP, N - n0);
    __syncthreads();  // the last tile's rows are out
    if (tid < np) {
      load_point(s.planes, n0 + tid, s.pt[tid]);
      common_point(s.planes, s.meta, n0 + tid, s.pt[tid], s.c[tid]);
    }
    for (int b0 = 0; b0 < kBands; b0 += kGroup) {
      __syncthreads();  // the points are loaded; the last group is read
      const int q1 = tid % kP, slot1 = tid / kP;
      if (slot1 < kGroup && q1 < np)
        band_point<T, H>(b0 + slot1, s.pt[q1], s.c[q1], tab, tabh, s.meta,
                         om, s.rec[slot1][q1]);
      __syncthreads();
      // phase 2 over (band, point, g) of the group: band slot k's outputs
      // are [end[k-1], end[k])
      int end[kGroup];
      int e = 0;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        e += np * s.meta[M_NG + b0 + k];
        end[k] = e;
      }
      for (int t = tid; t < e; t += kThreads) {
        int slot = 0, first = 0;
#pragma unroll
        for (int k = 0; k < kGroup - 1; ++k) {
          if (t >= end[k]) {
            slot = k + 1;
            first = end[k];
          }
        }
        const int b = b0 + slot;
        const int ng = s.meta[M_NG + b];
        const int u = t - first;
        const int q = u / ng;
        const int ig = u - q * ng;
        const int o = q * kG + s.meta[M_NS + b] + ig;
        if constexpr (H) {
          eval_point_bf16(b, ig, s.c[q], s.rec[slot][q], tab, tabh, s.meta,
                          s.planes, n0 + q, s.tau[o], s.frac[o]);
        } else {
          eval_point(b, ig, s.c[q], s.rec[slot][q], tab, s.meta, s.planes,
                     n0 + q, s.tau[o], s.frac[o]);
        }
      }
    }
    __syncthreads();
    // the tile's rows are one contiguous range of each output
    if constexpr (H) {
      // 8 bfloat16 values a 16-byte store, then the odd tile's last 4
      const int n_el = np * kG;
      const int n_vec = n_el / 8;
      unsigned short* tau_o =
          static_cast<unsigned short*>(tautot) + n0 * kG;
      unsigned short* frac_o = static_cast<unsigned short*>(fracs) + n0 * kG;
      for (int v = tid; v < n_vec; v += kThreads) {
        unsigned short ht[8], hf[8];
        for (int k = 0; k < 8; ++k) {
          ht[k] = float_to_bf16(s.tau[8 * v + k]);
          hf[k] = float_to_bf16(s.frac[8 * v + k]);
        }
        float4 vt, vf;
        memcpy(&vt, ht, 16);
        memcpy(&vf, hf, 16);
        reinterpret_cast<float4*>(tau_o)[v] = vt;
        reinterpret_cast<float4*>(frac_o)[v] = vf;
      }
      for (int e = 8 * n_vec + tid; e < n_el; e += kThreads) {
        tau_o[e] = float_to_bf16(s.tau[e]);
        frac_o[e] = float_to_bf16(s.frac[e]);
      }
    } else {
      const int n_vec = np * kG * (int)sizeof(T) / 16;
      const float4* tau_v = reinterpret_cast<const float4*>(s.tau);
      const float4* frac_v = reinterpret_cast<const float4*>(s.frac);
      float4* tau_o = reinterpret_cast<float4*>(static_cast<T*>(tautot) +
                                                n0 * kG);
      float4* frac_o = reinterpret_cast<float4*>(static_cast<T*>(fracs) +
                                                 n0 * kG);
      for (int v = tid; v < n_vec; v += kThreads) {
        tau_o[v] = tau_v[v];
        frac_o[v] = frac_v[v];
      }
    }
  }
}

// blocks a SM holds of the kernel for (T, H), with its shared memory opted
// in
template <typename T, bool H>
int taumol_blocks_per_sm(int* per_sm) {
  const size_t smem = sizeof(Tile<T>);
  cudaError_t err = cudaFuncSetAttribute(
      taumol_lw_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, taumol_lw_kernel<T, H>, Shape<T>::threads, smem);
  if (err != cudaSuccess) return (int)err;
  return *per_sm < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

template <typename T, bool H>
int launch_taumol(Planes planes, const void* tab, const void* tabh,
                  const void* meta, void* fracs, void* tautot, long long N,
                  double oneminus, void* stream) {
  if (N == 0) return 0;
  // 16-byte stores of the tile rows
  if (N < 0 || ((size_t)fracs | (size_t)tautot) % 16)
    return (int)cudaErrorInvalidValue;
  if (H && tabh == nullptr) return (int)cudaErrorInvalidValue;
  int per_sm = 0, device = 0, sms = 0;
  int err = taumol_blocks_per_sm<T, H>(&per_sm);
  if (err != 0) return err;
  cudaError_t cerr;
  if ((cerr = cudaGetDevice(&device)) != cudaSuccess) return (int)cerr;
  cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (cerr != cudaSuccess) return (int)cerr;
  const long long tiles = (N + kP - 1) / kP;
  const long long resident = (long long)sms * per_sm;
  const unsigned int blocks =
      (unsigned int)(tiles < resident ? tiles : resident);
  taumol_lw_kernel<T, H><<<blocks, Shape<T>::threads, sizeof(Tile<T>),
                           static_cast<cudaStream_t>(stream)>>>(
      planes, (const T*)tab, (const unsigned short*)tabh, (const int*)meta,
      fracs, tautot, N, (T)oneminus);
  return (int)cudaGetLastError();
}

#endif

}  // namespace

#ifdef __CUDACC__

extern "C" int fv3_taumol_lw_f32(Planes planes, const void* tab,
                                 const void* meta, void* fracs, void* tautot,
                                 long long N, double oneminus, void* stream) {
  return launch_taumol<float, false>(planes, tab, nullptr, meta, fracs,
                                     tautot, N, oneminus, stream);
}

extern "C" int fv3_taumol_lw_f64(Planes planes, const void* tab,
                                 const void* meta, void* fracs, void* tautot,
                                 long long N, double oneminus, void* stream) {
  return launch_taumol<double, false>(planes, tab, nullptr, meta, fracs,
                                      tautot, N, oneminus, stream);
}

// the bfloat16 instance: tab the float32 tables, tabh their bfloat16 copy
// (the same layout), bfloat16 outputs
extern "C" int fv3_taumol_lw_bf16(Planes planes, const void* tab,
                                  const void* tabh, const void* meta,
                                  void* fracs, void* tautot, long long N,
                                  double oneminus, void* stream) {
  return launch_taumol<float, true>(planes, tab, tabh, meta, fracs, tautot,
                                    N, oneminus, stream);
}

// a block's shared bytes, threads and the blocks a SM holds of the kernel
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); kind 0 float32, 1
// float64, 2 bfloat16
extern "C" int fv3_taumol_lw_plan(int kind, long long* smem, int* threads,
                                  int* per_sm) {
  *smem = kind == 1 ? (long long)sizeof(Tile<double>)
                    : (long long)sizeof(Tile<float>);
  *threads = kind == 1 ? Shape<double>::threads : Shape<float>::threads;
  if (kind == 1) return taumol_blocks_per_sm<double, false>(per_sm);
  return kind == 2 ? taumol_blocks_per_sm<float, true>(per_sm)
                   : taumol_blocks_per_sm<float, false>(per_sm);
}

#endif
