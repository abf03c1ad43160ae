"""Run configuration (port of ``fv3net_tpu/runtime/config.py``).

So far only :class:`NamelistConfig`, a copy of the reference's with its
``__post_init__`` validation (the two must stay identical: a test holds
them alike); the rest of the run configuration comes with the segmented
run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class NamelistConfig:
    """Core model parameters (plays the Fortran namelist's role)."""

    npx: int = 48  # cells per tile side
    npz: int = 32  # vertical levels
    dt_atmos: float = 900.0
    n_split: int = 2
    kord: int = 9
    diff_coef: float = 0.004
    # horizontal transport operator: 1 upwind, 2 MUSCL, 4 PPM (hord)
    hord: int = 4
    # nondim del-2 divergence damping (FV3's d2_bg role)
    d2_div: float = 0.06
    # sponge-layer damping boost (divergence AND del-2 wind/Tv) for the
    # top two layers (fv_core_nml d2_bg_k1/d2_bg_k2).  ON by default:
    # multi-week coupled soaks over resolved topography break
    # stationary waves against the rigid model top (top-layer winds
    # 40 -> 260 m/s by day ~22, r5 soak_debug).  VALUES ARE
    # STABILITY-BOUNDED: the damping is explicit forward-Euler del-2,
    # stable only for coef*(corner distortion ~1.5) < 1/4 — 0.2 (the
    # fv3gfs default) blew up at a tile edge within 2 days here
    d2_bg_k1: float = 0.12
    d2_bg_k2: float = 0.06
    # stratospheric mean-preserving eddy damping (physics/driver.py
    # PhysicsConfig.strat_eddy_damp_*): relax T toward its per-level
    # global mean above this pressure with this timescale.  Stands in
    # for the radiative eddy damping the synthetic k-tables lack;
    # 0 days disables
    strat_eddy_damp_days: float = 1.0
    strat_eddy_damp_pa: float = 25000.0
    # energy-conserving vertical remap (FV3's te_map)
    remap_te: bool = True
    hydrostatic: bool = True
    # upper-level Rayleigh sponge (the fv3gfs-fortran fv_core_nml
    # ``tau``/``rf_cutoff`` pair): e-folding time in DAYS at the model
    # top (0 disables) and the pressure (Pa) below which no damping acts.
    # ON by default: without it the top layers develop unbounded winds
    # in multi-week coupled runs (C48 RRTMG soak blow-ups at days 21-28
    # traced to z=0-1 wind growth; tau=1 d to 30 hPa ran the 30-day
    # coupled soak green, docs/acceptance.md).  The deep cutoff reflects
    # this build's LOW model top (3 hPa): fv3gfs uses 750 Pa against
    # ~60 Pa tops, the same top few layers
    tau: float = 0.5
    # deepened r5: with a 3 hPa top the breaking level of polar-night
    # stationary waves sits at 10-150 hPa depending on where shallower
    # sponges end (soak_debug bisection); the log-p sin^2 ramp from
    # 200 hPa gives tau_eff ~90 d at 150 hPa (tropospheric jets
    # untouched), ~4 d at 50 hPa, ~1.4 d at 14 hPa
    # 300 hPa final (r5): the 200-hPa ramp arrested the 14-hPa breaking
    # but a momentum-flux-driven jet re-grew at ~150 hPa (+1.5 m/s/day,
    # NaN by day ~55 of the 90-day soak); the 300-hPa ramp (tau_eff
    # ~9 d at 150 hPa, ~125 d at 250 hPa) bounds it — 90-day soak
    # finite with wmax oscillating 60-90 m/s
    rf_cutoff: float = 30000.0
    # prognostic mixed-layer surface temperature (physics/slab_ocean.py)
    # instead of fixed aquaplanet SST
    slab_ocean: bool = False
    mixed_layer_depth_m: float = 50.0
    # prognostic o3mr tracer: transported by the dycore, relaxed toward
    # the climatology by linearized photochemistry (physics/ozone.py),
    # consumed by the band radiation
    prognostic_ozone: bool = False
    # bucket land hydrology (physics/land.py): prognostic soil moisture
    # limits land evaporation; runoff closes the land water budget.
    # Active where land_sea_mask > 0.5 (pair with slab_ocean for the
    # land surface-temperature side)
    bucket_land: bool = False
    bucket_capacity_m: float = 0.15
    # land surface model: "" (bucket_land flag decides), "bucket"
    # (Manabe bucket hydrology, physics/land.py) or "noah" (4-layer
    # Noah-style soil heat + Clapp-Hornberger soil water + prognostic
    # snowpack, physics/soil.py — the GFS Noah LSM role).  "noah"
    # requires slab_ocean (the land skin rides its thin-slab branch)
    land_model: str = ""
    # zero-layer thermodynamic sea ice on the slab ocean
    # (physics/sea_ice.py): freezing deficits grow ice, melting consumes
    # it before the mixed layer warms; ice fraction feeds the radiation
    # albedo.  Requires slab_ocean
    sea_ice: bool = False
    # surface boundary conditions from the catalog (or a registered
    # zarr): supplies land_sea_mask / surface_geopotential / sgh /
    # surface_temperature so configured runs need not be aquaplanets
    # (e.g. "topography/c48"; fields also loadable from restarts)
    surface_data: Optional[str] = None
    # device-mesh layout [py, px] for the intra-tile (y, x) spatial
    # decomposition (the fv_core_nml ``layout`` analog; the reference
    # runs 6*lx*ly MPI ranks — here py*px mesh devices shard all six
    # tiles' (y, x) axes, tile axis unsharded, SURVEY §2.9).  [1, 1]
    # = single device.  TimeLoop places its state on the mesh; every
    # jitted chunk then partitions via jax.sharding + the explicit
    # ppermute halo backend
    layout: Sequence[int] = (1, 1)
    # radiation scheme for the IN-LOOP physics step: "gray" (Frierson),
    # "rrtmg" (real RRTMG band solvers), "synthband" (compact band
    # model).  The GFS runs band radiation; gray is the cheap default
    # for idealized runs
    radiation: str = "gray"
    # surface-flux scheme: "monin_obukhov" (GFS sfc_diff-style stability
    # similarity) or "bulk" (constant-exchange aerodynamics)
    surface_scheme: str = "monin_obukhov"
    # PBL scheme: "kprofile" (Hong-Pan nonlocal-K, the GFS moninedmf
    # stage's structure) or "ramp" (prescribed sigma-profile K)
    pbl_scheme: str = "kprofile"
    # convection scheme: "betts_miller" (relaxed adjustment) or
    # "mass_flux" (SAS-family entraining plume, physics/convection_mf.py)
    convection: str = "betts_miller"
    # stratospheric methane-oxidation water source (the GFS h2o_phys
    # flag; physics/h2ophys.py).  Adds water mass by design — keep off
    # for exact-water-closure runs
    stratospheric_h2o: bool = False
    # large-scale microphysics: "zhao_carr" (two-stage gscond/precpd,
    # the scheme the reference's emulation hooks target) or "gfdl"
    # (six-category bulk scheme, physics/microphysics_gfdl.py; the
    # TimeLoop adds the ice_wat/rainwat/snowwat/graupel tracers to the
    # state when restarts do not carry them)
    microphysics: str = "zhao_carr"

    def __post_init__(self):
        if self.microphysics not in ("zhao_carr", "gfdl"):
            raise ValueError(
                f"unknown microphysics scheme {self.microphysics!r}"
            )
        if self.radiation not in ("gray", "rrtmg", "synthband"):
            raise ValueError(
                f"unknown radiation scheme {self.radiation!r}"
            )
        if self.surface_scheme not in ("monin_obukhov", "bulk"):
            raise ValueError(
                f"unknown surface scheme {self.surface_scheme!r}"
            )
        if self.pbl_scheme not in ("kprofile", "ramp"):
            raise ValueError(f"unknown pbl scheme {self.pbl_scheme!r}")
        if self.convection not in ("betts_miller", "mass_flux"):
            raise ValueError(
                f"unknown convection scheme {self.convection!r}"
            )
        if self.land_model == "" and self.bucket_land:
            self.land_model = "bucket"
        if self.land_model not in ("", "bucket", "noah"):
            raise ValueError(f"unknown land model {self.land_model!r}")
        if self.land_model == "bucket":
            self.bucket_land = True  # keep the legacy flag consistent
        if self.land_model == "noah" and not self.slab_ocean:
            raise ValueError(
                "land_model 'noah' requires slab_ocean (the land skin "
                "temperature rides its thin-slab land branch)"
            )
        if self.sea_ice and not self.slab_ocean:
            raise ValueError(
                "sea_ice requires slab_ocean (the ice exchanges latent "
                "heat with the mixed-layer energy budget)"
            )
