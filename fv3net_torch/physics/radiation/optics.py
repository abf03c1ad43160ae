"""Surface optics of the radiation (the ``surface_albedo`` and
``surface_emissivity`` of ``fv3net_tpu/physics/radiation/optics.py``, with
the band constants they read)."""
from __future__ import annotations

import numpy as np
import torch

# SW band edges of the band-model spectral data (cm-1), from
# fv3net_tpu/physics/radiation/params.py
WVN1_SW = np.array(
    [2600.0, 3250.0, 4000.0, 4650.0, 5150.0, 6150.0, 7700.0, 8050.0,
     12850.0, 16000.0, 22650.0, 29000.0, 38000.0, 820.0]
)
WVN2_SW = np.array(
    [3250.0, 4000.0, 4650.0, 5150.0, 6150.0, 7700.0, 8050.0, 12850.0,
     16000.0, 22650.0, 29000.0, 38000.0, 50000.0, 2600.0]
)
_SW_LAM_UM = 1.0e4 / np.sqrt(WVN1_SW * WVN2_SW)
_SW_IS_VIS = (_SW_LAM_UM < 0.7).astype(np.float64)  # [nbands_sw]


def surface_albedo(cosz, land_frac, ice_frac=None):
    """Per-band direct/diffuse albedo [ncol, nbands_sw] (reference:
    radiation_sfc.py setalb; ocean direct albedo after Briegleb 1992,
    bare sea-ice albedos on the icy part of the ocean fraction)."""
    # float32 whatever cosz's dtype: the reference forms the band albedos
    # (0.18 * is_vis + ...) from a float32 mask, so float64 runs carry
    # float32-rounded constants there too
    is_vis = torch.as_tensor(_SW_IS_VIS, dtype=torch.float32,
                             device=cosz.device)
    mu = cosz.clamp(min=0.01)
    ocean_dir = 0.026 / (mu ** 1.7 + 0.065) + 0.15 * (mu - 0.1) * (
        mu - 0.5
    ) * (mu - 1.0)
    ocean_dif = torch.full_like(cosz, 0.06)
    land_alb = 0.18 * is_vis + 0.30 * (1.0 - is_vis)  # [nb]
    if ice_frac is not None:
        ice_alb = 0.73 * is_vis + 0.33 * (1.0 - is_vis)
        fi = ice_frac[:, None]
        sea_dir = fi * ice_alb[None, :] + (1.0 - fi) * ocean_dir[:, None]
        sea_dif = fi * ice_alb[None, :] + (1.0 - fi) * ocean_dif[:, None]
    else:
        sea_dir = ocean_dir[:, None]
        sea_dif = ocean_dif[:, None]
    dir_alb = (land_frac[:, None] * land_alb[None, :]
               + (1.0 - land_frac)[:, None] * sea_dir)
    dif_alb = (land_frac[:, None] * land_alb[None, :]
               + (1.0 - land_frac)[:, None] * sea_dif)
    return dir_alb.clamp(0.0, 1.0), dif_alb.clamp(0.0, 1.0)


def surface_emissivity(land_frac):
    """Broadband LW emissivity (radiation_sfc.py setemis)."""
    return 0.97 * land_frac + 0.984 * (1.0 - land_frac)
