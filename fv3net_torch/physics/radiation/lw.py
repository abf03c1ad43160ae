"""Longwave solver of the synthetic band model (port of
``fv3net_tpu/physics/radiation/lw.py``): no-scattering absorption and
emission with a Planck source linear in optical path and the 1.66
diffusivity angle.

G-points ride a batched axis [ncol, ngpt, nlay]; the downward and upward
transfers are loops over layers of elementwise steps on [ncol, ngpt]
slabs (the reference's two scans), and the spectral reduction is one
sum.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from fv3net_torch.core.constants import CP_AIR, GRAVITY
from fv3net_torch.physics.radiation import params as P


class LWFluxes(NamedTuple):
    up: torch.Tensor   # [ncol, nlev] spectrally integrated upward flux
    dn: torch.Tensor   # [ncol, nlev]
    htr: torch.Tensor  # [ncol, nlay] heating rate K/s


def _source_terms(e_near, e_far, x):
    """Exact flux source for Planck emission linear in optical path:
    integrating dF/dx = E(x) - F from the near to the far boundary gives
    F_far = F_near exp(-x) + E_far - E_near exp(-x) - dE w,
    w = (1 - exp(-x)) / x."""
    tr = torch.exp(-x)
    w = torch.where(x > 1e-5, (1.0 - tr) / x.clamp(min=1e-12),
                    1.0 - 0.5 * x)
    return tr, e_far - e_near * tr - (e_far - e_near) * w


def lw_transfer(tau, e_lev, e_lay, e_sfc, emis, dp):
    """Longwave fluxes for one sky condition.

    tau:   [ncol, ngpt, nlay] optical depth (gas [+ cloud * mask])
    e_lev: [ncol, ngpt, nlev] per-g-point Planck emissive power at levels
    e_lay: unused (the two-point linear source needs the levels only)
    e_sfc: [ncol, ngpt] surface emission, emis: [ncol] emissivity
    dp:    [ncol, nlay]
    """
    del e_lay
    x = (P.DIFFUSIVITY * tau).movedim(-1, 0)  # [nlay, ncol, ngpt]
    e_top = e_lev[..., :-1].movedim(-1, 0)
    e_bot = e_lev[..., 1:].movedim(-1, 0)
    nlay = x.shape[0]

    f = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    fdn = [f]
    for k in range(nlay):
        tr, src = _source_terms(e_top[k], e_bot[k], x[k])
        f = f * tr + src
        fdn.append(f)
    fdn = torch.stack(fdn)  # [nlev, ncol, ngpt]

    f = emis[:, None] * e_sfc + (1.0 - emis[:, None]) * fdn[-1]
    fup = [f]
    for k in reversed(range(nlay)):
        # upward: the near boundary is the layer's bottom, the far its top
        tr, src = _source_terms(e_bot[k], e_top[k], x[k])
        f = f * tr + src
        fup.append(f)
    fup = torch.stack(fup[::-1])

    up_tot = fup.sum(-1).movedim(0, -1)  # [ncol, nlev]
    dn_tot = fdn.sum(-1).movedim(0, -1)
    net_dn = dn_tot - up_tot
    htr = (net_dn[..., :-1] - net_dn[..., 1:]) * GRAVITY / (CP_AIR * dp)
    return LWFluxes(up_tot, dn_tot, htr)
