"""Spherical-harmonic roundtrip filtering of lat-lon fields (port of
``fv3net_tpu/ops/spherical.py``; reference:
external/xtorch_harmonics/xtorch_harmonics/xtorch_harmonics.py, a
roundtrip through a truncated spherical harmonic transform).

Longitude goes through ``torch.fft.rfft``/``irfft``; the latitude
(Legendre) transform is a product with normalized associated Legendre
functions.  The tables are built with numpy in float64, as the
reference builds them, and kept in float32 as the reference keeps them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _legendre_table(lmax: int, x: np.ndarray) -> np.ndarray:
    """Normalized associated Legendre P̄_l^m(x) for 0<=m<=l<=lmax.

    Returns [nlat, lmax+1, lmax+1] (l, m), fully-normalized so that the
    spherical harmonics are orthonormal over the sphere.
    Standard stable recursion (Press et al.).
    """
    nlat = x.shape[0]
    P = np.zeros((nlat, lmax + 1, lmax + 1))
    sx = np.sqrt(np.maximum(1.0 - x * x, 0.0))
    # P̄_m^m by recursion
    pmm = np.full(nlat, 1.0 / np.sqrt(4.0 * np.pi))
    P[:, 0, 0] = pmm
    for m in range(1, lmax + 1):
        pmm = -pmm * np.sqrt((2.0 * m + 1.0) / (2.0 * m)) * sx
        P[:, m, m] = pmm
    for m in range(lmax + 1):
        if m + 1 <= lmax:
            P[:, m + 1, m] = (
                x * np.sqrt(2.0 * m + 3.0) * P[:, m, m]
            )
        for l in range(m + 2, lmax + 1):
            a = np.sqrt(
                (4.0 * l * l - 1.0) / (l * l - m * m)
            )
            b = np.sqrt(
                ((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0)
            )
            P[:, l, m] = a * (x * P[:, l - 1, m] - b * P[:, l - 2, m])
    return P


def _lobatto_nodes(n: int):
    """Gauss-Lobatto-Legendre nodes (incl. the poles x=±1) and weights:
    interior nodes are the roots of P'_{n-1}; w_i = 2/(n(n-1) P_{n-1}²)."""
    if n < 2:
        raise ValueError("lobatto grid needs nlat >= 2")
    Pm1 = np.polynomial.legendre.Legendre.basis(n - 1)
    interior = Pm1.deriv().roots()
    x = np.concatenate([[-1.0], np.sort(interior), [1.0]])
    w = 2.0 / (n * (n - 1) * Pm1(x) ** 2)
    return x, w


def filter_tables(nlat: int, nlon: int, lmax: Optional[int] = None,
                  grid: str = "equiangular",
                  fraction_modes_kept: Optional[float] = None):
    """(lmax, x, P, G) of the filter, in float64 on the host: the rows'
    sin(latitude) ``x``, the synthesis table P [nlat, L, L] (l, m) and the
    analysis table G [L, L, nlat] (m, l, y), the weighted least-squares
    projection onto the synthesis basis (exact on the sampled grid)."""
    max_l = min(nlat - 1, nlon // 2 - 1)
    if fraction_modes_kept is not None:
        if lmax is not None:
            raise ValueError("pass lmax OR fraction_modes_kept, not both")
        lmax = max(0, int(round(fraction_modes_kept * max_l)))
    lmax = lmax if lmax is not None else max_l
    if grid == "equiangular":
        lat = (np.arange(nlat) + 0.5) / nlat * np.pi - np.pi / 2
        x = np.sin(lat)
        # cos(lat) integral weights over latitude cells
        edges = np.arange(nlat + 1) / nlat * np.pi - np.pi / 2
        w = np.sin(edges[1:]) - np.sin(edges[:-1])
    elif grid == "legendre-gauss":
        x, w = np.polynomial.legendre.leggauss(nlat)
    elif grid == "lobatto":
        x, w = _lobatto_nodes(nlat)
    else:
        raise ValueError(
            f"unknown grid {grid!r}: use 'equiangular', "
            "'legendre-gauss' or 'lobatto'"
        )
    P = _legendre_table(lmax, x)  # [nlat, L, M]
    L = lmax + 1
    # G_m = (A^T W A)^-1 A^T W per m
    G = np.zeros((L, L, nlat))  # [m, l, y]
    for m in range(L):
        A = P[:, m:, m]  # [nlat, L-m]
        AtW = (A * w[:, None]).T
        Gm = np.linalg.solve(AtW @ A, AtW)
        G[m, m:, :] = Gm
    return lmax, x, P, G


class RoundTripFilter(torch.nn.Module):
    """Truncate a lat-lon field at total wavenumber ``lmax`` by a forward
    and inverse spherical-harmonic transform.

    ``grid`` selects the latitude nodes and quadrature: 'equiangular'
    (``nlat`` midpoint rows from -90 to 90 deg), 'legendre-gauss' or
    'lobatto'; longitude has ``nlon`` uniform columns.
    ``fraction_modes_kept`` sets lmax as a fraction of the grid's largest
    resolvable wavenumber.  The float32 tables P and G are buffers on
    ``device``.
    """

    def __init__(self, nlat: int, nlon: int, lmax: Optional[int] = None,
                 grid: str = "equiangular",
                 fraction_modes_kept: Optional[float] = None,
                 device="cuda"):
        super().__init__()
        self.nlat = nlat
        self.nlon = nlon
        self.grid = grid
        self.lmax, self.x, P, G = filter_tables(
            nlat, nlon, lmax, grid, fraction_modes_kept)
        self.register_buffer("P", torch.as_tensor(P, dtype=torch.float32,
                                                  device=device))
        self.register_buffer("G", torch.as_tensor(G, dtype=torch.float32,
                                                  device=device))

    def forward(self, field: torch.Tensor) -> torch.Tensor:
        """field (..., nlat, nlon) -> filtered field, same shape."""
        nlon = self.nlon
        L = self.lmax + 1
        # longitude FFT: [..., nlat, M_full], truncated to m <= lmax
        F = torch.fft.rfft(field, dim=-1) / nlon
        F = F[..., :L]
        # forward Legendre: least-squares projection per zonal wavenumber
        alm = torch.einsum("...ym,mly->...lm", F, self.G.to(F.dtype))
        # inverse: F(lat, m) = sum_l a_lm P̄_lm(lat)
        F_back = torch.einsum("...lm,ylm->...ym", alm, self.P.to(F.dtype))
        # pad back to the full rfft length and inverse FFT
        pad = nlon // 2 + 1 - L
        F_full = torch.cat(
            [F_back, F_back.new_zeros(F_back.shape[:-1] + (pad,))], dim=-1)
        return torch.fft.irfft(F_full * nlon, n=nlon, dim=-1)


def roundtrip_filter(field, lmax: Optional[int] = None,
                     grid: str = "equiangular",
                     fraction_modes_kept: Optional[float] = None):
    """One-shot filtering of (..., nlat, nlon) on the field's device (the
    forward and inverse transforms share ``grid``)."""
    nlat, nlon = field.shape[-2:]
    return RoundTripFilter(
        nlat, nlon, lmax, grid=grid, fraction_modes_kept=fraction_modes_kept,
        device=field.device,
    )(field)
