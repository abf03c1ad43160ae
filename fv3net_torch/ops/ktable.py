"""RRTMG k-table selections: the plain PyTorch versions and the
dispatchers (port of ``fv3net_tpu/ops/pallas_ktable.py``).

The gas optics fetch k-coefficients as small weighted sums of table rows
per atmosphere point.  :func:`weighted_select_dot` is the general form,
``sum_k w_k * tab[ids_k]`` (K4); :func:`spec_band_dot` is a band's
species-interpolated tau, a base-row selection per pressure path followed
by a species stencil (K3).  The plain versions are written as gathers
(``tab[ids]`` weighted and summed); the TPU's one-hot matrix products are
not carried over.

Tables may be float32, float64 or bfloat16.  A bfloat16 call (the RRTMG
bf16 storage mode) takes bfloat16 weights and sums in float32, in both
versions: the selection rounds its output to bfloat16 once; the band tau
rounds where the reference stores bfloat16 planes (each interpolated row
and each stencil product) and returns float32.

``impl`` picks the version: None takes the CUDA kernel
(:mod:`fv3net_torch.ops.ktable_cuda`) for a CUDA table and the plain
version for a CPU table; "cuda" or "torch" force one.  On a CUDA tensor
the kernel launches or raises; there is no fallback.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from fv3net_torch.ops import ktable_cuda

Term = Tuple[torch.Tensor, Optional[torch.Tensor]]


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype a selection sums in: float32 for bfloat16 tables."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _use_kernel(tab: torch.Tensor, impl: Optional[str]) -> bool:
    if impl is None:
        return tab.is_cuda
    if impl in ("cuda", "torch"):
        return impl == "cuda"
    raise ValueError(f"k-table impl must be None, 'cuda' or 'torch'; got "
                     f"{impl!r}")


def weighted_select_dot_plain(terms: Sequence[Term],
                              tab: torch.Tensor) -> torch.Tensor:
    """``sum_k w_k * tab[clamp(ids_k)]`` as gathers.

    terms: (ids, w) pairs of one leading shape [...]; ids integer, w of
    ``tab``'s dtype or None (weight 1).  tab [rows, G].  Returns
    [..., G] in ``tab``'s dtype."""
    rows = tab.shape[0]
    acc = _acc(tab.dtype)
    out = None
    for ids, w in terms:
        sel = tab[ids.long().clamp(0, rows - 1)].to(acc)
        term = sel if w is None else w.to(acc)[..., None] * sel
        out = term if out is None else out + term
    return out.to(tab.dtype)


def weighted_select_dot(terms: Sequence[Term], tab: torch.Tensor,
                        impl: Optional[str] = None) -> torch.Tensor:
    """``sum_k w_k * tab[ids_k]``: K4 on a CUDA table, else the plain
    version (see :func:`weighted_select_dot_plain`).  The kernel takes the
    terms as they are (see :func:`ktable_cuda.pack_terms`)."""
    if not _use_kernel(tab, impl):
        return weighted_select_dot_plain(terms, tab)
    return ktable_cuda.weighted_select_dot_cuda(terms, tab.contiguous())


def spec_band_dot_plain(w_paths: Sequence[List[Term]],
                        s_paths: Sequence[List[Term]],
                        tab_flat: torch.Tensor, nspa: int) -> torch.Tensor:
    """``sum_p sum_s sw * (sum_k ww * tab[row_k, pos_s])`` as gathers.

    w_paths: per path a list of (base row, weight) pairs; s_paths: per
    path a list of (stencil position, weight) pairs (scales folded in); a
    weight may be None (weight 1); tab_flat [nbase, nspa*ng].  Returns
    [..., ng].

    On a bfloat16 table each ``sum_k ww * tab`` and each product with
    ``sw`` is rounded to bfloat16 (the reference's stored interpolated row
    and stencil product) and the products are summed in float32, which is
    the dtype returned."""
    nbase = tab_flat.shape[0]
    ng = tab_flat.shape[1] // nspa
    acc = _acc(tab_flat.dtype)
    tab = tab_flat.reshape(nbase * nspa, ng)  # row index base*nspa + pos
    out = None
    for wp, sp in zip(w_paths, s_paths):
        rows = [(r.long().clamp(0, nbase - 1) * nspa,
                 None if ww is None else ww.to(acc)) for r, ww in wp]
        for pos, swt in sp:
            pos = pos.long().clamp(0, nspa - 1)
            a = None
            for r, ww in rows:
                sel = tab[r + pos].to(acc)
                term = sel if ww is None else ww[..., None] * sel
                a = term if a is None else a + term
            if acc != tab_flat.dtype:  # the stored row and product
                a = a.to(tab_flat.dtype).to(acc)
                if swt is not None:
                    a = (swt.to(acc)[..., None] * a).to(tab_flat.dtype)
                term = a.to(acc)
            else:
                term = a if swt is None else swt[..., None] * a
            out = term if out is None else out + term
    return out


def spec_band_dot(w_paths: Sequence[List[Term]],
                  s_paths: Sequence[List[Term]], tab_flat: torch.Tensor,
                  nspa: int, impl: Optional[str] = None) -> torch.Tensor:
    """A band's species-interpolated tau: K3 on a CUDA table, else the
    plain version (see :func:`spec_band_dot_plain`).  Every path has the
    same number of base pairs and of stencil pairs; the kernel takes the
    pairs as they are (see :func:`ktable_cuda.pack_spec_terms`)."""
    if not _use_kernel(tab_flat, impl):
        return spec_band_dot_plain(w_paths, s_paths, tab_flat, nspa)
    return ktable_cuda.spec_band_dot_cuda(w_paths, s_paths,
                                          tab_flat.contiguous(), nspa)
