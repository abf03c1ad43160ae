"""Jacobians of trained models (port of ``fv3net_tpu/fit/jacobian.py``;
reference: external/fv3fit/fv3fit/keras/jacobian.py): per output and
input variable, the exact sensitivity matrix of the model around a base
state, one ``torch.func.jacrev`` of its pure apply."""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from fv3net_torch.fit import packer


def _pure_apply(model):
    """x [sample, in_features] -> [sample, out_features] as a function of
    x alone: a module's forward over its detached parameters, or a model's
    ``apply_packed(params, x)``."""
    if isinstance(model, torch.nn.Module):
        params = {k: v.detach() for k, v in model.named_parameters()}
        return lambda x: model.apply_params(params, x)
    return lambda x: model.apply_packed(model.params, x)


def compute_jacobians(model, base_state: Mapping[str, torch.Tensor]):
    """Exact Jacobians d(output)/d(input) at ``base_state``.

    Args:
        model: a DenseModel (or anything with ``apply_packed(params, x)``,
            ``params`` and ``output_info``)
        base_state: input variable -> [features] profile to linearize
            around (e.g. the training-data mean)

    Returns:
        {output_name: {input_name: [out_features, in_features] tensor}}
    """
    data = {k: torch.as_tensor(v)[None] for k, v in base_state.items()}
    X, x_info = packer.pack(data, model.input_variables)
    apply = _pure_apply(model)
    J = torch.func.jacrev(lambda x: apply(x[None])[0])(X[0])
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    in_slices = x_info.slices()
    for oname, osl in model.output_info.slices().items():
        out[oname] = {iname: J[osl, isl] for iname, isl in in_slices.items()}
    return out


def nondimensionalize_jacobians(jacobians,
                                stddevs: Mapping[str, torch.Tensor]):
    """Scale by input/output standard deviations (reference jacobian.py
    normalization) so entries are comparable across variables."""
    out = {}
    for oname, row in jacobians.items():
        out[oname] = {}
        for iname, J in row.items():
            sx = torch.as_tensor(stddevs[iname], device=J.device).reshape(
                1, -1)
            sy = torch.as_tensor(stddevs[oname], device=J.device).reshape(
                -1, 1)
            out[oname][iname] = J * sx / sy
    return out
