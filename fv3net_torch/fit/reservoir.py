"""Reservoir computing (echo state networks), port of
``fv3net_tpu/fit/reservoir.py`` (reference: external/fv3fit/fv3fit/
reservoir/ — reservoir.py:33-108, the readout's ridge regression in
train.py:164, domain2.py:22-60, model.py:36,180, adapters.py:92,163).

The reservoir matrices are dense tensors built on the host from the
reference's ``np.random.RandomState(seed)`` draws, bit for bit; the
update is ``r' = (1 - a) r + a tanh(u @ W_in + r @ W)``, batched over
columns or subdomains.  As in the reference, the matrices, the reservoir
state and the training series are float32 whatever the run's dtype
(:data:`STATE_DTYPE`); a product of float32 and float64 operands runs in
float64, as the reference's type promotion does, so a float64 run's
state turns float64 at its first increment.

The trainers drive the reservoir through the series with one batched
input product over all times and a loop over time steps for the
recurrent product (the reference's ``jax.lax.scan``), then solve the
readout's ridge normal equations with ``torch.linalg.solve``, on the
device the training data lies on (on the CPU one system at a time).  The subdomain model updates all its
subdomains in one product pair and reads them out in one batched
einsum.  Its latent space (``transformer_path``, an io-registered
transformer of ``fit/transformers.py`` or ``fit/autoencoder.py``)
encodes the cube fields before the subdomains are cut and decodes the
merged predictions; the latents take the reference's promotions (a
float32 series encoded by float32 components stays float32, by float64
ones turns float64, and the state with it).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Tuple

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit import io
from fv3net_torch.fit.domain import CubeXYDivider
from fv3net_torch.fit.predictor import Predictor
from fv3net_torch.fit.train import register_training_function

#: the dtype of the reservoir matrices, its state and its training series
#: (the reference's float32, whatever the run's dtype)
STATE_DTYPE = torch.float32


@dataclasses.dataclass
class ReservoirHyperparameters:
    """(reference reservoir.py ReservoirHyperparameters)"""

    input_variables: List[str] = dataclasses.field(default_factory=list)
    output_variables: List[str] = dataclasses.field(default_factory=list)
    state_size: int = 500
    adjacency_matrix_sparsity: float = 0.9
    spectral_radius: float = 0.6
    input_coupling_sparsity: float = 0.5
    input_coupling_scaling: float = 0.1
    leakage: float = 0.5  # alpha: r' = (1-a) r + a tanh(...)
    l2_regularization: float = 1e-6
    n_burn: int = 10  # spinup steps discarded before fitting the readout
    seed: int = 0


def _power_iteration_spectral_radius(W: np.ndarray, iters: int = 60) -> float:
    rng = np.random.RandomState(0)
    v = rng.randn(W.shape[0])
    for _ in range(iters):
        v = W @ v
        v = v / (np.linalg.norm(v) + 1e-30)
    return float(np.linalg.norm(W @ v))


def build_reservoir_matrices(
    n_input: int, hp: ReservoirHyperparameters, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random sparse-patterned W_in [n_input, N] and W [N, N] scaled to the
    requested spectral radius, drawn on the host as the reference draws
    them and stored in :data:`STATE_DTYPE` on ``device``."""
    rng = np.random.RandomState(hp.seed)
    W_in = rng.uniform(-1, 1, (n_input, hp.state_size))
    W_in *= rng.rand(*W_in.shape) > hp.input_coupling_sparsity
    W_in *= hp.input_coupling_scaling

    W = rng.uniform(-1, 1, (hp.state_size, hp.state_size))
    W *= rng.rand(*W.shape) > hp.adjacency_matrix_sparsity
    rho = _power_iteration_spectral_radius(W)
    if rho > 0:
        W *= hp.spectral_radius / rho
    return (torch.tensor(W_in, dtype=STATE_DTYPE, device=device),
            torch.tensor(W, dtype=STATE_DTYPE, device=device))


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the wider of their dtypes (the reference's
    promotion)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.cat([a.to(dt), b.to(dt)], dim=-1)


def _update(r, pre, leakage: float):
    return (1.0 - leakage) * r + leakage * torch.tanh(pre)


def reservoir_increment(r, u, W_in, W, leakage: float):
    """Leaky tanh ESN update, batched over leading dims of r/u."""
    return _update(r, _mm(u, W_in) + _mm(r, W), leakage)


def _drive(r, u_in, W, leakage: float) -> torch.Tensor:
    """The states after each step of a series whose input products
    ``u_in`` [time, ..., N] (u @ W_in for every time at once) are given:
    [time, ..., N]."""
    states = []
    for t in range(u_in.shape[0]):
        r = _update(r, u_in[t] + _mm(r, W), leakage)
        states.append(r)
    return torch.stack(states)


class _Arrays:
    """Device and dtype moves of a model's arrays and state."""

    _ARRAYS = ("W_in", "W", "coefficients", "intercept", "state")

    def to(self, device=None, dtype=None):
        """The model on ``device``; with ``dtype``, its arrays in it (None
        keeps the reference's float32).  Returns the model."""
        for name in self._ARRAYS:
            setattr(self, name, getattr(self, name).to(device=device,
                                                       dtype=dtype))
        return self

    def _save(self, path: str) -> None:
        np.savez(
            os.path.join(path, "weights.npz"),
            **{k: getattr(self, k).detach().cpu().numpy()
               for k in ("W_in", "W", "coefficients", "intercept")})


@io.register("pure-reservoir")
class ReservoirComputingModel(_Arrays, Predictor):
    """ESN + linear readout predicting the next-step outputs
    (reference model.py:180).  Stateful across calls: ``increment`` then
    ``predict_from_state`` (the runtime steppers sequence this)."""

    def __init__(
        self,
        input_variables,
        output_variables,
        W_in,
        W,
        readout_coefficients,  # [state(+input), n_out]
        readout_intercept,
        hyperparameters: ReservoirHyperparameters,
        hybrid: bool = False,
    ):
        super().__init__(list(input_variables), list(output_variables))
        self.W_in = W_in
        self.W = W
        self.coefficients = readout_coefficients
        self.intercept = readout_intercept
        self.hp = hyperparameters
        self.hybrid = hybrid
        self.reset_state(batch_shape=())

    def reset_state(self, batch_shape=()) -> None:
        self.state = torch.zeros(tuple(batch_shape) + (self.hp.state_size,),
                                 dtype=STATE_DTYPE, device=self.W.device)

    def increment(self, u: torch.Tensor) -> None:
        self.state = reservoir_increment(
            self.state, u, self.W_in, self.W, self.hp.leakage
        )

    def _features(self, u):
        return _cat(self.state, u) if self.hybrid else self.state

    def predict_from_state(self, u: torch.Tensor) -> torch.Tensor:
        return _mm(self._features(u), self.coefficients) + self.intercept

    @torch.no_grad()
    def predict(self, X: Dataset) -> Dataset:
        """Stateless rollout over a (time, ..., feature) input series,
        returning next-step predictions (offline evaluation path)."""
        u = torch.as_tensor(X["inputs"].data, device=self.W.device)
        r = torch.zeros(tuple(u.shape[1:-1]) + (self.hp.state_size,),
                        dtype=STATE_DTYPE, device=u.device)
        preds = []
        for t in range(u.shape[0]):
            r = reservoir_increment(r, u[t], self.W_in, self.W,
                                    self.hp.leakage)
            feats = _cat(r, u[t]) if self.hybrid else r
            preds.append(_mm(feats, self.coefficients) + self.intercept)
        return Dataset({"outputs": Quantity(torch.stack(preds),
                                            X["inputs"].dims)})

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        self._save(path)
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(
                {
                    "input_variables": self.input_variables,
                    "output_variables": self.output_variables,
                    "hyperparameters": dataclasses.asdict(self.hp),
                    "hybrid": self.hybrid,
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "ReservoirComputingModel":
        """The model in ``path``, on the CPU in the saved dtype."""
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        z = np.load(os.path.join(path, "weights.npz"))
        return cls(
            meta["input_variables"],
            meta["output_variables"],
            torch.tensor(z["W_in"]),
            torch.tensor(z["W"]),
            torch.tensor(z["coefficients"]),
            torch.tensor(z["intercept"]),
            ReservoirHyperparameters(**meta["hyperparameters"]),
            hybrid=meta["hybrid"],
        )


@io.register("hybrid-reservoir")
class HybridReservoirComputingModel(ReservoirComputingModel):
    """Readout sees [reservoir state, current inputs]
    (reference model.py:36)."""


def _ridge_solve(F: torch.Tensor, Y: torch.Tensor, l2: float):
    """Closed-form ridge regression with intercept over the samples of
    F [..., sample, f] and Y [..., sample, out] (batched over leading
    dims)."""
    Fm = F.mean(dim=-2)
    Ym = Y.mean(dim=-2)
    Fc = F - Fm[..., None, :]
    Yc = Y - Ym[..., None, :]
    A = Fc.mT @ Fc + l2 * torch.eye(F.shape[-1], dtype=F.dtype,
                                    device=F.device)
    B = Fc.mT @ Yc
    coef = torch.linalg.solve(A, B)
    intercept = Ym - (Fm[..., None, :] @ coef)[..., 0, :]
    return coef, intercept


def _series(train_batches, key: str) -> List[torch.Tensor]:
    """Each batch's ``key`` series in :data:`STATE_DTYPE`, on its
    device."""
    return [torch.as_tensor(ds[key].data).to(STATE_DTYPE)
            for ds in train_batches]


@torch.no_grad()
def _train_reservoir(hp: ReservoirHyperparameters, train_batches, hybrid: bool):
    """Drive the reservoir through the training series, ridge-fit the
    readout on post-spinup states (reference reservoir/train.py:164)."""
    batches = list(train_batches)
    series = _series(batches, "inputs")
    targets = _series(batches, "outputs")
    device = series[0].device
    W_in, W = build_reservoir_matrices(series[0].shape[-1], hp, device)

    # each batch is an independent trajectory: reset the reservoir state
    # per segment and spin up (n_burn) per segment, so the readout never
    # fits states contaminated by a discontinuity
    feat_parts, y_parts = [], []
    r0 = torch.zeros((hp.state_size,), dtype=STATE_DTYPE, device=device)
    for u_seg, y_seg in zip(series, targets):
        states = _drive(r0, _mm(u_seg, W_in), W, hp.leakage)
        f = _cat(states, u_seg) if hybrid else states
        feat_parts.append(f[hp.n_burn:])
        y_parts.append(y_seg[hp.n_burn:])
    coef, intercept = _ridge_solve(
        torch.cat(feat_parts, dim=0),
        torch.cat(y_parts, dim=0),
        hp.l2_regularization,
    )
    cls = HybridReservoirComputingModel if hybrid else ReservoirComputingModel
    return cls(
        hp.input_variables or ["inputs"],
        hp.output_variables or ["outputs"],
        W_in,
        W,
        coef,
        intercept,
        hp,
        hybrid=hybrid,
    )


@register_training_function("reservoir", ReservoirHyperparameters)
def train_reservoir_model(hp, train_batches, val=None):
    return _train_reservoir(hp, train_batches, hybrid=False)


@register_training_function("hybrid_reservoir", ReservoirHyperparameters)
def train_hybrid_reservoir_model(hp, train_batches, val=None):
    return _train_reservoir(hp, train_batches, hybrid=True)


# ---------------------------------------------------------------------------
# The spatial (sub-rank subdomain) reservoir (reference fv3fit/reservoir
# adapters.py:92,163 + domain2.py RankXYDivider): each overlapping
# subdomain of the cube carries its own reservoir state and readout;
# W_in and W are shared.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SubdomainReservoirHyperparameters:
    """(reference reservoir/train.py ReservoirTrainingConfig subset); a
    ``reservoir`` given as a dict (a training config's yaml) becomes
    :class:`ReservoirHyperparameters`."""

    input_variables: List[str] = dataclasses.field(default_factory=list)
    output_variables: List[str] = dataclasses.field(default_factory=list)
    subdomain_layout: Tuple[int, int] = (2, 2)
    overlap: int = 1
    reservoir: ReservoirHyperparameters = dataclasses.field(
        default_factory=ReservoirHyperparameters
    )
    hybrid: bool = False
    # optional latent space: path to an io-registered transformer
    # (PCATransformer / Autoencoder / DoNothingAutoencoder): the ESN runs
    # on encoded features and predictions are decoded back
    transformer_path: str = ""

    def __post_init__(self):
        self.subdomain_layout = tuple(self.subdomain_layout)
        if isinstance(self.reservoir, dict):
            self.reservoir = ReservoirHyperparameters(**self.reservoir)


@io.register("subdomain-reservoir")
class SubdomainReservoirModel(_Arrays, Predictor):
    """Cube-spatial ESN: increment consumes [6, ny, nx, nf] fields; the
    overlap halo crosses tile edges via the cube halo append."""

    def __init__(self, input_variables, output_variables, divider:
                 CubeXYDivider, W_in, W, coefficients, intercept, hp:
                 SubdomainReservoirHyperparameters, n_features_out: int,
                 transformer=None):
        super().__init__(list(input_variables), list(output_variables))
        self.divider = divider
        self.W_in = W_in
        self.W = W
        # contiguous, as a loaded artifact's are: the readout's einsum
        # then sums in one order whatever the tensors' history
        self.coefficients = coefficients.contiguous()  # [n_sub, feats, out]
        self.intercept = intercept.contiguous()        # [n_sub, out_flat]
        self.hp = hp
        self.n_features_out = n_features_out  # latent features a point
        self.transformer = transformer
        self.reset_state()

    def to(self, device=None, dtype=None):
        super().to(device=device, dtype=dtype)
        if self.transformer is not None:
            self.transformer = self.transformer.to(device=device)
        return self

    def _encode(self, field: torch.Tensor) -> torch.Tensor:
        """Raw cube field [..., nf_raw] -> latent [..., nf_latent]."""
        if self.transformer is None:
            return field
        return self.transformer.encode([field])

    def _decode(self, field: torch.Tensor) -> torch.Tensor:
        if self.transformer is None:
            return field
        parts = self.transformer.decode(field)
        if isinstance(parts, dict):  # the autoencoder's variables
            parts = [v if v.ndim == field.ndim else v[..., None]
                     for v in parts.values()]
        return torch.cat(parts, dim=-1)

    def reset_state(self, batch_shape=None) -> None:
        self.state = torch.zeros(
            (self.divider.n_subdomains, self.hp.reservoir.state_size),
            dtype=STATE_DTYPE, device=self.W.device,
        )

    def _flatten_inputs(self, field: torch.Tensor) -> torch.Tensor:
        # [n_sub, sy+2o, sx+2o, nf]
        subs = self.divider.get_subdomains(self._encode(field))
        return self.divider.flatten_subdomain_features(subs)

    def increment(self, field: torch.Tensor) -> None:
        """field: [6, ny, nx, nf] input features on the cube."""
        u = self._flatten_inputs(field)
        self.state = reservoir_increment(
            self.state, u, self.W_in, self.W, self.hp.reservoir.leakage
        )

    def _readout(self, feats: torch.Tensor) -> torch.Tensor:
        """[n_sub, f] features -> [6, ny, nx, nf]: the merged interior
        predictions, decoded from the latent space."""
        dt = torch.promote_types(feats.dtype, self.coefficients.dtype)
        flat = (torch.einsum("sf,sfo->so", feats.to(dt),
                             self.coefficients.to(dt)) + self.intercept)
        sy, sx = self.divider.subdomain_extent
        o = self.divider.overlap
        interior = flat.reshape(
            self.divider.n_subdomains, sy - 2 * o, sx - 2 * o,
            self.n_features_out,
        )
        return self._decode(self.divider.merge_subdomains(interior))

    def predict_from_state(self, field=None) -> torch.Tensor:
        """-> [6, ny, nx, nf] merged interior predictions."""
        feats = self.state
        if self.hp.hybrid and field is not None:
            feats = _cat(feats, self._flatten_inputs(field))
        return self._readout(feats)

    @torch.no_grad()
    def predict(self, X: Dataset) -> Dataset:
        """Offline rollout over a [time, 6, ny, nx, nf] series."""
        u = torch.as_tensor(X["inputs"].data, device=self.W.device).to(STATE_DTYPE)
        r = torch.zeros(
            (self.divider.n_subdomains, self.hp.reservoir.state_size),
            dtype=STATE_DTYPE, device=u.device,
        )
        preds = []
        for t in range(u.shape[0]):
            uf = self._flatten_inputs(u[t])
            r = reservoir_increment(r, uf, self.W_in, self.W,
                                    self.hp.reservoir.leakage)
            preds.append(self._readout(_cat(r, uf) if self.hp.hybrid
                                       else r))
        return Dataset({"outputs": Quantity(
            torch.stack(preds), ("time", "tile", "y", "x", "f"))})

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        self._save(path)
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(
                {
                    "input_variables": self.input_variables,
                    "output_variables": self.output_variables,
                    "hyperparameters": {
                        "input_variables": self.hp.input_variables,
                        "output_variables": self.hp.output_variables,
                        "subdomain_layout": list(self.hp.subdomain_layout),
                        "overlap": self.hp.overlap,
                        "reservoir": dataclasses.asdict(self.hp.reservoir),
                        "hybrid": self.hp.hybrid,
                    },
                    "rank_extent": list(self.divider.rank_extent),
                    "n_features_out": self.n_features_out,
                    "has_transformer": self.transformer is not None,
                },
                f,
            )
        if self.transformer is not None:
            io.dump(self.transformer, os.path.join(path, "transformer"))

    @classmethod
    def load(cls, path: str) -> "SubdomainReservoirModel":
        """The model in ``path``, on the CPU in the saved dtype."""
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        hp = SubdomainReservoirHyperparameters(**meta["hyperparameters"])
        z = np.load(os.path.join(path, "weights.npz"))
        divider = CubeXYDivider(
            hp.subdomain_layout, hp.overlap, tuple(meta["rank_extent"])
        )
        return cls(
            meta["input_variables"], meta["output_variables"], divider,
            torch.tensor(z["W_in"]), torch.tensor(z["W"]),
            torch.tensor(z["coefficients"]), torch.tensor(z["intercept"]),
            hp, meta["n_features_out"],
            transformer=(io.load(os.path.join(path, "transformer"))
                         if meta.get("has_transformer") else None),
        )


@register_training_function(
    "subdomain_reservoir", SubdomainReservoirHyperparameters
)
@torch.no_grad()
def train_subdomain_reservoir(hp: SubdomainReservoirHyperparameters,
                              train_batches, val=None):
    """Drive the batched subdomain reservoirs through a cube time series
    and ridge-fit per-subdomain readouts (one batched solve).

    train_batches: iterable of Datasets with "inputs" [time, 6, ny, nx, nf]
    and "outputs" [time, 6, ny, nx, nf_out] (next-step targets), whose
    series are concatenated in time under one spin-up, as the
    reference's.  With ``transformer_path`` the ESN sees the encoded
    inputs and the readout fits the encoded targets.
    """
    batches = list(train_batches)
    u = torch.cat(_series(batches, "inputs"), dim=0)
    y = torch.cat(_series(batches, "outputs"), dim=0)
    transformer = None
    if hp.transformer_path:
        transformer = io.load(hp.transformer_path).to(device=u.device)
        u = transformer.encode([u])
        y = transformer.encode([y])
    ny, nx = u.shape[2], u.shape[3]
    nf_out = y.shape[-1]
    divider = CubeXYDivider(hp.subdomain_layout, hp.overlap, (ny, nx))
    rhp = hp.reservoir
    sub_feats = (
        divider.subdomain_extent[0] * divider.subdomain_extent[1]
        * u.shape[-1]
    )
    W_in, W = build_reservoir_matrices(sub_feats, rhp, u.device)
    # [t, n_sub, F]: every time's subdomain features, then their input
    # products in one batched product
    uflat = torch.stack([
        divider.flatten_subdomain_features(divider.get_subdomains(u[t]))
        for t in range(u.shape[0])])
    r0 = torch.zeros((divider.n_subdomains, rhp.state_size),
                     dtype=STATE_DTYPE, device=u.device)
    states = _drive(r0, _mm(uflat, W_in), W, rhp.leakage)
    feats = _cat(states, uflat) if hp.hybrid else states

    # per-subdomain interior targets, flattened: [t, n_sub, out_flat]
    o = hp.overlap

    def interior_targets(yt):
        subs = divider.get_subdomains(yt)  # overlap included
        if o:
            subs = subs[:, o:-o, o:-o, :]
        return subs.reshape(subs.shape[0], -1)

    ty = torch.stack([interior_targets(y[t]) for t in range(y.shape[0])])
    coef, intercept = _ridge_solve(
        feats[rhp.n_burn:].transpose(0, 1), ty[rhp.n_burn:].transpose(0, 1),
        rhp.l2_regularization,
    )
    return SubdomainReservoirModel(
        hp.input_variables or ["inputs"],
        hp.output_variables or ["outputs"],
        divider, W_in, W, coef, intercept, hp, nf_out,
        transformer=transformer,
    )


def reservoir_from_jax(model):
    """The port's reservoir model computing what a reference-package
    reservoir model (pure, hybrid or subdomain) computes: its arrays are
    read with ``np.asarray`` in their dtypes, its state included (no jax
    import needed here)."""
    def t(x):
        return torch.tensor(np.asarray(x))

    arrays = (t(model.W_in), t(model.W), t(model.coefficients),
              t(model.intercept))
    if hasattr(model, "divider"):
        d = model.divider
        hp = SubdomainReservoirHyperparameters(
            input_variables=list(model.hp.input_variables),
            output_variables=list(model.hp.output_variables),
            subdomain_layout=tuple(model.hp.subdomain_layout),
            overlap=model.hp.overlap,
            reservoir=ReservoirHyperparameters(
                **dataclasses.asdict(model.hp.reservoir)),
            hybrid=model.hp.hybrid,
            transformer_path=model.hp.transformer_path)
        out = SubdomainReservoirModel(
            model.input_variables, model.output_variables,
            CubeXYDivider(tuple(d.subdomain_layout), d.overlap,
                          tuple(d.rank_extent)),
            *arrays, hp, model.n_features_out,
            transformer=_transformer_from_jax(model.transformer))
    else:
        cls = (HybridReservoirComputingModel
               if type(model).__name__.startswith("Hybrid")
               else ReservoirComputingModel)
        out = cls(model.input_variables, model.output_variables, *arrays,
                  ReservoirHyperparameters(**dataclasses.asdict(model.hp)),
                  hybrid=model.hybrid)
    out.state = t(model.state)
    return out


def _transformer_from_jax(transformer):
    """The port's counterpart of a reference-package latent-space
    transformer (or None)."""
    if transformer is None:
        return None
    from fv3net_torch.fit import transformers

    kind = type(transformer).__name__
    if kind == "PCATransformer":
        return transformers.pca_from_jax(transformer)
    if kind == "DoNothingAutoencoder":
        return transformers.DoNothingAutoencoder(
            transformer.original_feature_sizes)
    from fv3net_torch.fit.autoencoder import autoencoder_from_jax

    return autoencoder_from_jax(transformer)
