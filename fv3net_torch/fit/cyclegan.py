"""CycleGAN for domain translation on the cubed sphere (port of
``fv3net_tpu/fit/cyclegan.py``; reference:
external/fv3fit/fv3fit/pytorch/cyclegan/ — train_cyclegan.py:393, the
``cyclegan`` trainer; generator.py, discriminator.py, image_pool.py,
modules.py).

- Generator: a k=7 convolution, instance norm and ReLU;
  ``n_convolutions`` stride-2 down blocks doubling the filters up to
  ``max_filters``; ``n_resnet`` residual blocks; as many fractionally
  strided up blocks; a final k=7 convolution; trainable geographic bias
  fields on input and output and appended (clock_x, clock_y, x, y, z)
  geographic features.
- Discriminator: PatchGAN, stride-2 leaky-ReLU convolutions (no norm on
  the first), a non-strided block, a 1-channel patch map; LSGAN losses.
- The replay pool of the reference (50% swap once full): the stored
  images stay on the device, its draws come from a ``torch.Generator``
  on the host (:func:`pool_draws`).
- Every convolution pads its input with the cube's own halo (the
  single-device ``halo_append_concat``: these are a model's
  convolutions, never a sharded run's blocks), so tile seams are
  seamless at each level of the pyramid.

Fields are [..., 6, ny, nx, C] (channels last, as the reference's NHWC);
each convolution folds the leading dimensions into one batch of
``F.conv2d``.  The fractionally strided convolution follows
``lax.conv_general_dilated`` with ``lhs_dilation=2`` exactly: the haloed
input dilated with zeros, then a VALID cross-correlation (the kernel is
not flipped, as ``F.conv_transpose2d`` would flip it).  The trainer
alternates one generator and one discriminator Adam step a sample, in
order, ``epochs`` times; the initial weights are the port's draws from a
``torch.Generator`` seeded with ``seed``.  The network runs in the
batches' dtype (the reference's is float32).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.fit import io
from fv3net_torch.fit.config import Adam
from fv3net_torch.fit.data import (
    TFDatasetLoader,
    register_tfdataset_loader,
    tfdataset_loader_from_dict,
)
from fv3net_torch.fit.convolutional import (
    _channels_to_fields,
    _fields_to_channels,
    _info,
    _info_dict,
    _z_variable_names,
)
from fv3net_torch.fit.networks import (
    _detached,
    _with_leaves,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from fv3net_torch.fit.normalize import StandardScaler
from fv3net_torch.fit.packer import PackingInfo
from fv3net_torch.fit.predictor import Predictor
from fv3net_torch.fit.train import register_training_function
from fv3net_torch.parallel.halo import halo_append_concat

N_GEO_FEATURES = 5  # (clock_x, clock_y, x, y, z); modules.py:56
_SECONDS_PER_DAY = 86400.0


@dataclasses.dataclass
class GeneratorConfig:
    """reference generator.py:19-61 (same fields and defaults)."""

    n_convolutions: int = 3
    n_resnet: int = 3
    kernel_size: int = 3
    strided_kernel_size: int = 4
    max_filters: int = 256
    use_geographic_bias: bool = True
    use_geographic_features: bool = True


@dataclasses.dataclass
class DiscriminatorConfig:
    """reference discriminator.py:16-45 (same fields and defaults)."""

    n_convolutions: int = 3
    kernel_size: int = 3
    strided_kernel_size: int = 3
    max_filters: int = 256
    use_geographic_features: bool = True


@dataclasses.dataclass
class CycleGANHyperparameters:
    """reference train_cyclegan.py CycleGANHyperparameters; the
    ``generator`` and ``discriminator`` given as dicts (a training
    config's yaml) become their configs."""

    state_variables: List[str] = dataclasses.field(default_factory=list)
    generator: GeneratorConfig = dataclasses.field(
        default_factory=GeneratorConfig
    )
    discriminator: DiscriminatorConfig = dataclasses.field(
        default_factory=DiscriminatorConfig
    )
    cycle_weight: float = 10.0
    identity_weight: float = 5.0
    gan_weight: float = 1.0
    image_pool_size: int = 50
    learning_rate: float = 2e-4
    epochs: int = 5
    seed: int = 0

    def __post_init__(self):
        if isinstance(self.generator, dict):
            self.generator = GeneratorConfig(**self.generator)
        if isinstance(self.discriminator, dict):
            self.discriminator = DiscriminatorConfig(**self.discriminator)


# ---------------------------------------------------------------------------
# cube-aware convolution primitives on [..., 6, ny, nx, c]
# ---------------------------------------------------------------------------
def _halo(x: torch.Tensor, h: int) -> torch.Tensor:
    """The cube's halo of ``h`` cells around each tile of
    [..., 6, ny, nx, c], on one device."""
    if h == 0:
        return x
    lead = x.ndim - 4
    xt = torch.movedim(torch.movedim(x, lead, 0), -1, -3)  # [6, .., c, y, x]
    ext = halo_append_concat(xt, h)
    return torch.movedim(torch.movedim(ext, -3, -1), 0, lead)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """[..., 6, H, W, c] -> [(..., 6), c, H, W]."""
    return x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)


def _nhwc(h: torch.Tensor, lead) -> torch.Tensor:
    """Inverse of :func:`_nchw` for leading shape ``lead`` (tile
    included)."""
    return h.permute(0, 2, 3, 1).reshape(tuple(lead) + tuple(
        h.shape[2:]) + (h.shape[1],))


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)  # HWIO -> OIHW


def _conv(x, w, b, stride: int = 1):
    """Halo-padded convolution keeping ny/stride resolution."""
    k = w.shape[0]
    pad = (k - stride + 1) // 2
    ext = _halo(x, pad)
    h = F.conv2d(_nchw(ext), _oihw(w), stride=stride)
    ny, nx = x.shape[-3] // stride, x.shape[-2] // stride
    if h.shape[2] != ny:  # even kernels: crop the tail
        h = h[:, :, :ny, :nx]
    return _nhwc(h, x.shape[:-3]) + b


def _conv_transpose(x, w, b):
    """The fractionally strided (stride-1/2) halo-padded convolution: the
    field haloed by 1, dilated by 2 with zeros, a VALID convolution,
    cropped to twice the resolution (``lax.conv_general_dilated`` with
    ``lhs_dilation=(2, 2)``, generator.py's up blocks)."""
    n = x.shape[-3]
    k = w.shape[0]
    ext = _nchw(_halo(x, 1))  # [N, c, n + 2, n + 2]
    m = 2 * ext.shape[-1] - 1
    dil = ext.new_zeros(ext.shape[:2] + (m, m))
    dil[..., ::2, ::2] = ext
    h = F.conv2d(dil, _oihw(w))
    # the dilated width 2(n+2)-1 = 2n+3 gives 2n+4-k: crop symmetrically
    # (the excess is 0 for k=4, 1 for k=3)
    lo = (h.shape[-1] - 2 * n) // 2
    h = h[..., lo: lo + 2 * n, lo: lo + 2 * n]
    return _nhwc(h, x.shape[:-3]) + b


def _inorm(x, eps: float = 1e-5):
    """InstanceNorm2d (affine-free) per tile and channel over (y, x)
    (generator.py FoldFirstDimension(InstanceNorm2d))."""
    m = x.mean(dim=(-3, -2), keepdim=True)
    v = x.var(dim=(-3, -2), unbiased=False, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps)


def _leaky(x):
    return F.leaky_relu(x, 0.2)


def _conv_init(generator: torch.Generator, k: int, cin: int, cout: int,
               dtype=torch.float32, device=None):
    """The reference's scale 1/sqrt(k k cin), the port's normal draws (in
    float64 from ``generator``, cast last), zero bias."""
    w = torch.randn((k, k, cin, cout), generator=generator,
                    dtype=torch.float64) / math.sqrt(k * k * cin)
    return {"w": w.to(dtype=dtype, device=device),
            "b": torch.zeros(cout, dtype=dtype, device=device)}


def _geo_features(n: int):
    """(lat, lon) [6, n, n] of C``n`` (float64, on the CPU): the static
    part of the geographic features (modules.py:49-108)."""
    from fv3net_torch.grid.geometry import make_grid

    grid = make_grid(n)
    return torch.tensor(grid.lat), torch.tensor(grid.lon)


def _geo_channels(geo, x: torch.Tensor, time_seconds: float):
    """The 5 geographic channels for ``x`` [..., 6, n, n, C], in its dtype
    on its device: the solar clock hand (amplitude cos(lat)) and the unit
    sphere's xyz."""
    lat = geo[0].to(dtype=x.dtype, device=x.device)
    lon = geo[1].to(dtype=x.dtype, device=x.device)
    phase = lon + 2.0 * math.pi * (
        (time_seconds % _SECONDS_PER_DAY) / _SECONDS_PER_DAY)
    feats = torch.stack([
        torch.cos(lat) * torch.cos(phase), torch.cos(lat) * torch.sin(phase),
        torch.cos(lat) * torch.cos(lon), torch.cos(lat) * torch.sin(lon),
        torch.sin(lat)], dim=-1)
    return feats.expand(tuple(x.shape[:-1]) + (N_GEO_FEATURES,))


# ---------------------------------------------------------------------------
# generator / discriminator
# ---------------------------------------------------------------------------
def init_generator(generator: torch.Generator, cfg: GeneratorConfig,
                   channels: int, n: int, dtype=torch.float32, device=None):
    min_f = cfg.max_filters // (2 ** cfg.n_convolutions)
    cin = channels + (N_GEO_FEATURES if cfg.use_geographic_features else 0)

    def conv(k, ci, co):
        return _conv_init(generator, k, ci, co, dtype, device)

    p = {"first": conv(7, cin, min_f), "down": [], "resnet": [], "up": [],
         "out": conv(7, min_f, channels)}
    f = min_f
    for _ in range(cfg.n_convolutions):
        p["down"].append(conv(cfg.strided_kernel_size, f, 2 * f))
        f *= 2
    for _ in range(cfg.n_resnet):
        p["resnet"].append((conv(cfg.kernel_size, f, f),
                            conv(cfg.kernel_size, f, f)))
    for _ in range(cfg.n_convolutions):
        p["up"].append(conv(cfg.strided_kernel_size, f, f // 2))
        f //= 2
    if cfg.use_geographic_bias:
        p["in_bias"] = torch.zeros((6, n, n, channels), dtype=dtype,
                                   device=device)
        p["out_bias"] = torch.zeros((6, n, n, channels), dtype=dtype,
                                    device=device)
    return p


def apply_generator(p, cfg: GeneratorConfig, geo, x, time_seconds=0.0):
    """x: [..., 6, ny, nx, C] normalized fields -> translated fields."""
    if cfg.use_geographic_bias:
        x = x + p["in_bias"]
    if cfg.use_geographic_features:
        x = torch.cat([x, _geo_channels(geo, x, time_seconds)], dim=-1)
    h = torch.relu(_inorm(_conv(x, **p["first"])))
    for layer in p["down"]:
        h = torch.relu(_inorm(_conv(h, layer["w"], layer["b"], stride=2)))
    for c1, c2 in p["resnet"]:
        r = torch.relu(_inorm(_conv(h, **c1)))
        r = _inorm(_conv(r, **c2))
        h = h + r  # ResnetBlock skip (modules.py:546-590)
    for layer in p["up"]:
        h = torch.relu(_inorm(_conv_transpose(h, layer["w"], layer["b"])))
    out = _conv(h, **p["out"])
    if cfg.use_geographic_bias:
        out = out + p["out_bias"]
    return out


def init_discriminator(generator: torch.Generator, cfg: DiscriminatorConfig,
                       channels: int, dtype=torch.float32, device=None):
    min_f = cfg.max_filters // (2 ** (cfg.n_convolutions - 1))
    cin = channels + (N_GEO_FEATURES if cfg.use_geographic_features else 0)

    def conv(k, ci, co):
        return _conv_init(generator, k, ci, co, dtype, device)

    p = {"first": conv(cfg.strided_kernel_size, cin, min_f), "down": []}
    f = min_f
    for _ in range(1, cfg.n_convolutions):
        p["down"].append(conv(cfg.strided_kernel_size, f, 2 * f))
        f *= 2
    p["final"] = conv(cfg.kernel_size, f, f)
    p["patch"] = conv(3, f, 1)
    return p


def apply_discriminator(p, cfg: DiscriminatorConfig, geo, x,
                        time_seconds=0.0):
    """-> patch score map [..., 6, ny/2^n, nx/2^n, 1] (PatchGAN)."""
    if cfg.use_geographic_features:
        x = torch.cat([x, _geo_channels(geo, x, time_seconds)], dim=-1)
    # the first strided conv unnormalized (discriminator.py:112)
    h = _leaky(_conv(x, p["first"]["w"], p["first"]["b"], stride=2))
    for layer in p["down"]:
        h = _leaky(_inorm(_conv(h, layer["w"], layer["b"], stride=2)))
    h = _leaky(_inorm(_conv(h, **p["final"])))
    return _conv(h, **p["patch"])


# ---------------------------------------------------------------------------
# the replay image pool (image_pool.py semantics)
# ---------------------------------------------------------------------------
def pool_draws(generator: torch.Generator, size: int) -> Tuple[float, int]:
    """One query's draws: a uniform in [0, 1) and a stored image's index
    (the reference draws both on every query)."""
    u = float(torch.rand((), generator=generator, dtype=torch.float64))
    idx = int(torch.randint(0, size, (), generator=generator))
    return u, idx


def pool_query(pool: list, size: int, draws: Tuple[float, int], img):
    """One query of the replay pool (a list of at most ``size`` stored
    images, updated in place): while filling, store and return the
    current image; once full, with probability 1/2 return a stored image
    and store the current one in its place, else return the current
    image."""
    u, idx = draws
    if len(pool) < size:
        pool.append(img)
        return img
    if u > 0.5:
        old = pool[idx]
        pool[idx] = img
        return old
    return img


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _skeleton(gen_cfg: GeneratorConfig, channels: int, n: int):
    return init_generator(torch.Generator().manual_seed(0), gen_cfg,
                          channels, n)


@io.register("cycle_gan")
class CycleGAN(Predictor):
    """Holds both generators; ``predict`` applies G: domain A -> B,
    ``reverse`` applies F: B -> A."""

    def __init__(self, state_variables, gen_cfg: GeneratorConfig, n: int,
                 g_ab, g_ba, info, scaler_a, scaler_b, state_z_names=None):
        super().__init__(list(state_variables), list(state_variables))
        self.state_variables = list(state_variables)
        self.gen_cfg = gen_cfg
        self.n = n
        self.g_ab = g_ab
        self.g_ba = g_ba
        self.info = info
        self.scaler_a = scaler_a
        self.scaler_b = scaler_b
        self.state_z_names = (
            tuple(state_z_names) if state_z_names is not None else None
        )
        self._geo = _geo_features(n)

    def to(self, device=None, dtype=None):
        """Move the generators and scalers (in place); returns the
        model."""
        def mv(x):
            return x.to(device=device, dtype=dtype)

        self.g_ab = tree_map(mv, self.g_ab)
        self.g_ba = tree_map(mv, self.g_ba)
        self.scaler_a = StandardScaler(mv(self.scaler_a.mean),
                                       mv(self.scaler_a.std))
        self.scaler_b = StandardScaler(mv(self.scaler_b.mean),
                                       mv(self.scaler_b.std))
        return self

    @torch.no_grad()
    def _run_direction(self, X: Dataset, params, scaler_in, scaler_out):
        """Every sample of ``X`` in one batched call."""
        arr, _ = _fields_to_channels(X, self.state_variables)
        arr = arr.to(device=scaler_in.mean.device,
                     dtype=params["first"]["w"].dtype)
        out = scaler_out.denormalize(apply_generator(
            params, self.gen_cfg, self._geo, scaler_in.normalize(arr)))
        q0 = X[self.state_variables[0]]
        prefix = tuple(
            d for d in q0.dims if d not in ("tile", "z", "y", "x")
        )
        return Dataset(
            _channels_to_fields(
                out, self.info,
                prefix + ("tile", "z", "y", "x"),
                prefix + ("tile", "y", "x"),
                z_names=self.state_z_names,
            )
        )

    def predict(self, X: Dataset) -> Dataset:
        return self._run_direction(X, self.g_ab, self.scaler_a,
                                   self.scaler_b)

    def reverse(self, X: Dataset) -> Dataset:
        return self._run_direction(X, self.g_ba, self.scaler_b,
                                   self.scaler_a)

    # -- serialization: leaves in JAX's flatten order, the structure
    # rebuilt from the config -------------------------------------------
    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

        def n(x):
            return x.detach().cpu().numpy()

        flat = {}
        for tag, params in (("ab", self.g_ab), ("ba", self.g_ba)):
            for i, leaf in enumerate(tree_leaves(params)):
                flat[f"{tag}_{i}"] = n(leaf)
        flat.update(
            a_mean=n(self.scaler_a.mean),
            a_std=n(self.scaler_a.std),
            b_mean=n(self.scaler_b.mean),
            b_std=n(self.scaler_b.std),
        )
        np.savez(os.path.join(path, "weights.npz"), **flat)
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(
                {
                    "state_variables": self.state_variables,
                    "info": _info_dict(self.info),
                    "generator": dataclasses.asdict(self.gen_cfg),
                    "n": self.n,
                    "state_z_names": (
                        list(self.state_z_names)
                        if self.state_z_names is not None else None
                    ),
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "CycleGAN":
        """The model in ``path``, on the CPU in the saved dtype."""
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        z = np.load(os.path.join(path, "weights.npz"))
        gen_cfg = GeneratorConfig(**meta["generator"])
        info = _info(meta["info"])
        skeleton = _skeleton(gen_cfg, sum(info.features), meta["n"])
        n_leaves = len(tree_leaves(skeleton))
        gs = {tag: tree_unflatten(skeleton, [
            torch.tensor(z[f"{tag}_{i}"]) for i in range(n_leaves)])
            for tag in ("ab", "ba")}

        def t(key):
            return torch.tensor(z[key])

        return cls(
            meta["state_variables"], gen_cfg, meta["n"], gs["ab"], gs["ba"],
            info,
            StandardScaler(t("a_mean"), t("a_std")),
            StandardScaler(t("b_mean"), t("b_std")),
            state_z_names=meta.get("state_z_names"),
        )


def params_tree_from_jax(tree, dtype=None):
    """A reference parameter pytree (dicts, lists, tuples of arrays) as
    tensors, read with ``np.asarray`` (in ``dtype`` if given)."""
    if isinstance(tree, dict):
        return {k: params_tree_from_jax(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_tree_from_jax(v, dtype) for v in tree)
    return torch.tensor(np.asarray(tree), dtype=dtype)


def cyclegan_from_jax(model, dtype=None) -> CycleGAN:
    """The port's :class:`CycleGAN` of a reference-package one."""
    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype)

    return CycleGAN(
        model.state_variables,
        GeneratorConfig(**dataclasses.asdict(model.gen_cfg)), model.n,
        params_tree_from_jax(model.g_ab, dtype),
        params_tree_from_jax(model.g_ba, dtype),
        PackingInfo(list(model.info.names),
                    [int(f) for f in model.info.features]),
        StandardScaler(t(model.scaler_a.mean), t(model.scaler_a.std)),
        StandardScaler(t(model.scaler_b.mean), t(model.scaler_b.std)),
        state_z_names=model.state_z_names)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CycleGANLoader(TFDatasetLoader):
    """The two domains' data configs, a loader config each (upstream
    fv3fit's ``CycleGANLoader``, ``domain_configs``): its batches are the
    (domain_a, domain_b) pairs the ``cyclegan`` trainer takes, the
    domains' batches paired in order."""

    domain_configs: List[dict]

    @classmethod
    def from_dict(cls, d: dict) -> "CycleGANLoader":
        if set(d) != {"domain_configs"} or len(d["domain_configs"]) != 2:
            raise ValueError("a CycleGANLoader config is {domain_configs: "
                             "[a, b]}")
        return cls(list(d["domain_configs"]))

    def open_tfdataset(self, local_download_path, variable_names):
        a, b = (tfdataset_loader_from_dict(c).open_tfdataset(
            local_download_path, variable_names)
            for c in self.domain_configs)
        return [(x, y) for x, y in zip(a, b)]


register_tfdataset_loader(CycleGANLoader)


def _samples(ds: Dataset, names):
    X, info = _fields_to_channels(ds, names)
    return X.reshape((-1,) + tuple(X.shape[-4:])), info


@register_training_function("cyclegan", CycleGANHyperparameters)
def train_cyclegan(
    hp: CycleGANHyperparameters, train_batches, val=None
) -> CycleGAN:
    """Train on a sequence of (domain_a, domain_b) Dataset pairs of
    cube-shaped samples ([..., tile, z, y, x]), unpaired in content
    (reference train_cyclegan.py:393), on their device, in their dtype."""
    a_list, b_list = [], []
    info = None
    state_z_names = None
    for ds_a, ds_b in train_batches:
        A, info = _samples(ds_a, hp.state_variables)
        B, _ = _samples(ds_b, hp.state_variables)
        if state_z_names is None:
            state_z_names = _z_variable_names(ds_a, hp.state_variables)
        a_list.append(A)
        b_list.append(B)
    A = torch.cat(a_list)  # [sample, 6, ny, nx, C]
    B = torch.cat(b_list)
    C = A.shape[-1]
    n = A.shape[-2]
    if n % (2 ** hp.generator.n_convolutions):
        raise ValueError(
            f"C{n} not divisible by 2^{hp.generator.n_convolutions} "
            "(generator.n_convolutions strided halvings)"
        )
    scaler_a = StandardScaler.fit(A.reshape(-1, C))
    scaler_b = StandardScaler.fit(B.reshape(-1, C))
    An = scaler_a.normalize(A)
    Bn = scaler_b.normalize(B)

    gen_rng = torch.Generator().manual_seed(hp.seed)
    kw = dict(dtype=A.dtype, device=A.device)
    g_leaves: list = []
    d_leaves: list = []
    gen = _with_leaves({
        "ab": init_generator(gen_rng, hp.generator, C, n, **kw),
        "ba": init_generator(gen_rng, hp.generator, C, n, **kw)}, g_leaves)
    disc = _with_leaves({
        "a": init_discriminator(gen_rng, hp.discriminator, C, **kw),
        "b": init_discriminator(gen_rng, hp.discriminator, C, **kw)},
        d_leaves)
    geo = _geo_features(n)
    gcfg, dcfg = hp.generator, hp.discriminator

    def G(p, x):
        return apply_generator(p, gcfg, geo, x)

    def D(p, x):
        return apply_discriminator(p, dcfg, geo, x)

    tx_g = Adam(hp.learning_rate, b1=0.5)
    tx_d = Adam(hp.learning_rate, b1=0.5)

    def gen_loss(a, b):
        fake_b = G(gen["ab"], a)
        fake_a = G(gen["ba"], b)
        # LSGAN over the patch map: the generator wants D(fake) -> 1
        adv = (torch.mean((D(disc["b"], fake_b) - 1.0) ** 2)
               + torch.mean((D(disc["a"], fake_a) - 1.0) ** 2))
        cyc = (torch.mean(torch.abs(G(gen["ba"], fake_b) - a))
               + torch.mean(torch.abs(G(gen["ab"], fake_a) - b)))
        idt = (torch.mean(torch.abs(G(gen["ab"], b) - b))
               + torch.mean(torch.abs(G(gen["ba"], a) - a)))
        loss = (hp.gan_weight * adv + hp.cycle_weight * cyc
                + hp.identity_weight * idt)
        return loss, fake_a.detach(), fake_b.detach()

    def disc_loss(a, b, fake_a, fake_b):
        loss = (torch.mean((D(disc["a"], a) - 1.0) ** 2)
                + torch.mean(D(disc["a"], fake_a) ** 2)
                + torch.mean((D(disc["b"], b) - 1.0) ** 2)
                + torch.mean(D(disc["b"], fake_b) ** 2))
        return 0.5 * loss

    nt = min(An.shape[0], Bn.shape[0])
    size = max(1, int(hp.image_pool_size))
    pool_a: list = []
    pool_b: list = []
    draw_rng = torch.Generator().manual_seed(hp.seed + 1)
    with torch.enable_grad():
        for _ in range(hp.epochs):
            for i in range(nt):
                a, b = An[i], Bn[i]
                loss, fake_a, fake_b = gen_loss(a, b)
                tx_g.step(g_leaves, torch.autograd.grad(loss, g_leaves))
                # the discriminators train against the pool's fakes
                fa = pool_query(pool_a, size, pool_draws(draw_rng, size),
                                fake_a)
                fb = pool_query(pool_b, size, pool_draws(draw_rng, size),
                                fake_b)
                tx_d.step(d_leaves, torch.autograd.grad(
                    disc_loss(a, b, fa, fb), d_leaves))

    return CycleGAN(
        hp.state_variables, hp.generator, n,
        _detached(gen["ab"]),
        _detached(gen["ba"]), info,
        scaler_a, scaler_b, state_z_names=state_z_names,
    )
