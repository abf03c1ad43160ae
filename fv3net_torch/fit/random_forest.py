"""The random forest: fit, prediction on the device, feature importances
and the reference's ``regressor.pkl`` (port of
``fv3net_tpu/fit/random_forest.py``; reference:
external/fv3fit/fv3fit/sklearn/_random_forest.py:39, the
"sklearn_random_forest" trainer).

The reference fits ``sklearn.ensemble.RandomForestRegressor`` at
scikit-learn's defaults (``max_features=1.0``, ``bootstrap=True``, the
squared error).  The port fits the same forest on tensors, without
scikit-learn, as scikit-learn 1.9 does:

- the trees' seeds are ``RandomState(random_state).randint(
  np.iinfo(np.int32).max)``, drawn in order (``_set_random_states`` in
  ``sklearn/ensemble/_base.py``), and each tree's bootstrap is
  ``RandomState(seed).randint(0, n, n)`` (``_generate_sample_indices``
  in ``sklearn/ensemble/_forest.py``), whose counts weigh the samples;
- X is cast to float32, and the criterion is the multi-output squared
  error (``_criterion.pyx::MSE``): a split maximizes
  sum_k SL_k^2 / WL + sum_k SR_k^2 / WR over the weighted output sums
  of its two sides;
- a split lies between adjacent sorted values more than
  ``FEATURE_THRESHOLD`` apart, at their float32 halves' sum
  (``tree/_splitter.pyx::node_split_best``), with at least
  ``min_samples_leaf`` distinct samples a side;
- a node is a leaf at ``max_depth``, below 2 samples or
  2 * ``min_samples_leaf``, where its impurity is at most machine
  epsilon, or where no split is valid (``tree/_tree.pyx``
  ``DepthFirstTreeBuilder``); the nodes are numbered depth first, left
  before right.

scikit-learn visits a node's features in a random order and keeps the
first best split; where two features split a node's samples into the
same two sets, the port keeps the first feature in column order, so the
two forests then differ in that feature and threshold only.

The fit goes level by level: for each feature in blocks, the samples of
the level's open nodes sort by (node, feature value) and the outputs,
centered on their node's mean, are summed along that order (prefix sums
of n * F * O float64 values a level, in blocks of features).  Prediction
walks every tree for all samples at once on the device.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np
import torch

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.fit import _sklearn_pickle as skp
from fv3net_torch.fit import io, packer
from fv3net_torch.fit.convolutional import _info, _info_dict
from fv3net_torch.fit.predictor import Predictor
from fv3net_torch.fit.train import register_training_function

FEATURE_THRESHOLD = 1e-7  # sklearn/tree/_splitter.pyx
EPSILON = float(np.finfo(np.float64).eps)  # sklearn/tree/_tree.pyx
#: float64 elements of one block of prefix sums (features x samples x
#: outputs) in the fit
BLOCK_ELEMENTS = 2 ** 25


@dataclasses.dataclass
class RandomForestHyperparameters:
    """(reference _random_forest.py RandomForestHyperparameters subset)"""

    input_variables: List[str] = dataclasses.field(default_factory=list)
    output_variables: List[str] = dataclasses.field(default_factory=list)
    n_estimators: int = 100
    max_depth: int = None
    min_samples_leaf: int = 1
    n_jobs: int = -1
    random_state: int = 0


@dataclasses.dataclass
class TreeArrays:
    """One fitted tree, nodes in scikit-learn's depth-first order:
    children (-1 at a leaf), feature (-2 at a leaf), threshold (-2.0 at
    a leaf), impurity, n_node_samples, weighted_n_node_samples,
    missing_go_to_left and values [node, output]."""

    left_child: np.ndarray
    right_child: np.ndarray
    feature: np.ndarray
    threshold: np.ndarray
    impurity: np.ndarray
    n_node_samples: np.ndarray
    weighted_n_node_samples: np.ndarray
    missing_go_to_left: np.ndarray
    values: np.ndarray

    def nodes(self) -> np.ndarray:
        out = np.zeros(len(self.feature), skp.NODE_DTYPE)
        for name in skp.NODE_DTYPE.names:
            out[name] = getattr(self, name)
        return out

    @classmethod
    def from_estimator(cls, est) -> "TreeArrays":
        return cls(**skp.tree_arrays(est))

    @property
    def depth(self) -> int:
        depth = np.zeros(len(self.feature), np.int64)
        for i in range(len(self.feature)):
            if self.left_child[i] != skp.TREE_LEAF:
                depth[self.left_child[i]] = depth[self.right_child[i]] = (
                    depth[i] + 1)
        return int(depth.max())

    def feature_importances(self, n_features: int) -> np.ndarray:
        """Mean decrease in impurity per feature, normalized
        (``Tree.compute_feature_importances``)."""
        imp = np.zeros(n_features)
        w = self.weighted_n_node_samples
        for i in range(len(self.feature)):
            left, right = self.left_child[i], self.right_child[i]
            if left != skp.TREE_LEAF:
                imp[self.feature[i]] += (
                    w[i] * self.impurity[i] - w[left] * self.impurity[left]
                    - w[right] * self.impurity[right])
        imp /= w[0]
        total = imp.sum()
        if total > 0.0:
            imp /= total
        return imp


def tree_seeds(random_state, n_estimators: int) -> List[int]:
    """The trees' seeds as scikit-learn draws them."""
    rs = (np.random.mtrand._rand if random_state is None
          else np.random.RandomState(random_state))
    return [int(rs.randint(np.iinfo(np.int32).max))
            for _ in range(n_estimators)]


def bootstrap_counts(seed: int, n_samples: int) -> np.ndarray:
    """How often each sample is drawn in a tree's bootstrap."""
    idx = np.random.RandomState(seed).randint(0, n_samples, n_samples,
                                              dtype=np.int32)
    return np.bincount(idx, minlength=n_samples)


def feature_ranks(X: torch.Tensor) -> torch.Tensor:
    """Each sample's position [n, F] in its feature's ascending order."""
    n = X.shape[0]
    order = torch.argsort(X, dim=0, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(0, order, torch.arange(n, device=X.device)[:, None]
                   .expand_as(order).contiguous())
    return ranks


def fit_tree(X: torch.Tensor, Y: torch.Tensor, counts: torch.Tensor,
             max_depth: Optional[int] = None, min_samples_leaf: int = 1,
             ranks: torch.Tensor = None) -> TreeArrays:
    """One tree on float32 ``X`` [n, F], float64 ``Y`` [n, O] and the
    bootstrap ``counts`` [n] (samples drawn 0 times are left out), on
    ``X``'s device."""
    device = X.device
    n, F = X.shape
    O = Y.shape[1]
    Xd = X.to(torch.float64)
    Y = Y.to(torch.float64)
    w_all = counts.to(device=device, dtype=torch.float64)
    if ranks is None:
        ranks = feature_ranks(X)
    max_depth = np.inf if max_depth is None else max_depth
    msl = int(min_samples_leaf)

    # breadth-first records, renumbered depth first at the end
    depth_of: List[int] = [0]
    rec = {k: [] for k in ("impurity", "n", "w", "value")}
    feature_of = {}
    children = {}

    idx = torch.nonzero(w_all > 0).flatten()  # samples of open nodes
    local = torch.zeros_like(idx)  # their node among the open ones
    frontier = [0]

    while frontier:
        k = len(frontier)
        w = w_all[idx]
        cnt = torch.bincount(local, minlength=k)
        W = torch.zeros(k, dtype=torch.float64, device=device).index_add_(
            0, local, w)
        wy = w[:, None] * Y[idx]
        S = torch.zeros((k, O), dtype=torch.float64, device=device
                        ).index_add_(0, local, wy)
        SQ = torch.zeros(k, dtype=torch.float64, device=device).index_add_(
            0, local, (wy * Y[idx]).sum(dim=1))
        mean = S / W[:, None]
        impurity = (SQ / W - (mean * mean).sum(dim=1)) / O
        depth = torch.tensor([depth_of[b] for b in frontier], device=device)
        leaf = ((depth >= max_depth) | (cnt < 2) | (cnt < 2 * msl)
                | (impurity <= EPSILON))
        split_nodes = torch.nonzero(~leaf).flatten()
        best = (_best_splits(Xd, Y, w_all, ranks, idx, local, leaf, mean,
                             cnt, msl, n)
                if len(split_nodes) else None)
        cnt_h, W_h, imp_h, mean_h = (cnt.cpu().numpy(), W.cpu().numpy(),
                                     impurity.cpu().numpy(),
                                     mean.cpu().numpy())
        for a, b in enumerate(frontier):
            rec["impurity"].append((b, imp_h[a]))
            rec["n"].append((b, cnt_h[a]))
            rec["w"].append((b, W_h[a]))
            rec["value"].append((b, mean_h[a]))
        if best is None:
            break
        val, feat, thr, n_left = (t.cpu().numpy() for t in best)
        rows = split_nodes.cpu().numpy()
        ok = np.isfinite(val)  # where no split is valid: a leaf
        new_frontier = []
        child_of = np.full((k, 2), -1, np.int64)
        f_node, t_node = np.zeros(k, np.int64), np.zeros(k)
        for r in np.flatnonzero(ok):
            a = rows[r]
            b = frontier[a]
            feature_of[b] = (int(feat[r]), float(thr[r]),
                             int(n_left[r]) > int(cnt_h[a]) - int(n_left[r]))
            ids = (len(depth_of), len(depth_of) + 1)
            depth_of += [depth_of[b] + 1] * 2
            children[b] = ids
            child_of[a] = [len(new_frontier), len(new_frontier) + 1]
            new_frontier += ids
            f_node[a], t_node[a] = feat[r], thr[r]
        if not new_frontier:
            break
        # samples move to their child (left where x <= threshold)
        f_node = torch.as_tensor(f_node, device=device)
        t_node = torch.as_tensor(t_node, device=device)
        go_right = (Xd[idx, f_node[local]] > t_node[local]).long()
        new_local = torch.as_tensor(child_of, device=device)[local, go_right]
        keep = new_local >= 0
        idx, local = idx[keep], new_local[keep]
        frontier = new_frontier
    return _depth_first(len(depth_of), children, feature_of, rec, O)


def _best_splits(Xd, Y, w_all, ranks, idx, local, leaf, mean, cnt, msl, n):
    """The best split of each open node that is not a leaf: (proxy,
    feature, threshold, n_left), -inf proxy where none is valid."""
    device = Xd.device
    F = Xd.shape[1]
    O = Y.shape[1]
    split_nodes = torch.nonzero(~leaf).flatten()
    k2 = len(split_nodes)
    remap = torch.full((len(leaf),), -1, dtype=torch.int64, device=device)
    remap[split_nodes] = torch.arange(k2, device=device)
    keep = ~leaf[local]
    sid = idx[keep]
    node = remap[local[keep]]
    m = len(sid)
    counts2 = cnt[split_nodes]
    seg_start = torch.cumsum(counts2, 0) - counts2
    pos_node = torch.repeat_interleave(torch.arange(k2, device=device),
                                       counts2)
    pos = torch.arange(m, device=device)
    seg_end = seg_start + counts2 - 1
    n_left = pos - seg_start[pos_node]  # samples before each position
    n_right = counts2[pos_node] - n_left
    size_ok = (n_left >= msl) & (n_right >= msl) & (n_left > 0)
    # outputs centered on their node's mean, weighted
    wyc = w_all[sid][:, None] * (Y[sid] - mean[split_nodes][node])
    w = w_all[sid]

    best_val = torch.full((k2,), -np.inf, dtype=torch.float64, device=device)
    best_feat = torch.zeros(k2, dtype=torch.int64, device=device)
    best_thr = torch.zeros(k2, dtype=torch.float64, device=device)
    best_nl = torch.zeros(k2, dtype=torch.int64, device=device)
    B = max(1, min(F, BLOCK_ELEMENTS // max(1, m * O)))
    for f0 in range(0, F, B):
        fb = torch.arange(f0, min(f0 + B, F), device=device)
        nb = len(fb)
        key = node[:, None] * n + ranks[sid][:, fb]
        perm = torch.sort(key, dim=0).indices  # [m, nb]
        xs = Xd[sid[perm], fb[None, :]]
        # exclusive prefix sums along each feature's order, less their
        # value at the node's first position: the left side's sums
        w_s = w[perm]
        wy_s = wyc[perm]  # [m, nb, O]
        WL = torch.cumsum(w_s, dim=0) - w_s
        SL = torch.cumsum(wy_s, dim=0).sub_(wy_s)
        WT = WL[seg_end] + w_s[seg_end]
        ST = SL[seg_end] + wy_s[seg_end]
        del wy_s
        base_w, base_y = WL[seg_start], SL[seg_start]
        WL = WL - base_w[pos_node]
        SL.sub_(base_y[pos_node])
        WR = (WT - base_w)[pos_node] - WL
        SR = (ST - base_y)[pos_node].sub_(SL)
        proxy = (SL * SL).sum(-1) / WL + (SR * SR).sum(-1) / WR
        prev = torch.roll(xs, 1, dims=0)
        valid = size_ok[:, None] & (xs > prev + FEATURE_THRESHOLD)
        proxy = torch.where(valid, proxy, torch.full_like(proxy, -np.inf))
        # the node's best in this block: the largest proxy, then the
        # first feature, then the first position
        node_b = pos_node[:, None].expand(m, nb)
        blk_val = torch.full((k2,), -np.inf, dtype=torch.float64,
                             device=device).scatter_reduce(
            0, node_b.reshape(-1), proxy.reshape(-1), "amax")
        is_best = (proxy == blk_val[node_b]) & valid
        code = (torch.arange(nb, device=device)[None, :] * m
                + pos[:, None])
        big = torch.full_like(code, nb * m)
        blk_code = torch.full((k2,), nb * m, dtype=torch.int64,
                              device=device).scatter_reduce(
            0, node_b.reshape(-1), torch.where(is_best, code, big).reshape(-1),
            "amin")
        better = (blk_val > best_val) & (blk_code < nb * m)
        rows = torch.nonzero(better).flatten()
        if len(rows):
            c = blk_code[rows]
            bi, p = c // m, c % m
            best_val[rows] = blk_val[rows]
            best_feat[rows] = fb[bi]
            # the halves' sum of the float32 values on either side
            best_thr[rows] = xs[p - 1, bi] / 2.0 + xs[p, bi] / 2.0
            best_nl[rows] = n_left[p]
    return best_val, best_feat, best_thr, best_nl


def _depth_first(n_nodes, children, feature_of, rec, O) -> TreeArrays:
    """The breadth-first records renumbered in scikit-learn's depth-first
    order."""
    order = []
    stack = [0]
    while stack:
        b = stack.pop()
        order.append(b)
        if b in children:
            stack.append(children[b][1])
            stack.append(children[b][0])
    new_id = np.empty(n_nodes, np.int64)
    new_id[order] = np.arange(n_nodes)
    vals = {key: dict(items) for key, items in rec.items()}
    left = np.full(n_nodes, skp.TREE_LEAF, np.intp)
    right = np.full(n_nodes, skp.TREE_LEAF, np.intp)
    feature = np.full(n_nodes, skp.TREE_UNDEFINED, np.intp)
    threshold = np.full(n_nodes, float(skp.TREE_UNDEFINED))
    mgl = np.zeros(n_nodes, np.uint8)
    for b in range(n_nodes):
        i = new_id[b]
        if b in children:
            left[i] = new_id[children[b][0]]
            right[i] = new_id[children[b][1]]
            feature[i], threshold[i], mgl[i] = feature_of[b]
    return TreeArrays(
        left_child=left, right_child=right, feature=feature,
        threshold=threshold,
        impurity=np.array([vals["impurity"][b] for b in order]),
        n_node_samples=np.array([vals["n"][b] for b in order], np.intp),
        weighted_n_node_samples=np.array([vals["w"][b] for b in order]),
        missing_go_to_left=mgl,
        values=np.array([vals["value"][b] for b in order]).reshape(
            n_nodes, O),
    )


def match_trees(a: TreeArrays, b: TreeArrays, X: np.ndarray,
                counts: np.ndarray, rtol: float = 1e-9) -> dict:
    """Hold tree ``b`` to tree ``a``, both fitted on ``X`` with these
    bootstrap ``counts``, under the rule a tie cannot change: walking
    ``a`` depth first, every node and its match in ``b`` hold the same
    training samples, the same n_node_samples and
    weighted_n_node_samples, and impurity and values within ``rtol`` of
    their scale; a split may differ in feature and threshold only where
    both put the node's samples into the same two sets (then ``b``'s
    children may be swapped).  Returns the counts of nodes, of splits on
    another feature and of swapped children, and ``ok``."""
    X32 = np.asarray(X, np.float32).astype(np.float64)
    samples = np.flatnonzero(np.asarray(counts) > 0)
    imp_tol = rtol * max(np.abs(a.impurity).max(), 1e-300)
    val_tol = rtol * max(np.abs(a.values).max(), 1e-300)
    out = {"nodes": 0, "other_feature": 0, "swapped": 0, "ok": True,
           "first_failure": None}
    stack = [(0, 0, samples)]
    while stack:
        i, j, s = stack.pop()
        out["nodes"] += 1
        same = (a.n_node_samples[i] == b.n_node_samples[j]
                and a.weighted_n_node_samples[i]
                == b.weighted_n_node_samples[j]
                and abs(a.impurity[i] - b.impurity[j]) <= imp_tol
                and np.abs(a.values[i] - b.values[j]).max() <= val_tol
                and (a.left_child[i] == skp.TREE_LEAF)
                == (b.left_child[j] == skp.TREE_LEAF))
        if not same:
            out["ok"], out["first_failure"] = False, (int(i), int(j))
            break
        if a.left_child[i] == skp.TREE_LEAF:
            continue
        go_a = X32[s, a.feature[i]] <= a.threshold[i]
        go_b = X32[s, b.feature[j]] <= b.threshold[j]
        if a.feature[i] != b.feature[j] or a.threshold[i] != b.threshold[j]:
            out["other_feature"] += 1
        pairs = ((a.left_child[i], b.left_child[j], go_a),
                 (a.right_child[i], b.right_child[j], ~go_a))
        if not np.array_equal(go_a, go_b):
            if not np.array_equal(go_a, ~go_b):
                out["ok"], out["first_failure"] = False, (int(i), int(j))
                break
            out["swapped"] += 1
            pairs = ((a.left_child[i], b.right_child[j], go_a),
                     (a.right_child[i], b.left_child[j], ~go_a))
        for ai, bj, go in reversed(pairs):
            stack.append((ai, bj, s[go]))
    return out


class Forest:
    """Trees on the host (``trees``) and their stacked node arrays on a
    device for prediction."""

    def __init__(self, trees: List[TreeArrays], seeds: List[int]):
        self.trees = list(trees)
        self.seeds = list(seeds)
        self._device_arrays = {}

    def _stacked(self, device):
        key = str(device)
        if key not in self._device_arrays:
            offsets = np.cumsum([0] + [len(t.feature) for t in self.trees])
            left, right, feat, thr, vals = [], [], [], [], []
            for off, t in zip(offsets, self.trees):
                is_leaf = t.left_child == skp.TREE_LEAF
                left.append(np.where(is_leaf, -1, t.left_child + off))
                right.append(np.where(is_leaf, -1, t.right_child + off))
                feat.append(np.where(is_leaf, 0, t.feature))
                thr.append(t.threshold)
                vals.append(t.values)

            def cat(parts, dtype):
                return torch.as_tensor(np.concatenate(parts), dtype=dtype,
                                       device=device)

            self._device_arrays[key] = (
                torch.as_tensor(offsets[:-1], device=device),
                cat(left, torch.int64), cat(right, torch.int64),
                cat(feat, torch.int64), cat(thr, torch.float64),
                cat(vals, torch.float64),
                max(t.depth for t in self.trees))
        return self._device_arrays[key]

    def predict(self, X: torch.Tensor) -> torch.Tensor:
        """The mean of the trees' predictions [n, O] (float64) at X cast
        to float32, as ``RandomForestRegressor.predict``."""
        roots, left, right, feat, thr, vals, depth = self._stacked(X.device)
        Xf = X.to(torch.float32).to(torch.float64)
        node = roots[:, None].expand(len(roots), X.shape[0]).contiguous()
        cols = torch.arange(X.shape[0], device=X.device)[None, :]
        for _ in range(depth):
            go_left = Xf[cols, feat[node]] <= thr[node]
            nxt = torch.where(go_left, left[node], right[node])
            node = torch.where(nxt >= 0, nxt, node)
        per_tree = vals[node]  # [T, n, O]
        out = per_tree[0].clone()
        for t in range(1, len(self.trees)):
            out += per_tree[t]
        return out / len(self.trees)


def fit_forest(X: torch.Tensor, Y: torch.Tensor, n_estimators: int = 100,
               max_depth: Optional[int] = None, min_samples_leaf: int = 1,
               random_state=0) -> Forest:
    """``RandomForestRegressor(...).fit(X, Y)`` on ``X``'s device."""
    X = X.to(torch.float32)
    n = X.shape[0]
    ranks = feature_ranks(X)
    seeds = tree_seeds(random_state, n_estimators)
    trees = [fit_tree(X, Y, torch.as_tensor(bootstrap_counts(s, n)),
                      max_depth, min_samples_leaf, ranks) for s in seeds]
    return Forest(trees, seeds)


@io.register("sklearn_random_forest")
class RandomForestModel(Predictor):
    """Packed [sample, feature] inputs through the forest to packed
    outputs, on the inputs' device; outputs in the inputs' float dtype."""

    def __init__(self, input_variables, output_variables, forest: Forest,
                 input_info, output_info, hyperparameters=None,
                 n_samples: int = 0):
        super().__init__(list(input_variables), list(output_variables))
        self.forest = forest
        self.input_info = input_info
        self.output_info = output_info
        self.hyperparameters = (hyperparameters
                                or RandomForestHyperparameters())
        self.n_samples = n_samples

    def to(self, device=None, dtype=None):
        return self

    @torch.no_grad()
    def predict(self, X: Dataset) -> Dataset:
        data = packer.dataset_to_samples(X, self.input_variables)
        Xp, _ = packer.pack(data, self.input_variables)
        dtype = Xp.dtype if Xp.is_floating_point() else torch.float64
        Y = self.forest.predict(Xp).to(dtype)
        return packer.samples_to_dataset(packer.unpack(Y, self.output_info))

    def feature_importances(self):
        """Per-input importance mean and std across the trees, split by
        packed input variable (reference feature_importances)."""
        nf = self.input_info.total_features
        per_tree = np.stack([t.feature_importances(nf)
                             for t in self.forest.trees])
        mean, std = per_tree.mean(axis=0), per_tree.std(axis=0)
        return {name: (mean[sl], std[sl])
                for name, sl in self.input_info.slices().items()}

    def _sklearn_model(self):
        hp = self.hyperparameters
        nf = self.input_info.total_features
        trees = [skp.decision_tree(t.nodes(), t.values, nf, hp.max_depth,
                                   hp.min_samples_leaf, seed)
                 for t, seed in zip(self.forest.trees, self.forest.seeds)]
        return skp.random_forest(
            trees, self.n_samples, nf, self.output_info.total_features,
            len(trees), hp.max_depth, hp.min_samples_leaf, hp.n_jobs,
            hp.random_state)

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        skp.dump(self._sklearn_model(), os.path.join(path, "regressor.pkl"))
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump({
                "input_variables": self.input_variables,
                "output_variables": self.output_variables,
                "input_info": _info_dict(self.input_info),
                "output_info": _info_dict(self.output_info),
            }, f)

    @classmethod
    def load(cls, path: str) -> "RandomForestModel":
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        model = skp.load(os.path.join(path, "regressor.pkl"))
        forest = Forest([TreeArrays.from_estimator(e)
                         for e in model.estimators_],
                        [e.random_state for e in model.estimators_])
        hp = RandomForestHyperparameters(
            list(meta["input_variables"]), list(meta["output_variables"]),
            n_estimators=model.n_estimators, max_depth=model.max_depth,
            min_samples_leaf=model.min_samples_leaf, n_jobs=model.n_jobs,
            random_state=model.random_state)
        return cls(meta["input_variables"], meta["output_variables"], forest,
                   _info(meta["input_info"]), _info(meta["output_info"]),
                   hp, getattr(model, "_n_samples", 0))


@register_training_function("sklearn_random_forest",
                            RandomForestHyperparameters)
def train_random_forest(hp: RandomForestHyperparameters, train_batches,
                        val=None) -> RandomForestModel:
    """The forest on all batches' packed samples, on their device."""
    xs, ys = [], []
    x_info = y_info = None
    for ds in train_batches:
        data = packer.dataset_to_samples(
            ds, list(hp.input_variables) + list(hp.output_variables))
        X, x_info = packer.pack(data, hp.input_variables)
        Y, y_info = packer.pack(data, hp.output_variables)
        xs.append(X)
        ys.append(Y)
    X, Y = torch.cat(xs), torch.cat(ys)
    forest = fit_forest(X, Y, hp.n_estimators, hp.max_depth,
                        hp.min_samples_leaf, hp.random_state)
    return RandomForestModel(hp.input_variables, hp.output_variables,
                             forest, x_info, y_info, hp, X.shape[0])
