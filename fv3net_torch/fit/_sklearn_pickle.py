"""scikit-learn artifacts without scikit-learn: the pickles of the
reference's ``ocsvm`` (``model.pkl``, a ``sklearn.svm.OneClassSVM``) and
``sklearn_random_forest`` (``regressor.pkl``, a
``sklearn.ensemble.RandomForestRegressor``) read and written with the
standard library's pickle and numpy only.

Reading: :func:`load` unpickles with a restricted unpickler that admits
only the numpy globals of an array or scalar and the four scikit-learn
classes of these two pickles (``OneClassSVM``, ``RandomForestRegressor``,
``DecisionTreeRegressor`` and ``sklearn.tree._tree.Tree``).  Each
scikit-learn class maps to a plain holder of its pickled state
(:class:`Estimator`; :class:`Tree` also keeps its constructor's
``(n_features, n_classes, n_outputs)``).  Any other global raises
``pickle.UnpicklingError``.

Writing: :func:`dump` pickles holders with the pure-Python
``pickle._Pickler``, whose ``save_global`` is overridden to write a
holder class under its scikit-learn name without importing it.  The
states built by :func:`one_class_svm` and :func:`random_forest` hold
what scikit-learn 1.9 pickles for a fitted estimator, so that where
scikit-learn is installed the file loads as the fitted estimator.
"""
from __future__ import annotations

import copyreg
import io
import pickle
from typing import Dict, Sequence

import numpy as np

#: the scikit-learn release whose pickled states the writer reproduces
SKLEARN_VERSION = "1.9.0"

#: a decision tree's node record (sklearn.tree._tree.NODE_DTYPE)
NODE_DTYPE = np.dtype({
    "names": ["left_child", "right_child", "feature", "threshold",
              "impurity", "n_node_samples", "weighted_n_node_samples",
              "missing_go_to_left"],
    "formats": [np.intp, np.intp, np.intp, np.float64, np.float64, np.intp,
                np.float64, np.uint8],
})
TREE_LEAF = -1
TREE_UNDEFINED = -2


class Estimator:
    """The pickled state of a scikit-learn estimator, as attributes."""

    SKLEARN_PATH = ("", "")

    def __setstate__(self, state: Dict) -> None:
        self.__dict__.update(state)

    def __reduce_ex__(self, protocol):
        return copyreg.__newobj__, (type(self),), dict(self.__dict__)


class OneClassSVM(Estimator):
    SKLEARN_PATH = ("sklearn.svm._classes", "OneClassSVM")


class RandomForestRegressor(Estimator):
    SKLEARN_PATH = ("sklearn.ensemble._forest", "RandomForestRegressor")


class DecisionTreeRegressor(Estimator):
    SKLEARN_PATH = ("sklearn.tree._classes", "DecisionTreeRegressor")


class Tree:
    """``sklearn.tree._tree.Tree``: its constructor's arguments and its
    state (``max_depth``, ``node_count``, ``nodes`` records of
    :data:`NODE_DTYPE` and ``values`` [node, output, 1])."""

    SKLEARN_PATH = ("sklearn.tree._tree", "Tree")

    def __init__(self, n_features, n_classes, n_outputs):
        self.n_features = int(n_features)
        self.n_classes = np.asarray(n_classes)
        self.n_outputs = int(n_outputs)
        self.state: Dict = {}

    def __setstate__(self, state: Dict) -> None:
        self.state = dict(state)

    def __reduce__(self):
        return (type(self), (self.n_features, self.n_classes,
                             self.n_outputs), self.state)


_HOLDERS = {cls.SKLEARN_PATH: cls for cls in (
    OneClassSVM, RandomForestRegressor, DecisionTreeRegressor, Tree)}


def _numpy_globals() -> Dict:
    """The numpy callables a pickled array or scalar names, under the
    module names of numpy 1 and numpy 2."""
    reconstruct = np.zeros(1).__reduce_ex__(4)[0]
    frombuffer = np.zeros(1).__reduce_ex__(5)[0]
    scalar = np.float64(0).__reduce__()[0]
    out = {("numpy", "ndarray"): np.ndarray, ("numpy", "dtype"): np.dtype}
    for core in ("numpy.core", "numpy._core"):
        out[(core + ".multiarray", "_reconstruct")] = reconstruct
        out[(core + ".multiarray", "scalar")] = scalar
        out[(core + ".numeric", "_frombuffer")] = frombuffer
    return out


class _Unpickler(pickle.Unpickler):
    _allowed = {**_numpy_globals(), **_HOLDERS}

    def find_class(self, module, name):
        try:
            return self._allowed[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"global {module}.{name} is not allowed in a scikit-learn "
                "artifact") from None


def load(path: str):
    """The holder tree of the pickle at ``path``."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


class _Pickler(pickle._Pickler):
    def save_global(self, obj, name=None):
        path = getattr(obj, "SKLEARN_PATH", None)
        if path is None or _HOLDERS.get(path) is not obj:
            return super().save_global(obj, name)
        # the holder under its scikit-learn name, not imported
        self.save(path[0])
        self.save(path[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def dump(obj, path: str) -> None:
    """Pickle a holder tree (protocol 4, as the reference's
    ``pickle.dump``) to ``path``."""
    buf = io.BytesIO()
    _Pickler(buf, protocol=4).dump(obj)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


# ----------------------------------------------------------------- states
def one_class_svm(support: np.ndarray, support_vectors: np.ndarray,
                  dual_coef: np.ndarray, rho: float, gamma: float,
                  n_samples: int, n_iter: int, nu: float = 0.1,
                  gamma_param="scale", tol: float = 1e-3) -> OneClassSVM:
    """A fitted ``OneClassSVM(kernel="rbf")`` of these support vectors
    (rows of the training data ``support``), ``dual_coef`` [n_SV] and
    ``rho`` (the decision function is K(x, SV) @ dual_coef - rho)."""
    n_sv, n_features = support_vectors.shape
    dual = np.asarray(dual_coef, np.float64).reshape(1, n_sv)
    intercept = np.asarray([-rho], np.float64)
    model = OneClassSVM()
    model.__setstate__({
        "C": 0.0, "_dual_coef_": dual, "_effective_probability": False,
        "_gamma": np.float64(gamma), "_intercept_": intercept.copy(),
        "_n_support": np.asarray([n_sv, n_sv], np.int32),
        "_num_iter": np.asarray([n_iter], np.int32),
        "_probA": np.empty(0, np.float64), "_probB": np.empty(0, np.float64),
        "_sklearn_version": SKLEARN_VERSION, "_sparse": False,
        "cache_size": 200, "class_weight": None, "coef0": 0.0, "degree": 3,
        "dual_coef_": dual.copy(), "epsilon": 0.0, "fit_status_": 0,
        "gamma": gamma_param, "intercept_": intercept.copy(),
        "kernel": "rbf", "max_iter": -1, "n_features_in_": int(n_features),
        "n_iter_": int(n_iter), "nu": float(nu),
        "offset_": np.asarray([rho], np.float64), "probability": False,
        "random_state": None, "shape_fit_": (int(n_samples),
                                             int(n_features)),
        "shrinking": True,
        "support_": np.asarray(support, np.int32),
        "support_vectors_": np.ascontiguousarray(support_vectors,
                                                 np.float64),
        "tol": float(tol), "verbose": False,
    })
    return model


_TREE_PARAMS = {
    "ccp_alpha": 0.0, "class_weight": None, "criterion": "squared_error",
    "max_leaf_nodes": None, "min_impurity_decrease": 0.0,
    "min_samples_split": 2, "min_weight_fraction_leaf": 0.0,
    "monotonic_cst": None, "splitter": "best",
}


def _unfitted_tree() -> DecisionTreeRegressor:
    est = DecisionTreeRegressor()
    est.__setstate__({**_TREE_PARAMS, "_sklearn_version": SKLEARN_VERSION,
                      "max_depth": None, "max_features": None,
                      "min_samples_leaf": 1, "random_state": None})
    return est


def decision_tree(nodes: np.ndarray, values: np.ndarray, n_features: int,
                  max_depth, min_samples_leaf: int, seed: int
                  ) -> DecisionTreeRegressor:
    """A fitted tree of a random forest: ``nodes`` records of
    :data:`NODE_DTYPE` in scikit-learn's depth-first order, ``values``
    [node, output]."""
    n_outputs = values.shape[1]
    tree = Tree(n_features, np.ones(n_outputs, np.intp), n_outputs)
    depth = np.zeros(len(nodes), np.int64)
    for i, node in enumerate(nodes):  # parents come before children
        if node["left_child"] != TREE_LEAF:
            depth[node["left_child"]] = depth[node["right_child"]] = (
                depth[i] + 1)
    tree.__setstate__({
        "max_depth": int(depth.max()), "node_count": int(len(nodes)),
        "nodes": np.ascontiguousarray(nodes, NODE_DTYPE),
        "values": np.ascontiguousarray(values, np.float64)[:, :, None],
    })
    est = DecisionTreeRegressor()
    est.__setstate__({
        **_TREE_PARAMS, "_sklearn_version": SKLEARN_VERSION,
        "max_depth": max_depth, "max_features": 1.0,
        "max_features_": int(n_features),
        "min_samples_leaf": int(min_samples_leaf),
        "n_features_in_": int(n_features), "n_outputs_": int(n_outputs),
        "random_state": int(seed), "tree_": tree,
    })
    return est


def random_forest(trees: Sequence[DecisionTreeRegressor], n_samples: int,
                  n_features: int, n_outputs: int, n_estimators: int,
                  max_depth, min_samples_leaf: int, n_jobs, random_state
                  ) -> RandomForestRegressor:
    """A fitted ``RandomForestRegressor`` of these trees (bootstrap,
    ``max_features=1.0``, the squared error)."""
    model = RandomForestRegressor()
    model.__setstate__({
        "_n_samples": int(n_samples), "_n_samples_bootstrap": int(n_samples),
        "_sample_weight": None, "_sklearn_version": SKLEARN_VERSION,
        "bootstrap": True, "ccp_alpha": 0.0, "class_weight": None,
        "criterion": "squared_error", "estimator": _unfitted_tree(),
        "estimator_": _unfitted_tree(),
        "estimator_params": (
            "criterion", "max_depth", "min_samples_split",
            "min_samples_leaf", "min_weight_fraction_leaf", "max_features",
            "max_leaf_nodes", "min_impurity_decrease", "random_state",
            "ccp_alpha", "monotonic_cst"),
        "estimators_": list(trees), "max_depth": max_depth,
        "max_features": 1.0, "max_leaf_nodes": None, "max_samples": None,
        "min_impurity_decrease": 0.0,
        "min_samples_leaf": int(min_samples_leaf), "min_samples_split": 2,
        "min_weight_fraction_leaf": 0.0, "monotonic_cst": None,
        "n_estimators": int(n_estimators), "n_features_in_": int(n_features),
        "n_jobs": n_jobs, "n_outputs_": int(n_outputs), "oob_score": False,
        "random_state": random_state, "verbose": 0, "warm_start": False,
    })
    return model


def tree_arrays(est) -> Dict[str, np.ndarray]:
    """A fitted tree holder's node fields and values [node, output]."""
    state = est.tree_.state
    nodes = np.asarray(state["nodes"])
    out = {name: np.asarray(nodes[name]) for name in nodes.dtype.names}
    out["values"] = np.asarray(state["values"])[:, :, 0]
    return out
