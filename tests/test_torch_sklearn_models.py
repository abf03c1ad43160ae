"""The scikit-learn models of the port (``fit/one_class_svm.py``,
``fit/random_forest.py``, ``fit/_sklearn_pickle.py``, the ``ocsvm``
detector of ``fit/novelty.py``) held against ``fv3net_tpu.fit``, whose
models are scikit-learn's own, on seeded float64 inputs:

- the one-class SVM's decision values against the reference's fit at
  scikit-learn's tol (1e-3) and at a tight tol (the solver's keyword);
- the random forest under the rule a tie cannot change
  (``random_forest.match_trees``), and a shallow forest tree for tree;
- each package loads the other's ``model.pkl`` / ``regressor.pkl``, and
  the port's reader imports no scikit-learn (a subprocess);
- the reference's random-forest input sensitivity.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (torch threads under xdist)

from fv3net_torch.core.dataset import Dataset
from fv3net_torch.core.quantity import Quantity
from fv3net_torch.fit import io, novelty, one_class_svm, random_forest
from fv3net_torch.fit import train as ttrain

jax.config.update("jax_enable_x64", True)

N, NZ = 240, 3
IN = ["air_temperature", "specific_humidity"]
OUT = ["dQ1", "dQ2"]


def _columns(seed=0, n=N):
    rng = np.random.RandomState(seed)
    T = 260 + 30 * rng.rand(n, NZ)
    q = 0.01 * rng.rand(n, NZ)
    return {"air_temperature": T, "specific_humidity": q,
            "dQ1": 1e-5 * (np.sin(T / 7.0) + rng.randn(n, NZ)),
            "dQ2": 1e-7 * (q * 300 + rng.randn(n, NZ))}


def _datasets(cols):
    from fv3net_tpu.core.dataset import Dataset as JDataset
    from fv3net_tpu.core.quantity import Quantity as JQuantity

    jds = JDataset({k: JQuantity(jnp.asarray(v), ("sample", "z"))
                    for k, v in cols.items()})
    tds = Dataset({k: Quantity(torch.tensor(v), ("sample", "z"))
                   for k, v in cols.items()})
    return jds, tds


def _scale(x):
    return float(np.abs(x).max())


# ------------------------------------------------------------ the SVM
@pytest.mark.parametrize("tol,rtol", [(1e-3, 1e-3), (1e-10, 1e-9)])
def test_ocsvm_matches_reference_fit(tol, rtol):
    """Decision values of the port's fit against scikit-learn's, within
    the stopping gap at tol 1e-3 and tightly at tol 1e-10, relative to
    their scale (the solver takes libsvm's pairs; libsvm's shrinking may
    change which pair near convergence)."""
    from sklearn.svm import OneClassSVM

    jds, tds = _datasets(_columns(1))
    test_j, test_t = _datasets(_columns(2, 60))
    X = np.concatenate([_columns(1)[k] for k in IN], axis=1)
    Xt = np.concatenate([_columns(2, 60)[k] for k in IN], axis=1)
    want = OneClassSVM(gamma="scale", nu=0.1, tol=tol).fit(X)
    det = novelty.OCSVMNoveltyDetector(IN).fit(tds, nu=0.1, tol=tol)
    got = det.decision_function(torch.tensor(Xt)).numpy()
    ref = want.decision_function(Xt)
    assert det.svm.gamma == want._gamma
    assert np.abs(got - ref).max() <= rtol * _scale(ref)
    # the detector's score is the reference's -decision_function
    from fv3net_tpu.fit import novelty as jnov

    jdet = jnov.OCSVMNoveltyDetector(IN)
    jdet.fit(jds)
    if tol == 1e-3:
        np.testing.assert_allclose(
            det._score(test_t).numpy(), np.asarray(jdet._score(test_j)),
            rtol=0, atol=rtol * _scale(ref))


def test_ocsvm_trainer_and_pickles_both_ways(tmp_path):
    """The registered trainer (first batch only) on both sides; the
    port's ``model.pkl`` loads in scikit-learn and the reference's in
    the port, scoring the same (float64 roundoff)."""
    from fv3net_tpu.fit import io as jio
    from fv3net_tpu.fit import train as jtrain
    from fv3net_tpu.fit.novelty import OCSVMNoveltyDetectorHyperparameters

    jds, tds = _datasets(_columns(3))
    jds2, tds2 = _datasets(_columns(4))
    test_j, test_t = _datasets(_columns(5, 50))
    hp = OCSVMNoveltyDetectorHyperparameters(input_variables=IN)
    jdet = jtrain.get_training_function("ocsvm_novelty_detector")(
        hp, [jds, jds2])
    tdet = ttrain.get_training_function("ocsvm_novelty_detector")(
        ttrain.get_hyperparameter_class("ocsvm_novelty_detector")(
            input_variables=IN), [tds, tds2])
    want = np.asarray(jdet._score(test_j))
    got = tdet._score(test_t).numpy()
    assert np.abs(got - want).max() <= 1e-3 * _scale(want)
    jio.dump(jdet, str(tmp_path / "ref"))
    io.dump(tdet, str(tmp_path / "port"))
    back_t = io.load(str(tmp_path / "ref"))
    back_j = jio.load(str(tmp_path / "port"))
    # a decision value is K @ coef - rho, a difference of terms ~40x its
    # scale here: summation order shows at 1e-13 of scale
    np.testing.assert_allclose(back_t._score(test_t).numpy(), want,
                               rtol=0, atol=1e-12 * _scale(want))
    np.testing.assert_allclose(np.asarray(back_j._score(test_j)), got,
                               rtol=0, atol=1e-12 * _scale(got))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref"))


# ------------------------------------------------------------ the forest
def _forest_pair(max_depth, min_samples_leaf, n_estimators=3, seed=6):
    from fv3net_tpu.fit.random_forest import (
        RandomForestHyperparameters, train_random_forest)

    cols = _columns(seed)
    jds, tds = _datasets(cols)
    kw = dict(input_variables=IN, output_variables=OUT,
              n_estimators=n_estimators, max_depth=max_depth,
              min_samples_leaf=min_samples_leaf, random_state=0)
    jmodel = train_random_forest(RandomForestHyperparameters(**kw), [jds])
    tmodel = ttrain.get_training_function("sklearn_random_forest")(
        random_forest.RandomForestHyperparameters(**kw), [tds])
    X = np.concatenate([cols[k] for k in IN], axis=1)
    return jmodel, tmodel, X


@pytest.mark.parametrize("min_samples_leaf", [1, 3])
def test_forest_matches_reference_under_the_tie_rule(min_samples_leaf):
    """Full depth: each tree's seed and bootstrap are scikit-learn's, and
    walking scikit-learn's tree depth first every node's samples,
    n_node_samples and weighted_n_node_samples are equal, impurity and
    values within 1e-9 of scale; a split differs only where both put
    the node's samples into the same two sets."""
    jmodel, tmodel, X = _forest_pair(None, min_samples_leaf)
    seeds = [e.random_state for e in jmodel.regressor.estimators_]
    assert tmodel.forest.seeds == seeds
    ties = 0
    for est, tree, seed in zip(jmodel.regressor.estimators_,
                               tmodel.forest.trees, seeds):
        counts = random_forest.bootstrap_counts(seed, X.shape[0])
        t = est.tree_
        assert t.weighted_n_node_samples[0] == counts.sum()
        got = random_forest.match_trees(
            random_forest.TreeArrays(
                t.children_left, t.children_right, t.feature, t.threshold,
                t.impurity, t.n_node_samples, t.weighted_n_node_samples,
                t.missing_go_to_left, t.value[:, :, 0]),
            tree, X, counts)
        assert got["ok"] and got["nodes"] == t.node_count, got
        ties += got["other_feature"]
    if min_samples_leaf == 1:
        assert ties > 0  # their leaves of one sample do tie


def test_shallow_forest_tree_for_tree():
    """At max_depth 2 on continuous data no split ties: every tree is
    scikit-learn's node for node (features, thresholds, children and
    sample counts equal; impurity and values within 1e-12 of scale), and
    the forests predict the same."""
    jmodel, tmodel, X = _forest_pair(2, 1, n_estimators=4)
    for est, tree in zip(jmodel.regressor.estimators_, tmodel.forest.trees):
        t = est.tree_
        for name in ("children_left", "children_right", "feature",
                     "threshold", "n_node_samples", "weighted_n_node_samples",
                     "missing_go_to_left"):
            ours = getattr(tree, {"children_left": "left_child",
                                  "children_right": "right_child"}.get(
                                      name, name))
            np.testing.assert_array_equal(ours, getattr(t, name), name)
        np.testing.assert_allclose(tree.impurity, t.impurity, rtol=0,
                                   atol=1e-12 * _scale(t.impurity))
        np.testing.assert_allclose(tree.values, t.value[:, :, 0], rtol=0,
                                   atol=1e-12 * _scale(t.value))
    test_j, test_t = _datasets(_columns(7, 40))
    want, got = jmodel.predict(test_j), tmodel.predict(test_t)
    for k in OUT:
        np.testing.assert_allclose(got[k].data.numpy(),
                                   np.asarray(want[k].data), rtol=0,
                                   atol=1e-12 * _scale(want[k].data))


def test_forest_pickles_both_ways_and_importances(tmp_path):
    """The reference's ``regressor.pkl`` loads in the port and the
    port's in the reference (scikit-learn), each predicting as its
    writer; the random-forest input sensitivity of the same forest
    through both packages."""
    from fv3net_tpu.fit import io as jio
    from fv3net_tpu.fit.input_sensitivity import input_sensitivity as jsens

    from fv3net_torch.fit.input_sensitivity import input_sensitivity as tsens

    jmodel, tmodel, _ = _forest_pair(None, 2)
    test_j, test_t = _datasets(_columns(8, 40))
    jio.dump(jmodel, str(tmp_path / "ref"))
    io.dump(tmodel, str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref"))
    back_t = io.load(str(tmp_path / "ref"))
    back_j = jio.load(str(tmp_path / "port"))
    for got, want in ((back_t.predict(test_t), jmodel.predict(test_j)),
                      (back_j.predict(test_j), tmodel.predict(test_t))):
        for k in OUT:
            g = np.asarray(got[k].data)
            w = np.asarray(want[k].data)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-13 * _scale(w))
    want = jsens(jmodel, None).rf_feature_importances
    got = tsens(back_t, None).rf_feature_importances
    assert sorted(got) == sorted(want) == sorted(IN)
    for k in IN:
        np.testing.assert_allclose(got[k].mean_importances,
                                   want[k].mean_importances, atol=1e-13)
        np.testing.assert_allclose(got[k].std_importances,
                                   want[k].std_importances, atol=1e-13)
        assert got[k].indices == want[k].indices


def test_reader_imports_no_scikit_learn(tmp_path):
    """The reference's pickles load and predict in a process where
    scikit-learn is never imported."""
    from fv3net_tpu.fit import io as jio
    from fv3net_tpu.fit import novelty as jnov

    jmodel, _, _ = _forest_pair(2, 1, n_estimators=2)
    jio.dump(jmodel, str(tmp_path / "rf"))
    jds, _ = _datasets(_columns(9))
    det = jnov.OCSVMNoveltyDetector(IN)
    det.fit(jds)
    jio.dump(det, str(tmp_path / "svm"))
    code = (
        "import sys, numpy as np, torch\n"
        "from fv3net_torch.core.dataset import Dataset\n"
        "from fv3net_torch.core.quantity import Quantity\n"
        "from fv3net_torch.fit import io\n"
        "x = torch.tensor(np.random.RandomState(0).rand(5, 3))\n"
        "ds = Dataset({k: Quantity(x, ('sample', 'z')) for k in\n"
        "              ('air_temperature', 'specific_humidity')})\n"
        f"rf = io.load({str(tmp_path / 'rf')!r})\n"
        f"svm = io.load({str(tmp_path / 'svm')!r})\n"
        "assert rf.predict(ds)['dQ1'].data.shape == (5, 3)\n"
        "assert svm._score(ds).shape == (5,)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('sklearn', 'jax', 'fv3net_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_unpickler_refuses_other_globals(tmp_path):
    """A global outside the two pickles' numpy and scikit-learn names
    raises instead of loading."""
    import pickle

    from fv3net_torch.fit import _sklearn_pickle

    path = str(tmp_path / "bad.pkl")
    with open(path, "wb") as f:
        pickle.dump({"f": os.system}, f)
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        _sklearn_pickle.load(path)
    meta = {"input_variables": IN, "info": {"names": IN, "features": [3, 3]}}
    os.makedirs(tmp_path / "svm")
    (tmp_path / "svm" / "metadata.json").write_text(json.dumps(meta))
    os.replace(path, str(tmp_path / "svm" / "model.pkl"))
    with pytest.raises(pickle.UnpicklingError):
        novelty.OCSVMNoveltyDetector.load(str(tmp_path / "svm"))


def test_solver_start_and_rho_follow_libsvm():
    """libsvm's initial alphas (floor(nu l) at 1, then the remainder of
    its accumulated nu l) and the support vectors' sum nu * l."""
    a = one_class_svm.initial_alpha(47, 0.1)
    assert list(a[:4]) == [1.0] * 4 and 0 < a[4] < 1 and not a[5:].any()
    assert a.sum() == pytest.approx(4.7, abs=1e-12)
    X = torch.tensor(np.random.RandomState(3).randn(47, 4))
    fit = one_class_svm.fit(X, nu=0.1)
    assert float(fit.dual_coef.sum()) == pytest.approx(4.7, abs=1e-12)
    assert bool((fit.dual_coef > 0).all() & (fit.dual_coef <= 1).all())

