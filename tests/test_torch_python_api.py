"""The rest of the port's Python API against the JAX package, on the CPU.

``cv`` (stratified, shuffled and group folds, early stopping, the per-fold
boosters), pickling a ``Booster`` (onto the device type it was on),
pandas input with category columns, the sklearn estimators
(``LGBMClassifier`` with string labels, ``LGBMRegressor`` with early
stopping, the multiclass classifier and ``LGBMRanker``) with sklearn and,
in a subprocess, with sklearn and pandas hidden (``compat.py``'s
fallbacks, the path of a machine without them), ``Dataset.save_binary``,
``subset`` and the ``set_``/``get_`` fields.  The JAX package's estimators
are given their objective, which they would otherwise leave at regression
(ROADMAP queue 3); the port's train their default.  Both packages train with
``max_bin=63`` (at 255 bins near-tied gains are decided by f32 rounding,
which differs between XLA and PyTorch); trees are held to
``test_torch_objectives.assert_same_trees`` and predictions to 1e-4.  The
classifier runs on 1,000 rows: at 600 its trees differ from the JAX
package's by one near-tied split, the f32 gain rounding of ROADMAP queue 3.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as J
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_objectives import assert_same_trees
from test_torch_quant import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DS = {"max_bin": 63, "verbosity": -1}
ATOL = 1e-4


def make_binary(n=1000, f=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    logit = X[:, 0] * 2 + X[:, 1] ** 2 - 1 + rng.normal(scale=0.5, size=n)
    return X, (logit > 0).astype(np.float64)


def make_regression(n=1000, f=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    return X, X[:, 0] * 3 + np.sin(X[:, 1]) + rng.normal(scale=0.2, size=n)


def make_rank(n_q=30, per_q=20, seed=1):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n_q * per_q, 5))
    y = np.clip(X[:, 0] + rng.normal(scale=0.3, size=len(X)), 0, None)
    return X, np.digitize(y, [0.5, 1.2]).astype(float), np.full(n_q, per_q)


# ---- cv ----


@pytest.mark.parametrize("kind", ["stratified", "shuffled", "lambdarank"])
def test_cv_matches_jax(kind, one_thread):
    params = dict(objective="binary", metric="binary_logloss", num_leaves=7,
                  **DS)
    kw = dict(num_boost_round=6, nfold=3, verbose_eval=False)
    if kind == "lambdarank":
        X, y, group = make_rank()
        params.update(objective="lambdarank", metric="ndcg",
                      ndcg_eval_at=[3])
        dsets = (P.Dataset(X, y, group=group, params=DS),
                 J.Dataset(X, y, group=group, params=DS))
    else:
        X, y = make_binary()
        kw.update(stratified=kind == "stratified", seed=4)
        dsets = (P.Dataset(X, y, params=DS), J.Dataset(X, y, params=DS))
    got = P.cv(params, dsets[0], device="cpu", **kw)
    want = J.cv(params, dsets[1], **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5)
    first = sorted(got)[0]
    assert len(got[first]) == 6


def test_cv_early_stopping_and_cvbooster(one_thread):
    X, y = make_regression()
    params = dict(objective="regression", metric="l2", num_leaves=31,
                  learning_rate=0.5, **DS)
    kw = dict(num_boost_round=60, nfold=3, stratified=False,
              early_stopping_rounds=3, return_cvbooster=True,
              eval_train_metric=True, verbose_eval=False)
    got = P.cv(params, P.Dataset(X, y, params=DS), device="cpu", **kw)
    want = J.cv(params, J.Dataset(X, y, params=DS), **kw)
    cvb = got.pop("cvbooster")
    jcvb = want.pop("cvbooster")
    assert cvb.best_iteration == jcvb.best_iteration
    assert 0 < cvb.best_iteration < 60
    assert len(got["valid l2-mean"]) == cvb.best_iteration
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    assert len(cvb.boosters) == 3
    preds = cvb.predict(X[:50])
    assert len(preds) == 3 and preds[0].shape == (50,)


def test_cv_refuses_non_dataset():
    with pytest.raises(TypeError):
        P.cv({}, np.zeros((10, 2)), device="cpu")


# ---- pickling ----


def test_pickle_booster(one_thread):
    X, y = make_binary(800)
    bst = P.train(dict(objective="binary", num_leaves=7, **DS),
                  P.Dataset(X, y, params=DS), num_boost_round=10,
                  verbose_eval=False, device="cpu")
    bst.best_iteration = 8
    state = bst.__getstate__()
    assert state["device"] == "cpu"
    bst2 = pickle.loads(pickle.dumps(bst))
    assert bst2.device.type == "cpu"
    assert bst2.best_iteration == 8
    np.testing.assert_array_equal(bst2.predict(X), bst.predict(X))
    assert bst2.model_to_string() == bst.model_to_string()
    # a booster pickled on the card unpickles onto the card only
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            P.Booster.__new__(P.Booster).__setstate__(dict(state,
                                                           device="cuda"))


# ---- pandas ----


def test_pandas_and_categorical(one_thread):
    pd = pytest.importorskip("pandas")
    rng = np.random.RandomState(3)
    n = 1200
    cat = rng.randint(0, 4, size=n)
    num = rng.normal(size=n)
    y = (cat == 2).astype(float) * 2 + num + rng.normal(scale=0.1, size=n)

    def frame():
        return pd.DataFrame({
            "c": pd.Categorical.from_codes(cat, ["a", "b", "c", "d"]),
            "x": num, "k": (cat % 2).astype(np.int32)})
    params = dict(objective="regression", num_leaves=15, **DS)
    bst = P.train(params, P.Dataset(frame(), label=y, params=DS),
                  num_boost_round=10, verbose_eval=False, device="cpu")
    ref = J.train(params, J.Dataset(frame(), label=y, params=DS),
                  num_boost_round=10, verbose_eval=False)
    assert bst.feature_name() == ["c", "x", "k"]
    assert_same_trees(ref._booster.models, bst._booster.models)
    assert any(t.decision_type[0] & 1 for t in bst._booster.models)
    np.testing.assert_allclose(bst.predict(frame()), ref.predict(frame()),
                               rtol=0, atol=ATOL)
    names = P.Dataset(frame(), label=y, params=DS,
                      categorical_feature=["x"]).construct()
    assert names.handle.bin_mappers[1].bin_type != \
        names.handle.bin_mappers[2].bin_type
    bad = pd.DataFrame({"s": ["a"] * 5})
    with pytest.raises(LightGBMError, match="int, float or bool"):
        P.Dataset(bad, label=np.zeros(5)).construct()


# ---- sklearn ----


def _sklearn_runs(mod):
    """The four estimators of ``mod`` (either package) on fixed data:
    {name: predictions}."""
    out = {}
    kw = {} if mod is J else {"device": "cpu"}

    def objective(name):
        # the JAX package's estimators train objective=regression unless
        # given one (ROADMAP queue 3); the port's train their default
        return {"objective": name} if mod is J else {}
    X, y = make_binary(1000)
    labels = np.where(y > 0, "pos", "neg")
    clf = mod.LGBMClassifier(n_estimators=8, num_leaves=15, max_bin=63,
                             verbosity=-1, **kw, **objective("binary"))
    clf.fit(X, labels)
    out["objective"] = clf.booster_.params["objective"]
    out["classes"] = [str(c) for c in clf.classes_]
    out["proba"] = clf.predict_proba(X)
    out["labels"] = clf.predict(X)
    out["importances"] = clf.feature_importances_
    Xr, yr = make_regression(600)
    Xt, yt = make_regression(300, seed=5)
    reg = mod.LGBMRegressor(n_estimators=40, num_leaves=15,
                            learning_rate=0.5, max_bin=63, verbosity=-1,
                            **kw, **objective("regression"))
    reg.fit(Xr, yr, eval_set=[(Xt, yt)], eval_metric="l2",
            early_stopping_rounds=3, verbose=False)
    out["best_iteration"] = reg.best_iteration_
    out["reg"] = reg.predict(Xt)
    rng = np.random.RandomState(0)
    Xm = rng.normal(size=(600, 6))
    ym = np.array(["u", "v", "w"])[(Xm[:, 0] > 0).astype(int)
                                   + (Xm[:, 1] > 0).astype(int)]
    mc = mod.LGBMClassifier(n_estimators=5, num_leaves=15, max_bin=63,
                            verbosity=-1, **kw).fit(Xm, ym)
    out["multi"] = mc.predict_proba(Xm)
    Xq, yq, group = make_rank()
    rk = mod.LGBMRanker(n_estimators=5, num_leaves=7, max_bin=63,
                        verbosity=-1, **kw, **objective("lambdarank"))
    rk.fit(Xq, yq, group=group)
    out["rank_objective"] = rk.booster_.params["objective"]
    out["rank"] = rk.predict(Xq)
    return out


def _assert_runs_close(got, want):
    assert got["classes"] == want["classes"] == ["neg", "pos"]
    assert got["objective"] == want["objective"] == "binary"
    assert got["rank_objective"] == want["rank_objective"] == "lambdarank"
    assert got["best_iteration"] == want["best_iteration"]
    assert list(got["labels"]) == list(want["labels"])
    np.testing.assert_array_equal(got["importances"], want["importances"])
    for key in ("proba", "reg", "multi", "rank"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=ATOL,
                                   err_msg=key)


def test_sklearn_estimators_match_jax(one_thread):
    got = _sklearn_runs(P)
    _assert_runs_close(got, _sklearn_runs(J))
    assert got["proba"].shape == (1000, 2)
    assert got["multi"].shape == (600, 3)
    assert 0 < got["best_iteration"] < 40


_NO_SKLEARN = """
import json, sys
sys.modules["sklearn"] = None
sys.modules["pandas"] = None
import numpy as np, torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch import compat
assert not compat.SKLEARN_INSTALLED
from test_torch_python_api import _sklearn_runs
out = _sklearn_runs(P)
print(json.dumps({k: np.asarray(v).tolist() for k, v in out.items()}))
"""


def test_sklearn_estimators_without_sklearn(one_thread):
    """The same runs in a process where sklearn and pandas cannot be
    imported: the estimators stand on ``compat.py``'s base classes and
    label encoder, and give the same models."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _NO_SKLEARN,
                        os.path.join(REPO, "tests")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = {k: np.asarray(v) for k, v in
           json.loads(r.stdout.strip().splitlines()[-1]).items()}
    for key in ("classes", "objective", "rank_objective"):
        got[key] = got[key].tolist()
    got["best_iteration"] = int(got["best_iteration"])
    want = _sklearn_runs(P)
    _assert_runs_close(got, want)
    for key in ("proba", "reg", "multi", "rank"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_sklearn_params_round_trip():
    est = P.LGBMRegressor(num_leaves=9, device="cpu", min_data_per_group=7)
    params = est.get_params()
    assert params["device"] == "cpu" and params["num_leaves"] == 9
    assert params["min_data_per_group"] == 7
    assert "device" not in est.set_params(num_leaves=5)._process_params()
    assert est.num_leaves == 5
    with pytest.raises(LightGBMError, match="not fitted"):
        est.predict(np.zeros((2, 3)))


# ---- Dataset fields, subset, save_binary ----


def test_save_binary_round_trip(tmp_path):
    X, y = make_binary(300)
    ds = P.Dataset(X, label=y, weight=np.linspace(1, 2, 300), params=DS)
    path = str(tmp_path / "data.bin")
    ds.save_binary(path)
    loaded = BinnedDataset.load_binary(path)
    assert loaded.num_data == 300
    np.testing.assert_array_equal(loaded.binned, ds.handle.binned)
    np.testing.assert_array_equal(loaded.metadata.weights,
                                  ds.get_weight())
    from lightgbm_tpu.io.dataset import BinnedDataset as JBinned
    jloaded = JBinned.load_binary(path)
    np.testing.assert_array_equal(jloaded.binned, loaded.binned)
    again = P.Dataset(path).construct()
    np.testing.assert_array_equal(again.handle.binned, loaded.binned)


def test_fields_before_and_after_construct(one_thread):
    X, y = make_regression(800)
    w = np.linspace(0.5, 1.5, 800)
    init = np.full(800, 0.25)
    before = P.Dataset(X, params=DS)
    before.set_label(y).set_weight(w).set_init_score(init)
    assert before.get_field("label") is y
    after = P.Dataset(X, label=np.zeros(800), params=DS).construct()
    after.set_field("label", y).set_field("weight", w)
    after.set_field("init_score", init)
    for ds in (before.construct(), after):
        np.testing.assert_array_equal(ds.get_label(), y.astype(np.float32))
        np.testing.assert_array_equal(ds.get_weight(), w.astype(np.float32))
        np.testing.assert_array_equal(ds.get_init_score(), init)
    with pytest.raises(LightGBMError, match="Unknown field"):
        after.get_field("nope")
    with pytest.raises(LightGBMError, match="Unknown field"):
        after.set_field("nope", y)
    with pytest.raises(LightGBMError, match="categorical"):
        after.set_categorical_feature([0])
    params = dict(objective="regression", num_leaves=15, **DS)
    bst = P.train(params, after, num_boost_round=5, verbose_eval=False,
                  device="cpu")
    jds = J.Dataset(X, label=np.zeros(800), params=DS).construct()
    jds.set_label(y).set_weight(w).set_init_score(init)
    ref = J.train(params, jds, num_boost_round=5, verbose_eval=False)
    assert_same_trees(ref._booster.models, bst._booster.models)
    q = P.Dataset(X, label=y, params=DS).construct()
    q.set_group([400, 400])
    np.testing.assert_array_equal(q.get_group(), [400, 400])


def test_subset_and_get_data(one_thread):
    X, y = make_binary(900)
    full = P.Dataset(X, label=y, params=DS, free_raw_data=False)
    assert full.get_data() is X
    idx = np.arange(0, 900, 3)[::-1]
    sub = full.subset(idx)
    sub.construct()
    jsub = J.Dataset(X, label=y, params=DS, free_raw_data=False).subset(idx)
    jsub.construct()
    assert sub.num_data() == 300
    np.testing.assert_array_equal(sub.handle.binned, jsub.handle.binned)
    np.testing.assert_array_equal(sub.get_label(), y[np.sort(idx)])
    np.testing.assert_array_equal(sub.handle.binned,
                                  full.handle.binned[np.sort(idx)])
    params = dict(objective="binary", num_leaves=7, **DS)
    bst = P.train(params, sub, num_boost_round=4, verbose_eval=False,
                  device="cpu")
    ref = J.train(params, jsub, num_boost_round=4, verbose_eval=False)
    assert_same_trees(ref._booster.models, bst._booster.models)
