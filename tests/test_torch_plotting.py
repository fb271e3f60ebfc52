"""The port's plotting against the JAX package's, on the CPU
(tests/test_plotting.py).

Both packages train the same model (``max_bin=63``); the port's importance
bars, metric curves, split-value histogram and tree digraph equal the JAX
package's drawn from the same data: bar widths and labels, curve points,
histogram counts and edges, and the digraph's nodes and edges.
``plot_tree`` needs graphviz's ``dot`` program to render; where it is
missing the render is replaced by a one-pixel PNG, so that the axes it
fills is still checked.
"""
import re
import shutil

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import lightgbm_tpu as J  # noqa: E402
import lightgbm_tpu_torch as P  # noqa: E402
from test_torch_quant import one_thread  # noqa: E402,F401

PARAMS = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
          "metric": "binary_logloss", "max_bin": 63}


def _train(mod, **kw):
    rng = np.random.RandomState(0)
    X = rng.normal(size=(500, 5))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    ds = mod.Dataset(X, label=y, params={"max_bin": 63})
    evals = {}
    bst = mod.train(PARAMS, ds, num_boost_round=10, valid_sets=[ds],
                    valid_names=["train"], evals_result=evals,
                    verbose_eval=False, **kw)
    return bst, evals


@pytest.fixture(scope="module")
def trained(one_thread):
    return _train(P, device="cpu"), _train(J)


def _bars(ax):
    return ([p.get_width() for p in ax.patches],
            [t.get_text() for t in ax.get_yticklabels()],
            [t.get_text() for t in ax.texts])


def test_plot_importance(trained):
    (bst, _), (ref, _) = trained
    ax = P.plot_importance(bst)
    assert ax.get_title() == "Feature importance"
    assert ax.get_xlabel() == "Feature importance"
    assert len(ax.patches) >= 1
    assert _bars(ax) == _bars(J.plot_importance(ref))
    ax2 = P.plot_importance(bst, importance_type="gain", precision=2,
                            max_num_features=2, title="t", xlabel="x",
                            ylabel="y")
    assert len(ax2.patches) <= 2
    assert ax2.get_title() == "t"
    want = J.plot_importance(ref, importance_type="gain", precision=2,
                             max_num_features=2)
    np.testing.assert_allclose(_bars(ax2)[0], _bars(want)[0], rtol=1e-4)
    assert _bars(ax2)[1] == _bars(want)[1]
    plt.close("all")


def test_plot_metric(trained):
    (bst, evals), (_, jevals) = trained
    ax = P.plot_metric(evals)
    assert ax.get_ylabel() == "binary_logloss"
    want = J.plot_metric(jevals)
    np.testing.assert_allclose(ax.lines[0].get_ydata(),
                               want.lines[0].get_ydata(), rtol=0, atol=1e-6)
    with pytest.raises(TypeError):
        P.plot_metric(bst)
    est = P.LGBMClassifier(n_estimators=3, num_leaves=7, verbosity=-1,
                           device="cpu")
    X = np.random.RandomState(1).normal(size=(200, 3))
    est.fit(X, X[:, 0] > 0, eval_set=[(X, X[:, 0] > 0)], verbose=False)
    assert P.plot_metric(est).get_ylabel() == "binary_logloss"
    assert est.objective_ == "binary"
    plt.close("all")


def test_plot_split_value_histogram(trained):
    (bst, _), (ref, _) = trained
    feat = int(np.argmax(bst.feature_importance()))
    ax = P.plot_split_value_histogram(bst, feat)
    assert "histogram" in ax.get_title()
    want = J.plot_split_value_histogram(ref, feat)
    assert [p.get_height() for p in ax.patches] == \
        [p.get_height() for p in want.patches]
    hist, edges = bst.get_split_value_histogram(feat, bins=5)
    jhist, jedges = ref.get_split_value_histogram(feat, bins=5)
    np.testing.assert_array_equal(hist, jhist)
    np.testing.assert_array_equal(edges, jedges)
    xgb = np.asarray(bst.get_split_value_histogram(feat, xgboost_style=True))
    assert xgb.ndim == 2 and (xgb[:, 1] > 0).all()
    unused = [i for i, v in enumerate(bst.feature_importance()) if v == 0]
    for f in unused[:1]:
        with pytest.raises(ValueError):
            P.plot_split_value_histogram(bst, f)
    plt.close("all")


def _graph_shape(src):
    """The digraph's node names and edges, numbers dropped from labels."""
    return sorted(re.sub(r"-?\d+\.\d+(e-?\d+)?", "#", line).strip()
                  for line in src.splitlines())


def test_create_tree_digraph(trained):
    graphviz = pytest.importorskip("graphviz")
    (bst, _), (ref, _) = trained
    info = ["split_gain", "internal_count", "leaf_count"]
    g = P.create_tree_digraph(bst, tree_index=1, show_info=info)
    assert isinstance(g, graphviz.Digraph)
    src = g.source
    assert "split" in src and "leaf" in src and "count" in src
    want = J.create_tree_digraph(ref, tree_index=1, show_info=info).source
    assert _graph_shape(src) == _graph_shape(want)
    with pytest.raises(IndexError):
        P.create_tree_digraph(bst, tree_index=100)


def test_plot_tree(trained, monkeypatch):
    graphviz = pytest.importorskip("graphviz")
    (bst, _), _ = trained
    if shutil.which("dot") is None:
        import io
        buf = io.BytesIO()
        plt.imsave(buf, np.zeros((1, 1, 3)), format="png")
        monkeypatch.setattr(graphviz.Digraph, "pipe",
                            lambda self, format=None: buf.getvalue())
    ax = P.plot_tree(bst, tree_index=0)
    assert not ax.axison
    assert len(ax.images) == 1
    with pytest.raises(TypeError):
        P.plot_tree(bst, figsize=3)
    with pytest.raises(TypeError):
        P.plot_importance(object())
    plt.close("all")
