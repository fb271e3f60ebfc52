"""The port's level growth on bundled data with categorical columns against
the JAX package's level path, with quantized gradients.

``test_torch_efb.mixed_data`` (60 one-hot columns that bundle, a 12- and a
3-category column, two numerical ones; 4096 rows, max_bin=63,
num_leaves=15, 2 iterations) with ``categorical_feature``, through both
packages' ``train()``: the JAX learner's fused level path in Pallas
interpret mode (``LIGHTGBM_TPU_PALLAS_INTERPRET`` and the
``pl.load``/``pl.store`` shim of ``test_torch_level_oracle.py``, set by
``monkeypatch``; ~40 s), the port's level passes, which unfold group codes
and route category bitsets with integer child histograms.  Integer histograms on both sides: the trees
must be equal and the leaf values within ``leaf_value_tolerance``.  The
level test of ``test_torch_efb.py`` runs exact mode on CSR input.
"""
import torch

from test_torch_efb import (MIXED_CATS, PARAMS, N, _shim_is_undone,  # noqa
                            assert_predictions_close, assert_trees_match,
                            make_mixed, set_level_shim, train_both_engines)
from test_torch_quant import one_thread  # noqa: F401

torch.set_num_threads(2)


def test_categorical_level_quantized_matches_jax_level_path(monkeypatch,
                                                            one_thread):
    X, y = make_mixed(N, 4)
    set_level_shim(monkeypatch, exact=False)
    ref, port = train_both_engines(
        monkeypatch, X, y, dict(PARAMS, tree_grow_mode="level",
                                hist_precision="quantized",
                                min_data_per_group=20, cat_smooth=5.0),
        cats=MIXED_CATS)
    gbdt = port._booster
    assert gbdt.learner.grouped and gbdt.learner.quantized
    assert gbdt.learner.has_categorical
    assert gbdt.last_arrays.levels == gbdt.learner.level_count() == 4
    assert any(t.num_cat for t in gbdt.models)
    assert_trees_match(ref._booster.models, gbdt.models, N)
    assert_predictions_close(ref, port, X[:1000])
