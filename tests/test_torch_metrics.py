"""Every metric of the port against the JAX package's, on the CPU.

For each of the 22 names of ``lightgbm_tpu/metric/metric.py``'s table, on
the same seeded labels and f32 scores (2,000 rows; queries of 20 documents
for ``ndcg`` and ``map``; 4 classes for ``multi_logloss``, ``multi_error``
and ``auc_mu``), with and without sample weights, with the objective whose
``convert_output`` the metric reads, and without one: the values within
1e-6 relative (both are host numpy over the same inputs).  ``multi_error``
also runs with ``multi_error_top_k=2``, ``auc_mu`` with ``auc_mu_weights``,
and the ranking metrics at ``eval_at=[1, 3, 5, 10]``.  An unknown name is
skipped with a warning on both sides.
"""
import numpy as np
import pytest

from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.metadata import Metadata as JaxMetadata
from lightgbm_tpu.metric.metric import create_metric as jax_create_metric
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu_torch import Config, create_objective
from lightgbm_tpu_torch.io.metadata import Metadata
from lightgbm_tpu_torch.metric.metric import create_metric

N, K, QUERY = 2000, 4, 20

# metric -> (objective whose convert_output it reads, label kind)
METRICS = {
    "l2": ("regression", "real"), "rmse": ("regression", "real"),
    "l1": ("regression_l1", "real"), "quantile": ("quantile", "real"),
    "huber": ("huber", "real"), "fair": ("fair", "real"),
    "poisson": ("poisson", "count"), "mape": ("mape", "real"),
    "gamma": ("gamma", "positive"),
    "gamma_deviance": ("gamma", "positive"),
    "tweedie": ("tweedie", "positive"),
    "binary_logloss": ("binary", "binary"),
    "binary_error": ("binary", "binary"), "auc": ("binary", "binary"),
    "auc_mu": ("multiclass", "class"),
    "multi_logloss": ("multiclass", "class"),
    "multi_error": ("multiclass", "class"),
    "ndcg": ("lambdarank", "relevance"), "map": ("lambdarank", "relevance"),
    "cross_entropy": ("cross_entropy", "probability"),
    "cross_entropy_lambda": ("cross_entropy_lambda", "probability"),
    "kullback_leibler": ("cross_entropy", "probability"),
}
EXTRA = {
    "multi_error": [{}, dict(multi_error_top_k=2)],
    "auc_mu": [{}, dict(auc_mu_weights=list(
        np.random.RandomState(5).uniform(0.5, 2.0, K * K)))],
}


def labels(kind, rng):
    z = rng.normal(size=N)
    return {"real": 3.0 * z, "count": rng.poisson(np.exp(0.3 * z)),
            "positive": np.exp(0.3 * z) + 0.01,
            "binary": (z > 0).astype(np.float64),
            "class": rng.randint(0, K, N).astype(np.float64),
            "relevance": np.clip(np.floor(z + 1), 0, 4),
            "probability": 1.0 / (1.0 + np.exp(-z))}[kind].astype(np.float64)


CASES = [(m, extra) for m in METRICS for extra in EXTRA.get(m, [{}])]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("with_objective", [True, False])
@pytest.mark.parametrize("metric,extra", CASES)
def test_metric_equal(metric, extra, with_objective, weighted):
    obj, kind = METRICS[metric]
    rng = np.random.RandomState(sorted(METRICS).index(metric))
    y = labels(kind, rng)
    w = rng.uniform(0.5, 2.0, N) if weighted else None
    group = [QUERY] * (N // QUERY) if kind == "relevance" else None
    k = K if kind == "class" else 1
    score = rng.normal(scale=0.7, size=(k, N)).astype(np.float32)
    params = dict(objective=obj, metric=metric, eval_at=[1, 3, 5, 10],
                  **extra)
    if k > 1:
        params["num_class"] = K
    values = []
    for config, metadata, make_metric, make_objective in (
            (JaxConfig, JaxMetadata, jax_create_metric,
             lambda o, c: jax_objective(o, c)),
            (Config, Metadata, create_metric,
             lambda o, c: create_objective(o, c, device="cpu"))):
        cfg = config(**params)
        md = metadata(N)
        md.set_label(y)
        md.set_weights(w)
        md.set_group(group)
        m = make_metric(metric, cfg)
        m.init(md, N)
        objective = None
        if with_objective:
            objective = make_objective(obj, cfg)
            objective.init(md, N)
        values.append((list(m.names), m.eval(score, objective),
                       m.factor_to_bigger_better))
    (want_names, want, want_f), (names, got, f) = values
    assert names == want_names and f == want_f
    assert len(got) == len(want) >= 1
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.isfinite(got).all()


def test_every_jax_metric_name_is_covered():
    import inspect
    from lightgbm_tpu.metric import metric as jax_metric
    src = inspect.getsource(jax_metric.create_metric)
    table = src[src.index("table = {"):src.index("}", src.index("table = {"))]
    names = {t.split('"')[1] for t in table.split(",") if '"' in t}
    assert names == set(METRICS)


def test_unknown_metric_is_skipped_as_in_jax():
    assert jax_create_metric("no_such_metric", JaxConfig()) is None
    assert create_metric("no_such_metric", Config()) is None
