"""Ranking in the port against the JAX package, on the CPU.

- ``lambdarank_bucket`` against the JAX ``_lambdarank_bucket`` on the same
  [Q, S] buckets (queries of 1-60 documents padded to 8-64, labels 0-4,
  ties in the scores, with and without ``lambdamart_norm``): lambdas and
  hessians within 1e-5 x their largest magnitude (pair sums in another
  order);
- the ``rank_xendcg`` gamma stream equal to ``jax.random.uniform``'s bit for
  bit (``utils.prng``: threefry2x32 in int64), over seeds, calls and
  buckets, and ``xendcg_bucket`` against the JAX ``_xendcg_bucket`` on the
  same gammas within 1e-5;
- the objectives' bucket layout (``_make_buckets``) equal to the JAX one;
- ``ndcg`` and ``map`` at ``eval_at=[1, 3, 5, 10]`` equal (relative 1e-12)
  on the same scores, weighted queries included;
- ``Dataset.set_group``/``get_group`` as the JAX ``Dataset`` has them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as J
import lightgbm_tpu_torch as P
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.metadata import Metadata as JaxMetadata
from lightgbm_tpu.metric.dcg import DCGCalculator as JaxDCG
from lightgbm_tpu.metric.rank import MapMetric as JaxMap
from lightgbm_tpu.metric.rank import NDCGMetric as JaxNDCG
from lightgbm_tpu.objective import rank as jax_rank
from lightgbm_tpu_torch import Config
from lightgbm_tpu_torch.io.metadata import Metadata
from lightgbm_tpu_torch.metric.rank import MapMetric, NDCGMetric
from lightgbm_tpu_torch.objective import rank as port_rank
from lightgbm_tpu_torch.utils import prng

torch.set_num_threads(2)


def queries(seed, nq=40, max_len=60):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(1, max_len + 1, nq)
    n = int(sizes.sum())
    label = rng.randint(0, 5, n).astype(np.float32)
    score = np.round(rng.normal(size=n), 1).astype(np.float32)  # ties
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return bounds, label, score


def test_make_buckets_equal():
    bounds, _, _ = queries(0)
    n = int(bounds[-1])
    want = jax_rank._make_buckets(bounds, n)
    got = port_rank._make_buckets(bounds, n)
    assert len(got) == len(want)
    for (wi, wq), (gi, gq) in zip(want, got):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gq, wq)


def bucket_inputs(seed):
    bounds, label, score = queries(seed)
    n = len(label)
    JaxDCG.init(None)
    gain = np.asarray(JaxDCG.label_gain_, np.float32)
    disc = np.asarray(JaxDCG.discount_, np.float32)[:64]
    for idx, qids in jax_rank._make_buckets(bounds, n):
        inv = np.zeros(len(qids), np.float32)
        for r, q in enumerate(qids):
            m = JaxDCG.cal_max_dcg_at_k(30, label[bounds[q]:bounds[q + 1]])
            inv[r] = 1.0 / m if m > 0 else 0.0
        pad = idx < n
        sc = np.append(score, 0.0).astype(np.float32)[idx]
        lab = np.append(label, 0).astype(np.int32)[idx]
        yield sc, lab, pad, inv, gain, disc


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lambdarank_bucket_equal(seed, norm):
    for sc, lab, pad, inv, gain, disc in bucket_inputs(seed):
        want = jax_rank._lambdarank_bucket(
            jnp.asarray(sc), jnp.asarray(lab), jnp.asarray(pad),
            jnp.asarray(inv), jnp.asarray(gain), jnp.asarray(disc),
            sigmoid=1.0, norm=norm)
        got = port_rank.lambdarank_bucket(
            torch.from_numpy(sc), torch.from_numpy(lab).long(),
            torch.from_numpy(pad), torch.from_numpy(inv),
            torch.from_numpy(gain), torch.from_numpy(disc), sigmoid=1.0,
            norm=norm)
        for w, g in zip(want, got):
            w = np.asarray(w)
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * scale
            assert not g.numpy()[~pad].any()


@pytest.mark.parametrize("seed,call,bucket,shape", [
    (5, 1, 0, (13, 8)), (5, 7, 3, (4, 128)), (0, 1, 0, (1, 1)),
    (12345, 2, 1, (33, 16)), (2 ** 31 - 100, 99, 6, (2, 1024))])
def test_xendcg_gamma_stream_equal(seed, call, bucket, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed + call), bucket)
    want = np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))
    got = prng.uniform(prng.fold_in(prng.prng_key(seed + call), bucket),
                       shape, device="cpu")
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert got.dtype == torch.float32 and float(got.max()) < 1.0


def test_xendcg_objective_gammas_follow_the_jax_stream():
    """The objective's own draws: call c, bucket i."""
    bounds, label, _ = queries(4)
    md = Metadata(len(label))
    md.set_label(label)
    md.set_group(np.diff(bounds))
    obj = port_rank.RankXENDCG(Config(objective="rank_xendcg",
                                      objective_seed=9), device="cpu")
    obj.init(md, len(label))
    for call in (1, 2):
        for i, b in enumerate(obj._buckets):
            key = jax.random.fold_in(jax.random.PRNGKey(9 + call), i)
            want = jax.random.uniform(key, tuple(b["idx"].shape),
                                      dtype=jnp.float32)
            np.testing.assert_array_equal(obj.gammas(call, i).numpy(),
                                          np.asarray(want))


@pytest.mark.parametrize("seed", [0, 3])
def test_xendcg_bucket_equal(seed):
    for i, (sc, lab, pad, _, _, _) in enumerate(bucket_inputs(seed)):
        key = jax.random.fold_in(jax.random.PRNGKey(seed + 1), i)
        gam = np.array(jax.random.uniform(key, sc.shape, dtype=jnp.float32))
        labf = lab.astype(np.float32)
        want = jax_rank._xendcg_bucket(jnp.asarray(sc), jnp.asarray(labf),
                                       jnp.asarray(pad), jnp.asarray(gam))
        got = port_rank.xendcg_bucket(
            torch.from_numpy(sc), torch.from_numpy(labf),
            torch.from_numpy(pad), torch.from_numpy(gam))
        for w, g in zip(want, got):
            w = np.asarray(w)
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * scale


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("metric", ["ndcg", "map"])
def test_rank_metrics_equal(metric, weighted):
    bounds, label, score = queries(5, nq=80)
    n = len(label)
    w = (np.random.RandomState(6).uniform(0.5, 2.0, n) if weighted else None)
    params = dict(objective="lambdarank", eval_at=[1, 3, 5, 10])
    out = []
    for cls, cfg, md in ((JaxNDCG if metric == "ndcg" else JaxMap,
                          JaxConfig(**params), JaxMetadata(n)),
                         (NDCGMetric if metric == "ndcg" else MapMetric,
                          Config(**params), Metadata(n))):
        md.set_label(label)
        md.set_weights(w)
        md.set_group(np.diff(bounds))
        m = cls(cfg)
        m.init(md, n)
        out.append((m.names, m.eval(score)))
    (want_names, want), (names, got) = out
    assert names == want_names == ["%s@%d" % (metric, k) for k in (1, 3, 5,
                                                                  10)]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_dataset_group_fields_like_jax():
    bounds, label, _ = queries(7)
    X = np.random.RandomState(7).normal(size=(len(label), 4))
    sizes = np.diff(bounds)
    for lib in (J, P):
        before = lib.Dataset(X, label).set_group(sizes)
        np.testing.assert_array_equal(before.get_group(), sizes)
        before.construct()
        np.testing.assert_array_equal(before.get_group(), sizes)
        after = lib.Dataset(X, label).construct()
        assert after.get_group() is None
        after.set_group(sizes)
        np.testing.assert_array_equal(after.get_group(), sizes)
        np.testing.assert_array_equal(
            after.handle.metadata.query_boundaries, bounds)
