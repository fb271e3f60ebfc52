"""The port's serving tier (``lightgbm_tpu_torch/serving``) against the JAX
package's (``lightgbm_tpu/serving``), on the CPU.

The models are the JAX serving tests' fixtures (``test_serving._train``),
trained by the JAX package and carried across as model text.  Every served
result is held bit-equal to the port's ``FusedPredictor`` over the same
model range and rows (the f32 regime, whatever the batch), and to the JAX
``Server``'s result for the same request: coalesced micro-batches,
per-request ``num_iteration``/``pred_early_stop``, binned rows, the
single-row fast path and ``compile_single_row``'s goldens.  SHAP requests
are held to the JAX server's within ``test_torch_contrib``'s tolerance
(rtol 1e-12, atol 1e-12).  Residency (LRU eviction, deferred eviction,
re-admission, atomic swap under load, exact byte accounting), back-pressure,
``close(drain=False)``, the entry points (``serve``, ``Booster.serve``, CLI
``task=serve``), the serving knobs and the zero-telemetry-calls rule are
pinned as the JAX tests pin them.  The port's miss gauge
(``obs.recompile``) stays flat outside ``warm``/``swap``.
"""
import threading
import time

import numpy as np
import pytest

from lightgbm_tpu import obs as jax_obs
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.model_codegen import compile_single_row as jax_single_row
from lightgbm_tpu.serving import Server as JServer
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.core.predict_fused import FusedPredictor
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.model_codegen import compile_single_row
from lightgbm_tpu_torch.obs import recompile
from lightgbm_tpu_torch.serving import (ModelRegistry, Server, ServingClosed,
                                        ServingQueueFull)
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_serving import _train as jax_train

CPU = "cpu"
CONTRIB_TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True)
def _telemetry_off():
    obs.disable()
    jax_obs.disable()
    yield
    obs.disable()
    jax_obs.disable()


def carry(jb, **cfg) -> GBDT:
    """The port's booster of a JAX booster's model text (``cfg`` its
    prediction knobs), on the CPU."""
    g = GBDT(Config(verbosity=-1, **cfg), device=CPU)
    g.load_model_from_string(jb.save_model_to_string())
    return g


def layout_of(X, jb) -> BinnedDataset:
    """The port's binned layout of the rows a JAX fixture trained on (the
    same bins: ``test_torch_dataset`` holds the binning equal)."""
    cfg = jb.config
    return BinnedDataset.from_matrix(X, label=np.zeros(len(X)),
                                     max_bin=cfg.max_bin,
                                     min_data_in_leaf=cfg.min_data_in_leaf)


@pytest.fixture(scope="module")
def models():
    """The JAX fixtures: two same-shape regression boosters, a replacement
    for the swap tests, a binary NaN-routing booster; each with the port's
    carried booster."""
    out = {}
    for name, kw in (("a", dict(seed=0)), ("b", dict(seed=1)),
                     ("b2", dict(seed=2)),
                     ("bin", dict(seed=3, objective="binary", num_leaves=15,
                                  iters=12, nan_frac=0.05))):
        jb, X = jax_train(**kw)
        out[name] = (carry(jb), X, jb)
    out["b2"] = (out["b2"][0], out["b"][1], out["b2"][2])
    return out


def ref(g, X, margin=-1.0, freq=10, num_iteration=-1, start_iteration=0):
    """One port FusedPredictor call per class over the model range: the
    serving reference."""
    K = max(g.num_tree_per_iteration, 1)
    total = len(g.models) // K
    end = total if num_iteration <= 0 else min(total,
                                               start_iteration + num_iteration)
    sel = g.models[start_iteration * K:end * K]
    out = np.zeros((K, len(X)))
    for k in range(K):
        out[k] = FusedPredictor(sel[k::K], device=CPU)(
            X, early_stop_margin=margin, round_period=freq)
    return out[0] if K == 1 else out


def jax_served(jb, requests, **server_kw):
    """The JAX server's results for ``[(rows, submit kwargs)]``."""
    with JServer(**server_kw) as srv:
        srv.register("m", jb)
        futs = [srv.submit("m", rows, **kw) for rows, kw in requests]
        return [f.result(timeout=120) for f in futs]


# ---- continuous batching: each request equal to the JAX server's ----

def test_mixed_size_requests_equal_jax_server(models):
    g, X, jb = models["bin"]
    full = ref(g, X[:600])
    sizes = [1, 3, 57, 128, 200, 1, 64]
    reqs, lo = [], 0
    for n in sizes:
        reqs.append((X[lo:lo + n], dict(raw_score=True)))
        lo += n
    want = jax_served(jb, reqs, max_batch_wait_us=3000)
    with Server(max_batch_wait_us=3000, device=CPU) as srv:
        srv.register("m", g)
        futs = [srv.submit("m", rows, **kw) for rows, kw in reqs]
        lo = 0
        for (rows, _), fut, w in zip(reqs, futs, want):
            got = fut.result(timeout=60)
            np.testing.assert_array_equal(got, full[lo:lo + len(rows)])
            np.testing.assert_array_equal(got, w)
            lo += len(rows)
        assert srv.batches < len(sizes)
        assert srv.stats()["dropped"] == 0
    # the objective's transform equals Booster.predict's at >= 512 rows
    # (the f32 regime both take there)
    with Server(max_batch_wait_us=0, device=CPU) as srv:
        srv.register("m", g)
        np.testing.assert_array_equal(srv.predict("m", X[:600]),
                                      g.predict(X[:600]))


@pytest.mark.parametrize("kw", [
    dict(num_iteration=5),
    dict(num_iteration=4, start_iteration=3),
    dict(pred_early_stop=True, pred_early_stop_margin=0.5,
         pred_early_stop_freq=3),
], ids=["num_iteration", "start_iteration", "early_stop"])
def test_per_request_knobs_equal_jax_server(models, kw):
    g, X, jb = models["bin"]
    rows = X[:200]
    want = jax_served(jb, [(rows, dict(raw_score=True, **kw))],
                      max_batch_wait_us=1000)[0]
    with Server(max_batch_wait_us=1000, device=CPU) as srv:
        srv.register("m", g)
        full = srv.submit("m", rows, raw_score=True)
        got = srv.submit("m", rows, raw_score=True, **kw).result(60)
        np.testing.assert_array_equal(full.result(60), ref(g, rows))
    np.testing.assert_array_equal(got, want)
    if "pred_early_stop" in kw:
        np.testing.assert_array_equal(got, ref(g, rows, margin=0.5, freq=3))
        assert not np.array_equal(got, ref(g, rows))
    else:
        np.testing.assert_array_equal(
            got, ref(g, rows, num_iteration=kw["num_iteration"],
                     start_iteration=kw.get("start_iteration", 0)))


def test_bf16_tier_equals_its_predictor(models):
    """precision="bf16" requests ride the lossy tier's own stack, never
    coalesced with exact ones, equal to its FusedPredictor."""
    g, X, _ = models["bin"]
    with Server(max_batch_wait_us=2000, device=CPU) as srv:
        srv.register("m", g)
        lossy = srv.submit("m", X[:300], raw_score=True, precision="bf16")
        exact = srv.submit("m", X[:300], raw_score=True)
        np.testing.assert_array_equal(
            lossy.result(60), FusedPredictor(g.models, precision="bf16",
                                             device=CPU)(X[:300]))
        np.testing.assert_array_equal(exact.result(60), ref(g, X[:300]))
        assert srv.batches == 2
        with pytest.raises(LightGBMError, match="no lossy tier"):
            srv.submit("m", X[:4], pred_contrib=True, precision="bf16")


def test_early_stop_gate_on_accuracy_needing_objectives(models):
    """Explicit pred_early_stop=True on a regression model serves without
    truncation, as GBDT gates the config flag."""
    g, X, _ = models["a"]
    with Server(max_batch_wait_us=500, device=CPU) as srv:
        srv.register("m", g)
        got = srv.predict("m", X[:64], raw_score=True, pred_early_stop=True,
                          pred_early_stop_margin=0.01,
                          pred_early_stop_freq=1)
    np.testing.assert_array_equal(got, ref(g, X[:64]))


def test_explicit_early_stop_keeps_configured_margin():
    es = dict(pred_early_stop=True, pred_early_stop_margin=0.5,
              pred_early_stop_freq=3)
    jb, X = jax_train(seed=5, objective="binary", num_leaves=15, iters=12,
                      **es)
    g = carry(jb, objective="binary", **es)
    exp = ref(g, X[:200], margin=0.5, freq=3)
    want = jax_served(jb, [(X[:200], dict(raw_score=True,
                                          pred_early_stop=True))],
                      max_batch_wait_us=500)[0]
    with Server(max_batch_wait_us=500, device=CPU) as srv:
        srv.register("m", g)
        got = srv.predict("m", X[:200], raw_score=True, pred_early_stop=True)
        np.testing.assert_array_equal(got, exp)
        np.testing.assert_array_equal(srv.predict("m", X[:200],
                                                  raw_score=True), exp)
    np.testing.assert_array_equal(got, want)


def test_binned_requests_equal_jax_server(models):
    g, X, jb = models["bin"]
    ds = layout_of(X, jb)
    np.testing.assert_array_equal(ds.binned, jb.train_data.binned)
    want = jax_served(jb, [(jb.train_data.binned[:300],
                            dict(binned=True, raw_score=True))],
                      max_batch_wait_us=1000)[0]
    with Server(max_batch_wait_us=1000, device=CPU) as srv:
        srv.register("m", g, layout_ds=ds)
        got = srv.predict("m", ds.binned[:300], binned=True, raw_score=True)
        np.testing.assert_array_equal(got, ref(g, X[:300]))
        np.testing.assert_array_equal(got, want)
        f1 = srv.submit("m", X[:40], raw_score=True)
        f2 = srv.submit("m", ds.binned[:40], binned=True, raw_score=True)
        np.testing.assert_array_equal(f1.result(60), f2.result(60))
    with Server(device=CPU) as srv:
        srv.register("loaded", g)  # no layout dataset: binned refused
        with pytest.raises(LightGBMError, match="binned"):
            srv.submit("loaded", ds.binned[:4], binned=True)


def test_contrib_requests_equal_jax_server(models):
    g, X, jb = models["bin"]
    rows = X[:64]
    want = jax_served(jb, [(rows, dict(pred_contrib=True))],
                      max_batch_wait_us=500)[0]
    with Server(max_batch_wait_us=500, device=CPU) as srv:
        srv.register("m", g)
        got = srv.predict("m", rows, pred_contrib=True)
    np.testing.assert_allclose(got, want, **CONTRIB_TOL)
    np.testing.assert_array_equal(got, g.predict_contrib(rows))


# ---- the single-row fast path (compile_single_row) ----

def test_single_row_fast_equal(models):
    g, X, jb = models["bin"]
    full = ref(g, X[:40])
    want = jax_served(jb, [(X[i], dict(raw_score=True)) for i in range(8)],
                      max_batch_wait_us=500, single_row_fast=True)
    with Server(max_batch_wait_us=500, single_row_fast=True,
                device=CPU) as srv:
        srv.register("m", g)
        for i in range(40):
            got = srv.predict("m", X[i], raw_score=True)
            np.testing.assert_array_equal(got, full[i:i + 1])
            if i < 8:
                np.testing.assert_array_equal(got, want[i])
        assert srv.fast_served == 40
        np.testing.assert_array_equal(srv.predict("m", X[7]),
                                      g.predict(X[:600])[7:8])
        # an early-stop request rides the batched path
        srv.predict("m", X[0], raw_score=True, pred_early_stop=True,
                    pred_early_stop_margin=0.5)
        assert srv.fast_served == 41


def _golden(case):
    """(JAX booster, port booster, rows, num_iteration) of a golden."""
    if case == "categorical":
        from lightgbm_tpu.boosting.gbdt import GBDT as JGBDT
        from lightgbm_tpu.io.dataset import BinnedDataset as JDS
        from lightgbm_tpu.objective import create_objective
        rng = np.random.RandomState(0)
        n = 1200
        cat = rng.randint(0, 40, size=n)
        y = np.isin(cat, [0, 3, 7, 33]) * 3.0 + rng.normal(scale=0.2,
                                                          size=n)
        Xc = np.column_stack([cat.astype(np.float64), rng.normal(size=n)])
        ds = JDS.from_matrix(Xc, label=y, categorical_feature=[0])
        cfg = JConfig(objective="regression", num_leaves=7,
                      min_data_per_group=10, cat_smooth=1.0,
                      max_cat_to_onehot=4, num_iterations=10, verbosity=-1)
        jb = JGBDT(cfg, ds, create_objective("regression", cfg))
        for _ in range(10):
            jb.train_one_iter()
        assert any(t.num_cat > 0 for t in jb.models)
        X = np.concatenate([Xc[:64], [[99.0, 0.0], [np.nan, 0.0],
                                      [-3.0, 0.0]]]).astype(np.float32)
        return jb, carry(jb), X, -1
    if case == "multiclass":
        jb, X = jax_train(seed=6, objective="multiclass", num_class=3,
                          iters=6)
        return jb, carry(jb), X[:32], -1
    jb, X = jax_train(seed=5, objective="binary", num_leaves=15, iters=12,
                      nan_frac=0.08)
    return jb, carry(jb), X[:128], (5 if case == "num_iteration" else -1)


@pytest.mark.parametrize("case", ["nan_routing", "num_iteration",
                                  "categorical", "multiclass"])
def test_compile_single_row_goldens(case):
    """compile_single_row bit-equal to the f32 regime and to the JAX
    package's compile_single_row on the golden model classes."""
    jb, g, X, num_iteration = _golden(case)
    fn = compile_single_row(g, num_iteration=num_iteration)
    jfn = jax_single_row(jb, num_iteration=num_iteration)
    got = np.stack([fn(r) for r in X], axis=1)
    np.testing.assert_array_equal(got, np.stack([jfn(r) for r in X], axis=1))
    want = ref(g, X, num_iteration=num_iteration)
    np.testing.assert_array_equal(got, want.reshape(got.shape))


def test_compile_single_row_deep_tree_fallback(monkeypatch):
    import lightgbm_tpu_torch.model_codegen as mc
    jb, X = jax_train(seed=7, objective="binary", num_leaves=15, iters=6,
                      nan_frac=0.05)
    g = carry(jb)
    monkeypatch.setattr(mc, "_MAX_CODEGEN_DEPTH", 0)
    fn = compile_single_row(g)
    np.testing.assert_array_equal(
        ref(g, X[:64]), np.array([fn(X[i])[0] for i in range(64)]))


# ---- residency: LRU, budget, deferred eviction, re-admission, swap ----

def _mb(entry_bytes):
    return entry_bytes / float(1 << 20)


def _one(g) -> int:
    return ModelRegistry(budget_mb=0, device=CPU).register(
        "probe", g).resident_bytes


def test_registry_budget_lru_eviction_and_readmit(models):
    gA, XA, _ = models["a"]
    gB, XB, _ = models["b"]
    one = _one(gA)
    assert one > 0
    reg = ModelRegistry(budget_mb=_mb(int(one * 1.5)), device=CPU)
    reg.register("a", gA)
    reg.register("b", gB)
    assert reg.resident_names() == ["b"]
    assert reg.stats()["parked"] == ["a"] and reg.evictions == 1
    entry_b = reg.acquire("b")
    entry_b.predict(XB[:64], raw_score=True)
    reg.release(entry_b)
    base = recompile.total("predict_stack")
    entry_a = reg.acquire("a")               # transparent re-admission
    np.testing.assert_array_equal(entry_a.predict(XA[:64], raw_score=True),
                                  ref(gA, XA[:64]))
    reg.release(entry_a)
    assert reg.readmits == 1 and reg.resident_names() == ["a"]
    # re-stacking keys built before is no miss
    assert recompile.total("predict_stack") == base


def test_eviction_defers_past_inflight_dispatch(models):
    gA, XA, _ = models["a"]
    gB, _, _ = models["b"]
    reg = ModelRegistry(budget_mb=_mb(int(_one(gA) * 1.5)), device=CPU)
    entry_a = reg.register("a", gA)
    held = reg.acquire("a")
    assert held is entry_a
    reg.register("b", gB)
    assert entry_a.evict_pending and not entry_a.retired
    assert entry_a._preds and "a" in reg.resident_names()
    np.testing.assert_array_equal(held.predict(XA[:16], raw_score=True),
                                  ref(gA, XA[:16]))
    reg.release(held)
    assert not entry_a._preds and "a" not in reg.resident_names()
    assert reg.stats()["parked"] == ["a"]


def test_swap_atomic_republish(models):
    gB, XB, _ = models["b"]
    gB2, _, _ = models["b2"]
    reg = ModelRegistry(budget_mb=0, device=CPU)
    reg.register("b", gB)
    old_entry = reg.acquire("b")
    new_entry = reg.swap("b", gB2, warm=(128,))
    np.testing.assert_array_equal(old_entry.predict(XB[:32], raw_score=True),
                                  ref(gB, XB[:32]))
    got = reg.acquire("b")
    assert got is new_entry
    np.testing.assert_array_equal(got.predict(XB[:32], raw_score=True),
                                  ref(gB2, XB[:32]))
    reg.release(got)
    assert old_entry.retired and old_entry._preds
    reg.release(old_entry)
    assert not old_entry._preds and reg.swaps == 1
    with pytest.raises(LightGBMError, match="register"):
        reg.swap("nope", gB)


def test_swap_under_load_zero_drops_zero_misses(models):
    """Mixed sizes, two resident models, one hot swap mid-traffic: zero
    drops, every response equal to the generation that served it, the miss
    gauge flat outside the swap."""
    gA, XA, _ = models["a"]
    gB, XB, _ = models["b"]
    gB2, _, _ = models["b2"]
    sizes = (1, 17, 64, 200)
    refs = {name: {n: ref(g, X[:n]) for n in sizes}
            for name, g, X in (("a", gA, XA), ("b", gB, XB), ("b2", gB2, XB))}
    srv = Server(max_batch_wait_us=500, device=CPU)
    srv.register("a", gA)
    srv.register("b", gB)
    for name, X in (("a", XA), ("b", XB)):
        for n in sizes:
            srv.predict(name, X[:n], raw_score=True)
    base = recompile.total()
    results, lock = [], threading.Lock()
    swapped = threading.Event()

    def traffic(tid):
        # 30 requests, and on until 6 were submitted after swap returned
        rng = np.random.RandomState(tid)
        pending, i, after = [], 0, 0
        while i < 30 or after < 6:
            name = "a" if (i + tid) % 2 == 0 else "b"
            n = int(sizes[rng.randint(len(sizes))])
            late = swapped.is_set()
            fut = srv.submit(name, (XA if name == "a" else XB)[:n],
                             raw_score=True)
            with lock:
                results.append((name, n, late, fut))
            after += late
            i += 1
            pending.append(fut)
            if len(pending) >= 2:
                pending.pop(0).result(60)

    threads = [threading.Thread(target=traffic, args=(t,)) for t in range(3)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 120
    while True:
        with lock:
            if len(results) >= 18:
                break
        assert time.monotonic() < deadline, "traffic stalled before swap"
        time.sleep(0.002)
    before_swap = recompile.total()
    srv.swap("b", gB2, warm=(128, 1024, 8192))
    swap_misses = recompile.total() - before_swap
    swapped.set()
    for t in threads:
        t.join()
    srv.close()
    assert srv.stats()["dropped"] == 0 and srv.failed == 0
    served_new = 0
    for name, n, late, fut in results:
        got = fut.result(60)
        if name == "a":
            np.testing.assert_array_equal(got, refs["a"][n])
        else:
            new = np.array_equal(got, refs["b2"][n])
            served_new += new
            # a request submitted after swap returned gets the new model
            assert new or (not late and np.array_equal(got, refs["b"][n]))
    assert served_new > 0
    # the only misses of the run are the swap's own stacking
    assert recompile.total() - base == swap_misses


def test_registry_bytes_accounting_exact(models):
    """Admission accounts each model's tensors' exact bytes once; a later
    predictor range and a contribution plan grow it by their bytes; evict,
    swap and unregister give it all back."""
    gA, XA, _ = models["a"]
    gB, _, _ = models["b"]
    reg = ModelRegistry(budget_mb=0, device=CPU)
    e = reg.register("a", gA)
    assert reg.stats()["bytes"] == e.resident_bytes == sum(
        p.nbytes() for p in e._preds.values())
    before = e.resident_bytes
    e.predict(XA[:8], raw_score=True, num_iteration=3)
    assert e.resident_bytes > before
    e.predict_contrib(XA[:16])
    assert reg.stats()["bytes"] == e.resident_bytes == sum(
        p.nbytes() for p in e._preds.values())
    e2 = reg.register("b", gB)
    assert reg.stats()["bytes"] == e.resident_bytes + e2.resident_bytes
    reg.unregister("a")
    assert reg.stats()["bytes"] == e2.resident_bytes
    reg.unregister("b")
    assert reg.stats()["bytes"] == 0


def test_concurrent_readmit_builds_once(models):
    gA, _, _ = models["a"]
    gB, _, _ = models["b"]
    reg = ModelRegistry(budget_mb=_mb(int(_one(gA) * 1.5)), device=CPU)
    reg.register("a", gA)
    reg.register("b", gB)
    got = []

    def grab():
        e = reg.acquire("a")
        got.append(e)
        reg.release(e)

    threads = [threading.Thread(target=grab) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len({id(e) for e in got}) == 1 and reg.readmits == 1
    assert reg.stats()["bytes"] == got[0].resident_bytes


def test_same_size_swap_does_not_evict_coresidents(models):
    gA, _, _ = models["a"]
    gB, _, _ = models["b"]
    gB2, _, _ = models["b2"]
    reg = ModelRegistry(budget_mb=_mb(int(_one(gA) * 2)), device=CPU)
    reg.register("a", gA)
    reg.register("b", gB)
    reg.swap("b", gB2, warm=False)
    assert sorted(reg.resident_names()) == ["a", "b"] and reg.evictions == 0


@pytest.mark.parametrize("race", ["swap", "acquire"])
def test_unregister_mid_build_never_resurrects(models, monkeypatch, race):
    """An unregister() landing while swap() stacks its replacement, or while
    a re-admission builds, wins: the name is not republished."""
    from lightgbm_tpu_torch.serving import registry as reg_mod
    gA, _, _ = models["a"]
    gB, _, _ = models["b"]
    if race == "swap":
        r = ModelRegistry(device=CPU)
        r.register("m", gB)
        real_warm = reg_mod.ResidentModel.warm

        def warm_then_unregister(self, *a, **k):
            real_warm(self, *a, **k)
            r.unregister("m")

        monkeypatch.setattr(reg_mod.ResidentModel, "warm",
                            warm_then_unregister)
        with pytest.raises(LightGBMError, match="unregistered during"):
            r.swap("m", models["b2"][0])
    else:
        r = ModelRegistry(budget_mb=1e-6, device=CPU)
        r.register("m", gA)
        r.register("n", gB)
        assert "m" in r.stats()["parked"]

        def boom(self, *a, **k):
            r.unregister("m")
            raise RuntimeError("boom")

        monkeypatch.setattr(reg_mod.ResidentModel, "__init__", boom)
        with pytest.raises(RuntimeError, match="boom"):
            r.acquire("m")
    assert not r.knows("m")


# ---- the dispatcher: tombstones, cancellation, failures, back-pressure ----

def test_cancelled_future_does_not_poison_batch(models):
    g, X, _ = models["a"]
    srv = Server(max_batch_wait_us=300_000, device=CPU)
    srv.register("m", g)
    opener = srv.submit("m", X[:4], raw_score=True)
    victim = srv.submit("m", X[:4], raw_score=True)
    mate = srv.submit("m", X[4:8], raw_score=True)
    assert victim.cancel()
    np.testing.assert_array_equal(mate.result(60), ref(g, X[4:8]))
    np.testing.assert_array_equal(opener.result(60), ref(g, X[:4]))
    srv.close()
    stats = srv.stats()
    assert stats["cancelled"] == 1 and stats["completed"] == 2
    assert stats["failed"] == 0 and stats["dropped"] == 0


def test_rung_exact_requests_leave_no_tombstones(models):
    g, X, _ = models["a"]
    with Server(max_batch_wait_us=200, device=CPU) as srv:
        srv.register("m", g)
        Xr = np.zeros((128, X.shape[1]), np.float32)
        for _ in range(20):
            srv.predict("m", Xr, raw_score=True)
        with srv._cond:
            assert not srv._by_key and not srv._pending


def test_failed_dispatch_fails_the_batch_and_is_counted(models, monkeypatch):
    """A failed launch fails its batch's futures (counted, never retried
    elsewhere); the server goes on serving."""
    g, X, _ = models["a"]
    calls = []

    def boom(self, *a, **k):
        calls.append(1)
        raise RuntimeError("launch failed")

    with Server(max_batch_wait_us=0, device=CPU) as srv:
        srv.register("m", g)
        real = FusedPredictor.__call__
        monkeypatch.setattr(FusedPredictor, "__call__", boom)
        fut = srv.submit("m", X[:32], raw_score=True)
        with pytest.raises(RuntimeError, match="launch failed"):
            fut.result(60)
        assert len(calls) == 1 and srv.failed == 1
        monkeypatch.setattr(FusedPredictor, "__call__", real)
        np.testing.assert_array_equal(srv.predict("m", X[:32],
                                                  raw_score=True),
                                      ref(g, X[:32]))
    assert srv.stats()["dropped"] == 0


def test_device_bind_failure_fails_batches_never_hangs(models,
                                                      monkeypatch):
    """A dispatcher that cannot make the server's card current fails every
    batch with that error (counted) instead of dying with its futures
    pending."""
    g, X, _ = models["a"]

    def no_card(self):
        raise ValueError("no such card")

    monkeypatch.setattr(Server, "_bind_device", no_card)
    with Server(max_batch_wait_us=0, device=CPU) as srv:
        srv.register("m", g)
        futs = [srv.submit("m", X[:4]) for _ in range(3)]
        for f in futs:
            with pytest.raises(ValueError, match="no such card"):
                f.result(60)
    assert srv.failed == 3 and srv.stats()["dropped"] == 0


def test_queue_saturation_rejects_never_drops(models):
    g, X, _ = models["a"]
    srv = Server(max_batch_wait_us=300_000, max_queue_depth=2, device=CPU)
    srv.register("m", g)
    accepted, rejected = [srv.submit("m", X[:4], raw_score=True)], 0
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and rejected == 0:
        try:
            accepted.append(srv.submit("m", X[:4], raw_score=True))
        except ServingQueueFull:
            rejected += 1
    assert rejected
    for fut in accepted:
        np.testing.assert_array_equal(fut.result(60), ref(g, X[:4]))
    assert srv.stats()["rejected"] >= 1 and srv.stats()["dropped"] == 0
    srv.close()
    with pytest.raises(ServingClosed):
        srv.submit("m", X[:4])


def test_close_without_drain_fails_pending_loudly(models):
    g, X, _ = models["a"]
    srv = Server(max_batch_wait_us=300_000, device=CPU)
    srv.register("m", g)
    srv.submit("m", X[:4], raw_score=True)
    late = [srv.submit("m", np.zeros((2, X.shape[1]), np.float32))
            for _ in range(3)]
    srv.close(drain=False)
    failed = sum(1 for f in late
                 if isinstance(f.exception(timeout=60), ServingClosed))
    assert failed + sum(1 for f in late if f.exception(timeout=60) is None) \
        == len(late)
    assert srv.stats()["dropped"] == 0


def test_wrong_width_rejected_at_intake(models):
    g, X, _ = models["a"]
    with Server(max_batch_wait_us=0, device=CPU) as srv:
        srv.register("m", g)
        with pytest.raises(LightGBMError, match="columns per raw row"):
            srv.submit("m", X[:4, :-1])
        np.testing.assert_array_equal(
            srv.predict("m", X[:32], raw_score=True), ref(g, X[:32]))


# ---- telemetry ----

def test_serving_zero_telemetry_calls_when_off(models, monkeypatch):
    from lightgbm_tpu_torch.obs import quality as obs_quality
    from lightgbm_tpu_torch.obs import spans as obs_spans
    from lightgbm_tpu_torch.obs.registry import Telemetry
    calls = []

    def spy(name):
        orig = getattr(Telemetry, name)

        def wrapper(self, *a, **k):
            calls.append((name, a))
            return orig(self, *a, **k)
        return wrapper

    for name in ("event", "counter", "gauge", "histogram", "time_block"):
        monkeypatch.setattr(Telemetry, name, spy(name))
    monkeypatch.setattr(obs_spans, "record_span",
                        lambda *a, **k: calls.append(("record_span", a)))
    monkeypatch.setattr(obs_quality.QualityMonitor, "observe",
                        lambda self, *a, **k: calls.append(("observe", a)))
    assert obs.active() is None
    g, X, _ = models["a"]
    gB, _, _ = models["b"]
    with Server(max_batch_wait_us=200, single_row_fast=True,
                device=CPU) as srv:
        srv.register("m", g)
        srv.predict("m", X[:64], raw_score=True)
        srv.predict("m", X[0], raw_score=True)
        srv.swap("m", gB, warm=False)
        srv.predict("m", X[:64], raw_score=True)
    assert calls == []


def _serve_run(server_cls, g, X, gB, **reg_kw):
    """The JAX serving summary test's traffic on ``server_cls``."""
    with server_cls(max_batch_wait_us=500, single_row_fast=True,
                    **reg_kw) as srv:
        srv.register("m", g)
        for n in (1, 17, 64):
            srv.predict("m", X[:n], raw_score=True)
        srv.swap("m", gB, warm=False)
        srv.predict("m", X[:32], raw_score=True)


def test_serving_summary_block_equals_jax(models, tmp_path):
    """The serving block of the port's summary equals the JAX run's in
    kind and count on the same traffic; every event validates."""
    from lightgbm_tpu.obs.report import summarize as jax_summarize
    from lightgbm_tpu_torch.obs.report import human_table, summarize
    g, X, jb = models["a"]
    gB, _, jbB = models["b"]
    out = str(tmp_path / "serve.jsonl")
    tele = obs.configure(out=out, entry="test_torch_serving")
    _serve_run(Server, g, X, gB, device=CPU)
    summary = summarize(tele)
    obs.disable()
    jtele = jax_obs.configure(out=str(tmp_path / "jax.jsonl"))
    _serve_run(JServer, jb, X, jbB)
    jsummary = jax_summarize(jtele)
    jax_obs.disable()
    srv, jsrv = summary["serving"], jsummary["serving"]
    assert set(srv) == set(jsrv)
    m, jm = srv["models"]["m"], jsrv["models"]["m"]
    assert m["requests"] == jm["requests"] == 4
    assert m["rows"] == jm["rows"] == 1 + 17 + 64 + 32
    assert m["latency_s"]["count"] == jm["latency_s"]["count"] == 4
    for key in ("batches", "single_row_fast", "swaps", "evictions",
                "readmits", "rejected", "failed", "dropped"):
        assert srv[key] == jsrv[key], key
    assert srv["precisions"] == jsrv["precisions"]
    assert "serving:" in human_table(summary)
    kinds = {e["kind"] for e in obs.read_events(out)}
    assert {"serve_batch", "serve_swap", "span"} <= kinds


def test_served_batches_feed_the_quality_plane(models, tmp_path):
    """Served rows fold into the drift counters of the generation that
    served them, and a swap starts a new generation."""
    g, X, jb = models["bin"]
    ds = layout_of(X, jb)
    tele = obs.configure(out=str(tmp_path / "q.jsonl"))
    with Server(max_batch_wait_us=0, device=CPU) as srv:
        srv.register("m", g, layout_ds=ds)
        srv.predict("m", X[:300], raw_score=True)
        srv.swap("m", g, layout_ds=ds, warm=False)
        srv.predict("m", X[300:600], raw_score=True)
    q = tele.quality.snapshot()
    obs.disable()
    assert q["models"]["m"]["generation"] == 2
    assert set(q["generations"]["m"]) == {"1", "2"}
    assert q["generations"]["m"]["1"]["rows"] == 300
    assert q["models"]["m"]["monitored"]


# ---- entry points ----

def test_engine_and_booster_serve_entrypoints(models, tmp_path):
    g, X, _ = models["a"]
    gB, _, _ = models["b"]
    path = str(tmp_path / "m.txt")
    g.save_model(path)
    want = ref(g, X[:32])
    out = str(tmp_path / "serve.jsonl")
    with P.serve({"live": g, "file": path},
                 params={"max_batch_wait_us": 100, "telemetry_out": out},
                 device=CPU) as srv:
        np.testing.assert_array_equal(srv.predict("live", X[:32],
                                                  raw_score=True), want)
        np.testing.assert_array_equal(srv.predict("file", X[:32],
                                                  raw_score=True), want)
        srv.swap("live", gB)
    # the run serve opened is finalized and released by close()
    assert obs.active() is None
    import json
    with open(out + ".summary.json") as fh:
        assert json.load(fh)["serving"]["swaps"] == 1
    bst = P.Booster(model_file=path, device=CPU)
    with bst.serve("m") as srv:
        assert srv.device.type == "cpu"
        np.testing.assert_array_equal(srv.predict("m", X[:32],
                                                  raw_score=True), want)


def test_cli_task_serve_matches_predict(tmp_path):
    """CLI task=serve writes task=predict's output line for line (>= 512
    rows: both in the f32 regime) and equals the JAX CLI's serve output."""
    import json

    from lightgbm_tpu.cli import Application as JApplication
    from lightgbm_tpu_torch.cli import Application
    from lightgbm_tpu_torch.utils.log import Log
    rng = np.random.RandomState(0)
    X = rng.normal(size=(1300, 6))
    y = (X[:, 0] * 2 + X[:, 1] > 0).astype(float)
    train, test = str(tmp_path / "d.train"), str(tmp_path / "d.test")
    for path, rows, labels in ((train, X[:700], y[:700]),
                               (test, X[700:], y[700:])):
        with open(path, "w") as fh:
            for row, lab in zip(rows, labels):
                fh.write("%g\t" % lab + "\t".join("%g" % v for v in row)
                         + "\n")
    model = str(tmp_path / "model.txt")
    level = Log._level
    try:
        JApplication(["task=train", "data=%s" % train, "objective=binary",
                      "num_trees=10", "num_leaves=15",
                      "output_model=%s" % model, "verbosity=-1"]).run()
        out_p, out_s = str(tmp_path / "p.txt"), str(tmp_path / "s.txt")
        out_j = str(tmp_path / "j.txt")
        Application(["task=predict", "data=%s" % test,
                     "input_model=%s" % model, "output_result=%s" % out_p,
                     "verbosity=-1"], device=CPU).run()
        tele_out = str(tmp_path / "serve.jsonl")
        Application(["task=serve", "data=%s" % test,
                     "input_model=%s" % model, "output_result=%s" % out_s,
                     "verbosity=-1", "serve_single_row_fast=true",
                     "max_batch_wait_us=2000",
                     "telemetry_out=%s" % tele_out], device=CPU).run()
        JApplication(["task=serve", "data=%s" % test,
                      "input_model=%s" % model, "output_result=%s" % out_j,
                      "verbosity=-1"]).run()
        with open(out_p) as a, open(out_s) as b, open(out_j) as c:
            assert a.read() == b.read() == c.read()
        with open(tele_out + ".summary.json") as fh:
            summary = json.load(fh)
        assert summary["serving"]["models"]["model"]["requests"] == 600
        assert summary["rows_served"] == 600
        with pytest.raises(LightGBMError, match="task=predict"):
            Application(["task=serve", "data=%s" % test,
                         "input_model=%s" % model, "predict_leaf_index=true",
                         "output_result=%s" % out_s, "verbosity=-1"],
                        device=CPU).run()
    finally:
        Log.reset_level(level)


def test_serving_config_params():
    cfg = Config(max_batch_wait_us=500, serve_residency_budget_mb=64,
                 serve_single_row_fast=True)
    assert cfg.max_batch_wait_us == 500
    assert cfg.serve_residency_budget_mb == 64.0
    assert cfg.serve_single_row_fast is True
    cfg2 = Config({"serve_batch_wait_us": 300, "single_row_fast": "true",
                   "residency_budget_mb": 16})
    assert cfg2.max_batch_wait_us == 300
    assert cfg2.serve_single_row_fast is True
    assert cfg2.serve_residency_budget_mb == 16.0
    with pytest.raises(Exception):
        Config(max_batch_wait_us=-1)
    with pytest.raises(Exception):
        Config(serve_residency_budget_mb=float("nan"))
    srv = Server(config=cfg, device=CPU)
    assert srv.wait_s == pytest.approx(500e-6)
    assert srv.single_row_fast is True
    assert srv.registry.budget_bytes == 64 << 20
    srv.close()
