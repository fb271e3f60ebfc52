"""The port's kernel planner and autotuner (``lightgbm_tpu_torch/plan``)
against the JAX package's (``lightgbm_tpu/plan``), on the CPU.

- ``plan_key`` strings are equal letter for letter in both packages;
- the analytic plan equals the constants the four dispatch sites used
  before the planner (a golden), and each site reads the active plan;
- the cache's round trip, its fallbacks (corrupt, foreign version, plan
  schema or card: one warning, the counter) and the resolution precedence
  (pinned > tuned > analytic) behave as the JAX package's; a JAX cache file
  is foreign to the port and never half-applied;
- candidate plans are valid and distinct, the site winners merge, a sweep
  writes a cache that ``train()`` engages with provenance ``tuned`` in the
  summary, and a pinned candidate's model is byte-equal to the analytic
  one's.
"""
import json
import os

import numpy as np
import pytest

import lightgbm_tpu_torch as P
from lightgbm_tpu.plan import cache as j_cache
from lightgbm_tpu.plan import planner as j_planner
from lightgbm_tpu.plan import state as j_state
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.core import histogram as H
from lightgbm_tpu_torch.core import partition as PT
from lightgbm_tpu_torch.core import predict_fused as PF
from lightgbm_tpu_torch.core.predict import StackedTrees
from lightgbm_tpu_torch.plan import autotune, device_specs, planner
from lightgbm_tpu_torch.plan import cache as plan_cache
from lightgbm_tpu_torch.plan import state as plan_state

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_plan_state():
    """Every test starts with no engaged cache, no pin and zero counters,
    in both packages."""
    for st, ca in ((plan_state, plan_cache), (j_state, j_cache)):
        st.reset()
        ca.reset_fallbacks()
    yield
    for st, ca in ((plan_state, plan_cache), (j_state, j_cache)):
        st.reset()
        ca.reset_fallbacks()
    obs.disable()


def _sc(n=4096, f=8, b=32, **kw):
    kw.setdefault("device_kind", "cpu")
    return planner.shape_class(n, f, b, **kw)


KEY_SHAPES = [
    dict(n=11_000_000, f=28, b=256),
    dict(n=1 << 20, f=28, b=256, quantized=True),
    dict(n=65_536, f=968, b=64, packed=True),
    dict(n=400_000, f=2000, b=256, bpc=2, num_class=5),
    dict(n=1000, f=8, b=32, device_kind="nvidia h100 80gb hbm3"),
    dict(n=993, f=8, b=16, packed=True, quantized=True),
]


@pytest.mark.parametrize("shape", KEY_SHAPES)
def test_plan_key_equals_the_jax_package(shape):
    shape = dict(shape)
    n, f, b = shape.pop("n"), shape.pop("f"), shape.pop("b")
    shape.setdefault("device_kind", "cpu")
    ours = planner.shape_class(n, f, b, **shape)
    theirs = j_planner.shape_class(n, f, b, **shape)
    assert tuple(ours) == tuple(theirs)
    assert planner.plan_key(ours) == j_planner.plan_key(theirs)


# ---- analytic plan and the dispatch sites ----

def test_analytic_plan_equals_todays_constants():
    plan = planner.analytic_plan(_sc(11_000_000, 28, 256))
    assert plan == planner.Plan(part_block_bytes=128 << 10,
                                int_fill_blocks=2 * 132,
                                walk_temp_bytes=1 << 31,
                                predict_buckets=(128, 1024, 8192, 65536,
                                                 524288),
                                provenance="analytic")
    planner.validate_plan(plan)
    assert device_specs.INT_FILL_BLOCKS == 264
    assert PF.PREDICT_BUCKETS == plan.predict_buckets


@pytest.mark.parametrize("W,rows", [(64, 2048), (128, 1024), (256, 512),
                                    (2048, 64), (8192, 32)])
def test_analytic_sites_read_the_constants(W, rows):
    assert PT.part_tile_rows(W) == rows
    assert plan_state.part_block_bytes() == 128 << 10
    assert plan_state.int_fill_blocks() == 264
    assert plan_state.walk_temp_bytes() == 1 << 31
    assert plan_state.predict_buckets() == PF.PREDICT_BUCKETS
    assert H.int_hist_grid(20_000, 28, 256) == H.int_hist_grid(
        20_000, 28, 256, 264)


def test_sites_read_the_dispatch_plan():
    plan = planner.analytic_plan()._replace(
        part_block_bytes=64 << 10, int_fill_blocks=132,
        walk_temp_bytes=1 << 20, predict_buckets=(64, 4096))
    stack = StackedTrees([P.core.tree.Tree(1)] * 200, device=CPU)
    base_block = stack.block_size(1000)
    with plan_state.dispatching(plan):
        assert PT.part_tile_rows(128) == 512
        assert H.int_hist_grid(1 << 20, 28, 256) == H.int_hist_grid(
            1 << 20, 28, 256, 132)
        assert stack.block_size(1000) == (1 << 20) // (1000 * 96)
        assert PF.shape_bucket(50) == 64
        assert PF.shape_bucket(100) == 4096
        assert PF.shape_bucket(1 << 20) == 4096
    assert PT.part_tile_rows(128) == 1024
    assert stack.block_size(1000) == base_block == 200
    # a pin reaches every thread's sites
    with plan_state.pinned(plan):
        assert PT.part_tile_rows(128) == 512
        assert plan_state.walk_temp_bytes() == 1 << 20


@pytest.mark.parametrize("field,value", [
    ("part_block_bytes", 2 << 10),      # 16-row tile at W = 128
    ("part_block_bytes", 512 << 10),    # 4096-row tile
    ("int_fill_blocks", 0),
    ("walk_temp_bytes", 0),
    ("predict_buckets", (1024, 128)),
    ("predict_buckets", ()),
    ("provenance", "guessed"),
])
def test_validate_plan_refuses(field, value):
    with pytest.raises(ValueError):
        planner.validate_plan(planner.analytic_plan()._replace(
            **{field: value}))


def test_device_specs():
    h100 = device_specs.spec_for("nvidia h100 80gb hbm3")
    assert (h100.kind, h100.sm_count, h100.smem_block_bytes,
            h100.hbm_bw) == ("h100", 132, 232_448, 3.35e12)
    assert h100.peak_ops == 17e12
    assert device_specs.spec_for("nvidia h100 pcie").sm_count == 114
    cpu = device_specs.spec_for("cpu")
    assert cpu.hbm_bw is None and cpu.peak_ops is None
    assert device_specs.device_peaks("cpu") is None
    assert device_specs.current_device_kind(CPU) == "cpu"
    assert device_specs.current_device_kind() == "cpu"  # no CUDA here


def test_default_cache_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(plan_cache.CACHE_DIR_ENV, raising=False)
    path = plan_cache.default_cache_path()
    assert path.endswith(os.path.join("build", "plan", "plan_cache.json"))
    assert "lightgbm_tpu_jax_cache" not in path
    monkeypatch.setenv(plan_cache.CACHE_DIR_ENV, "/x/y")
    assert plan_cache.default_cache_path() == "/x/y/plan_cache.json"


# ---- the cache, beside the JAX package's ----

def _tuned(pkg_planner, sc):
    base = pkg_planner.analytic_plan(sc)
    if pkg_planner is planner:
        return base._replace(part_block_bytes=64 << 10)
    return base._replace(bucket_plan=((False, 4096, None),),
                         level_ladder=((False, 4096, None),))


PKGS = {"port": (planner, plan_cache, plan_state),
        "jax": (j_planner, j_cache, j_state)}


@pytest.mark.parametrize("pkg", list(PKGS))
def test_cache_round_trip(pkg, tmp_path):
    pl, ca, _ = PKGS[pkg]
    sc = pl.shape_class(8192, 8, 32, device_kind="cpu")
    cache = ca.PlanCache(device_kind="cpu")
    cache.put(sc, _tuned(pl, sc), metrics={"train": 1.25})
    path = cache.save(str(tmp_path / "plans.json"))
    loaded = ca.load_cache(path, device_kind="cpu")
    got = loaded.lookup(sc)
    assert got is not None and got.provenance == "tuned"
    assert got[:-1] == _tuned(pl, sc)[:-1]
    # the same power-of-two class serves; another class misses silently
    assert loaded.lookup(pl.shape_class(8000, 8, 32,
                                        device_kind="cpu")) is not None
    assert loaded.lookup(pl.shape_class(1 << 20, 8, 32,
                                        device_kind="cpu")) is None
    assert ca.fallback_count() == 0


def _warnings(monkeypatch, log_cls):
    hits = []
    orig = log_cls.warning

    def counting(msg, *a):
        if "plan cache" in str(msg):
            hits.append(msg)
        orig(msg, *a)
    monkeypatch.setattr(log_cls, "warning", staticmethod(counting))
    return hits


@pytest.mark.parametrize("pkg", list(PKGS))
def test_corrupt_cache_falls_back_with_one_warning(pkg, tmp_path,
                                                   monkeypatch):
    from lightgbm_tpu.utils.log import Log as JLog
    from lightgbm_tpu_torch.utils.log import Log
    _, ca, st = PKGS[pkg]
    hits = _warnings(monkeypatch, Log if pkg == "port" else JLog)
    path = str(tmp_path / "plans.json")
    with open(path, "w") as fh:
        fh.write("{ not json")
    assert ca.load_cache(path) is None
    assert ca.load_cache(path) is None
    assert ca.fallback_count() == 2
    assert len(hits) == 1
    assert st.resolve(4096, 8, 32, device_kind="cpu").provenance \
        == "analytic"


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("field,value", [("version", 99),
                                         ("plan_schema", 99),
                                         ("device_kind", "tpu v5 lite")])
def test_foreign_cache_falls_back(pkg, field, value, tmp_path):
    pl, ca, _ = PKGS[pkg]
    sc = pl.shape_class(4096, 8, 32, device_kind="cpu")
    cache = ca.PlanCache(device_kind="cpu")
    cache.put(sc, pl.analytic_plan(sc))
    path = cache.save(str(tmp_path / "plans.json"))
    doc = json.load(open(path))
    doc[field] = value
    json.dump(doc, open(path, "w"))
    assert ca.load_cache(path, device_kind="cpu") is None
    assert ca.fallback_count() == 1
    # a missing file is the silent default, not a fallback
    assert ca.load_cache(str(tmp_path / "nope.json")) is None
    assert ca.fallback_count() == 1


def test_jax_cache_file_is_foreign_and_never_half_applied(tmp_path):
    sc = j_planner.shape_class(4096, 8, 32, device_kind="cpu")
    cache = j_cache.PlanCache(device_kind="cpu")
    cache.put(sc, _tuned(j_planner, sc))
    path = cache.save(str(tmp_path / "jax_plans.json"))
    assert plan_cache.load_cache(path, device_kind="cpu") is None
    assert plan_cache.fallback_count() == 1
    assert plan_state.configure(path) is None
    plan = plan_state.resolve(4096, 8, 32, device_kind="cpu")
    assert plan == planner.analytic_plan()
    # even stamped as the port's, the TPU's fields are refused
    doc = json.load(open(path))
    doc["package"] = plan_cache.PACKAGE
    json.dump(doc, open(path, "w"))
    assert plan_cache.load_cache(path, device_kind="cpu") is None


@pytest.mark.parametrize("pkg", list(PKGS))
def test_resolve_precedence_pinned_over_tuned(pkg, tmp_path):
    pl, ca, st = PKGS[pkg]
    sc = pl.shape_class(8192, 8, 32, device_kind="cpu")
    cache = ca.PlanCache(device_kind="cpu")
    cache.put(sc, _tuned(pl, sc))
    path = cache.save(str(tmp_path / "plans.json"))
    assert st.configure(path) is not None
    got = st.resolve(8192, 8, 32, device_kind="cpu")
    assert got.provenance == "tuned" and got[:-1] == _tuned(pl, sc)[:-1]
    assert st.current_provenance() == "tuned"
    with st.pinned(pl.analytic_plan(sc)):
        assert st.resolve(8192, 8, 32,
                          device_kind="cpu").provenance == "pinned"
        assert st.current_provenance() == "pinned"
    assert st.resolve(1 << 20, 8, 32,
                      device_kind="cpu").provenance == "analytic"


@pytest.mark.parametrize("pkg", list(PKGS))
def test_missing_explicit_path_counts_and_discovery_keeps_it(pkg,
                                                             tmp_path):
    pl, ca, st = PKGS[pkg]
    cfg = type("C", (), {"plan_cache": str(tmp_path / "nope.json")})()
    assert st.configure_from_config(cfg) is None
    assert ca.fallback_count() == 1 and st.configured_path() is None
    sc = pl.shape_class(8192, 8, 32, device_kind="cpu")
    cache = ca.PlanCache(device_kind="cpu")
    cache.put(sc, _tuned(pl, sc))
    path = cache.save(str(tmp_path / "plans.json"))
    assert st.configure(path) is not None
    # an entry point's default discovery keeps the explicit engagement
    assert st.configure_from_config(type("C", (), {"plan_cache": ""})()) \
        is not None
    assert st.configured_path() == path


def test_model_sites_need_cache_consensus(tmp_path):
    cache = plan_cache.PlanCache(device_kind="cpu")
    a, b = _sc(8192, 8, 32), _sc(1 << 20, 28, 256)
    cache.put(a, planner.analytic_plan(a)._replace(walk_temp_bytes=1 << 30))
    cache.put(b, planner.analytic_plan(b)._replace(walk_temp_bytes=1 << 32))
    plan_state.configure(cache.save(str(tmp_path / "p.json")))
    assert plan_state.walk_temp_bytes() == planner.WALK_TEMP_BYTES
    cache.put(b, planner.analytic_plan(b)._replace(walk_temp_bytes=1 << 30))
    plan_state.configure(cache.save(str(tmp_path / "p.json")))
    assert plan_state.walk_temp_bytes() == 1 << 30
    assert plan_state.predict_buckets() == PF.PREDICT_BUCKETS


# ---- telemetry ----

def test_stamp_reaches_summary_events_and_exporter(tmp_path):
    from lightgbm_tpu_torch.obs import report
    from lightgbm_tpu_torch.obs.exporter import render_prometheus
    from lightgbm_tpu_torch.obs.registry import validate_event
    tele = obs.configure(out=None)
    plan_state.stamp(tele, "tree_build", "analytic", key="n4096_b32",
                     mode="leaf")
    plan_state.stamp(tele, "tree_build", "analytic", key="n4096_b32",
                     mode="leaf")
    plan_state.stamp(tele, "serving_warm", "tuned", key="m",
                     buckets="128,1024")
    events = [e for e in tele.events if e["kind"] == "plan"]
    assert len(events) == 2
    for e in events:
        validate_event(e)
    path = str(tmp_path / "bad.json")
    with open(path, "w") as fh:
        fh.write("garbage")
    assert plan_cache.load_cache(path) is None
    summary = report.summarize(tele)
    assert summary["plan"]["provenance"] == "tuned"
    assert summary["plan"]["sites"]["tree_build"] == {
        "provenance": "analytic", "key": "n4096_b32", "mode": "leaf"}
    assert summary["plan"]["cache_fallbacks"] == 1
    assert "plan provenance" in report.human_table(summary)
    text = render_prometheus(tele.registry.snapshot())
    assert "lgbm_tpu_plan_cache_fallbacks_total 1" in text
    assert text.count("lgbm_tpu_plan_cache_fallbacks_total") == 2


# ---- the autotuner ----

@pytest.mark.parametrize("quantized,names", [
    (False, ["analytic", "part-half", "part-double", "walk-half",
             "walk-double"]),
    (True, ["analytic", "part-half", "part-double", "int-132", "int-528",
            "walk-half", "walk-double"])])
def test_candidate_plans_are_valid_and_distinct(quantized, names):
    sc = _sc(1 << 20, 28, 256, quantized=quantized)
    cands = autotune.candidate_plans(sc)
    assert [c.name for c in cands] == names
    assert cands[0].plan == planner.analytic_plan(sc)
    seen = set()
    for c in cands:
        planner.validate_plan(c.plan)
        d = autotune._dispatch(c.plan, sc)
        assert d not in seen
        seen.add(d)
    tiles = [planner.part_tile(c.plan.part_block_bytes, 128) for c in cands]
    assert sorted(set(tiles)) == [512, 1024, 2048]


def test_candidates_whose_tile_clamps_are_dropped():
    # W = 4096: the analytic tile is 32 rows, and half of it clamps to 32
    sc = _sc(1 << 16, 4080, 256)
    assert planner.row_width(sc) == 4096
    names = [c.name for c in autotune.candidate_plans(sc)]
    assert "part-half" not in names and "part-double" in names


class _FakeDriver:
    """Scripted steady medians: the ranking and merge without kernels."""

    def __init__(self, train_s, predict_s):
        self.train_s, self.predict_s = train_s, predict_s

    def measure_train(self, cand):
        v = self.train_s.get(cand.name)
        return None if v is None else {"steady_p50_s": v, "compile_s": 0.1}

    def measure_predict(self, cand):
        v = self.predict_s.get(cand.name)
        return None if v is None else {"steady_p50_s": v, "compile_s": 0.1}


def test_tune_shape_merges_site_winners():
    sc = _sc(1 << 20, 28, 256, quantized=True)
    res = autotune.tune_shape(sc, driver=_FakeDriver(
        train_s={"analytic": 1.0, "part-half": 2.0, "part-double": 0.5,
                 "int-132": 0.8, "int-528": 1.5},
        predict_s={"analytic": 1.0, "walk-half": 0.25, "walk-double": 2.0}))
    win = planner.plan_from_dict(res["winner"]["plan"])
    assert res["winner"]["name"] == "part-double+int-132+walk-half"
    assert (win.part_block_bytes, win.int_fill_blocks,
            win.walk_temp_bytes) == (256 << 10, 132, 1 << 30)
    assert win.provenance == "tuned"
    assert res["margin"] == pytest.approx({"part": 2.0, "int": 1.25,
                                           "walk": 4.0})


def test_tune_shape_keeps_analytic_when_it_wins():
    sc = _sc(1 << 20, 28, 256)
    res = autotune.tune_shape(sc, driver=_FakeDriver(
        train_s={"analytic": 1.0, "part-half": 1.5, "part-double": 2.0},
        predict_s={"analytic": 0.2, "walk-half": 2.0, "walk-double": 0.9}))
    assert res["winner"]["name"] == "analytic"
    assert planner.plan_from_dict(res["winner"]["plan"])[:-1] \
        == planner.analytic_plan(sc)[:-1]


def _data(n=1500, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.2 * rng.normal(size=n) > 0) * 1.0
    return X, y


PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "verbosity": -1, "min_data_in_leaf": 5}


def _text(b):
    t = b.model_to_string()
    return t[:t.index("\nparameters:")]


def test_run_sweep_writes_a_cache_train_engages(tmp_path):
    """A sweep with an injected timer (the candidates' bits are the
    same; the fake walls make part-double and walk-half win), then
    ``train(plan_cache=...)``: provenance tuned in the summary, no
    fallback, the learner under the tuned plan, the model byte-equal to
    the analytic run's."""
    X, y = _data()
    walls = iter(np.linspace(1.0, 0.01, 200))
    path = str(tmp_path / "plans.json")
    ref = P.train(dict(PARAMS), P.Dataset(X, y), 3, device=CPU)
    learner = ref._booster.learner
    sc = planner.shape_class(learner.num_data, X.shape[1], learner.num_bins,
                             device_kind="cpu")
    rep = autotune.run_sweep([sc], cache_path=path, reps=2,
                             timer=lambda fn: (fn(), next(walls))[1],
                             fixture_rows=len(X), device=CPU)
    assert rep["cache"] == path and rep["shapes"][0]["key"] == \
        planner.plan_key(sc)
    names = [r["name"] for r in rep["shapes"][0]["candidates"]]
    assert names == ["analytic", "part-half", "part-double", "walk-half",
                     "walk-double"]
    out = str(tmp_path / "run.jsonl")
    b = P.train(dict(PARAMS, plan_cache=path, telemetry_out=out),
                P.Dataset(X, y), 3, device=CPU)
    assert b._booster.learner.plan.provenance == "tuned"
    assert _text(b) == _text(ref)
    summary = json.load(open(out + ".summary.json"))
    assert summary["plan"]["provenance"] == "tuned"
    assert summary["plan"]["sites"]["tree_build"]["provenance"] == "tuned"
    assert summary["plan"]["cache_fallbacks"] == 0


def test_tune_driver_times_the_real_dispatches():
    """The driver grows the fixture's tree under each candidate's plan and
    walks its trees under each walk budget (CPU walls, two reps)."""
    sc = _sc(2000, 6, 64, quantized=True)
    res = autotune.tune_shape(sc, reps=2, device=CPU)
    rows = {r["name"]: r for r in res["candidates"]}
    assert rows["analytic"]["train_steady_p50_s"] > 0
    assert rows["analytic"]["predict_steady_p50_s"] > 0
    assert rows["int-132"]["train_steady_p50_s"] > 0
    assert "predict_steady_p50_s" not in rows["part-half"]
    assert "train_steady_p50_s" not in rows["walk-half"]


@pytest.mark.parametrize("quantized", [False, True])
def test_pinned_candidates_give_the_analytic_model(quantized):
    X, y = _data()
    params = dict(PARAMS, hist_precision="quantized" if quantized
                  else "exact", bagging_fraction=0.8, bagging_freq=1)
    ref = _text(P.train(dict(params), P.Dataset(X, y), 3, device=CPU))
    sc = _sc(len(X), X.shape[1], 64, quantized=quantized)
    for cand in autotune.candidate_plans(sc)[1:]:
        with plan_state.pinned(cand.plan):
            b = P.train(dict(params), P.Dataset(X, y), 3, device=CPU)
            assert b._booster.learner.plan.provenance == "pinned"
        assert _text(b) == ref, cand.name
