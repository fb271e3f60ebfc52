"""The empirical planner: time candidate plans on the card, persist winners.

The counterpart of ``lightgbm_tpu/plan/autotune.py`` (:1-324).  For each
(shape class, card) the tuner:

1. lists the candidate plans (:func:`candidate_plans`): the analytic plan
   first, then the split pass's block bytes halved and doubled (its tile
   clamped to [32, 2048] rows), the integer histogram's target blocks at
   132 and 528 beside 264 (quantized shape classes only: the exact builds
   never launch the integer kernel), and the predict walk's budget halved
   and doubled; a candidate that dispatches like one already listed at the
   class's row width is dropped;
2. times each candidate (:class:`TuneDriver`) on a synthetic set of the
   class's shape (autotune.py:137-172 of the JAX package): one grown tree
   under the candidate (``measure_train``) and one predict dispatch of a
   chunk of rows through the walk (``measure_predict``), with CUDA events
   after a warm-up on the card; the first dispatch is noted as a miss in
   the port's compile accounting (``obs/compile.py``), so a kernel build
   never counts as a candidate's steady time;
3. merges the per-site winners (:func:`tune_shape`: the split pass and the
   integer histogram by the tree's time, the walk by the dispatch's) and
   persists them (:func:`run_sweep`) into the plan cache.

Every candidate gives the same bits (``plan/planner.py``): the tuner races
time, never results.  ``timer`` is injectable (the tests rank synthetic
walls).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from . import cache as _cache
from . import planner

# the integer histogram's target blocks raced beside the analytic 264
INT_BLOCK_CANDIDATES = (132, 528)
# the predict fixture: trees repeated to this count, rows of one walk chunk
PREDICT_TREES = 128
PREDICT_ROWS = 524288


class Candidate(NamedTuple):
    name: str
    plan: planner.Plan
    site: str          # "analytic", "part", "int" or "walk"


def _dispatch(plan: planner.Plan, sc: planner.ShapeClass) -> tuple:
    """What a plan changes at ``sc``: the split pass's tile at the class's
    row width, the integer grid's target (quantized classes), the walk's
    budget and the ladder."""
    return (planner.part_tile(plan.part_block_bytes, planner.row_width(sc)),
            int(plan.int_fill_blocks) if sc.quantized else None,
            int(plan.walk_temp_bytes), tuple(plan.predict_buckets))


def candidate_plans(sc: planner.ShapeClass) -> Tuple[Candidate, ...]:
    """The race field of one shape class: analytic first, then each site's
    variations that are valid and dispatch differently at ``sc``."""
    base = planner.analytic_plan(sc)
    out: List[Candidate] = [Candidate("analytic", base, "analytic")]

    def add(name: str, site: str, **fields) -> None:
        plan = base._replace(provenance="tuned", **fields)
        try:
            planner.validate_plan(plan)
        except ValueError:
            return
        if any(_dispatch(c.plan, sc) == _dispatch(plan, sc) for c in out):
            return
        out.append(Candidate(name, plan, site))

    pb = int(base.part_block_bytes)
    add("part-half", "part", part_block_bytes=pb // 2)
    add("part-double", "part", part_block_bytes=pb * 2)
    if sc.quantized:
        for blocks in INT_BLOCK_CANDIDATES:
            add("int-%d" % blocks, "int", int_fill_blocks=blocks)
    wb = int(base.walk_temp_bytes)
    add("walk-half", "walk", walk_temp_bytes=wb // 2)
    add("walk-double", "walk", walk_temp_bytes=wb * 2)
    return tuple(out)


def _default_timer(fn, device) -> float:
    """Seconds of one call, the device's work included: CUDA events on a
    card, the host clock on the CPU."""
    import torch
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _steady_of(acct, fn: str, bucket: str) -> Optional[Dict[str, Any]]:
    return (acct.snapshot().get("keys") or {}).get("%s|%s" % (fn, bucket))


class TuneDriver:
    """The synthetic workload of ONE shape class and the candidates'
    measurements on it.  ``timer(fn) -> seconds`` is injectable."""

    def __init__(self, sc: planner.ShapeClass, *, reps: int = 4, timer=None,
                 trees: int = 8, seed: int = 11, device=None) -> None:
        from ..device import resolve_device
        from ..obs.compile import CompileAccounting
        self.sc = sc
        self.device = resolve_device(device)
        self.reps = max(2, int(reps))
        self.timer = timer
        self.trees = int(trees)
        self.seed = int(seed)
        self._fixture = None
        # one accountant a driver, keyed (site, candidate)
        self.acct = CompileAccounting()

    def _time(self, fn) -> float:
        if self.timer is not None:
            return float(self.timer(fn))
        return _default_timer(fn, self.device)

    # ---- fixture: dataset, booster and a small trained model ----

    def _fixture_parts(self):
        """A regression set of the class's rows and features at its bins
        (the JAX fixture, autotune.py:137-172), quantized for a quantized
        class, and the gradients a tree grows from."""
        if self._fixture is not None:
            return self._fixture
        import numpy as np
        import torch

        from ..boosting.gbdt import GBDT
        from ..config import Config
        from ..io.dataset import BinnedDataset
        from ..objective import create_objective

        sc = self.sc
        n = max(1024, sc.n_rows)
        f = max(2, sc.num_features)
        max_bin = max(3, min(sc.num_bins - 1, 255))
        rng = np.random.RandomState(self.seed)
        X = rng.normal(size=(n, f)).astype(np.float32)
        y = X[:, 0] * 1.5 + np.sin(X[:, 1]) + rng.normal(scale=0.1, size=n)
        ds = BinnedDataset.from_matrix(X, label=y, max_bin=max_bin)
        cfg = Config(objective="regression", num_leaves=15,
                     num_iterations=self.trees, min_data_in_leaf=2,
                     verbosity=-1, hist_precision=("quantized"
                                                   if sc.quantized
                                                   else "exact"))
        booster = GBDT(cfg, ds, create_objective("regression", cfg,
                                                 self.device),
                       device=self.device)
        grad = torch.as_tensor(rng.normal(size=n).astype(np.float32),
                               device=self.device)
        hess = torch.as_tensor(
            np.abs(rng.normal(size=n)).astype(np.float32) + 0.1,
            device=self.device)
        self._fixture = (booster, grad, hess, X)
        return self._fixture

    def _trained_trees(self):
        booster = self._fixture_parts()[0]
        if booster.num_trees == 0:
            booster.train()
        return list(booster.models)

    # ---- per-candidate measurements ----

    def measure_train(self, cand: Candidate) -> Optional[Dict[str, Any]]:
        """One tree grown per rep with the candidate as the learner's plan
        (the first rep a noted miss).  Key ("train_tree", name)."""
        booster, grad, hess, _ = self._fixture_parts()
        learner = booster.learner
        prev = learner.plan
        learner.plan = cand.plan
        n = int(grad.shape[0])
        try:
            for rep in range(self.reps + 1):
                wall = self._time(lambda: learner.train(grad, hess, n))
                self.acct.note(None, "train_tree", cand.name, wall,
                               1 if rep == 0 else 0)
        finally:
            learner.plan = prev
        return _steady_of(self.acct, "train_tree", cand.name)

    def measure_predict(self, cand: Candidate) -> Optional[Dict[str, Any]]:
        """The f32 walk of the fixture's trees repeated to
        :data:`PREDICT_TREES` over one chunk of rows, under the candidate.
        Key ("predict_walk", name)."""
        import torch

        from ..core.predict import StackedTrees
        from . import state
        trees = self._trained_trees()
        if not trees:
            return None
        X = self._fixture_parts()[3]
        reps = -(-PREDICT_TREES // len(trees))
        stacked = StackedTrees((trees * reps)[:PREDICT_TREES],
                               device=self.device)
        rows = X[:min(len(X), PREDICT_ROWS)]
        with state.dispatching(cand.plan):
            for rep in range(self.reps + 1):
                wall = self._time(lambda: stacked.predict(rows,
                                                          torch.float32))
                self.acct.note(None, "predict_walk", cand.name, wall,
                               1 if rep == 0 else 0)
        return _steady_of(self.acct, "predict_walk", cand.name)


def tune_shape(sc: planner.ShapeClass, *, reps: int = 4, timer=None,
               driver: Optional[TuneDriver] = None, device=None,
               progress=None) -> Dict[str, Any]:
    """Race every candidate of one shape class; returns the candidate table
    and the merged winner (each site's fastest variation: the sites are
    independent dispatches, so their winners compose).  ``progress(row)``
    is called after each candidate."""
    driver = driver or TuneDriver(sc, reps=reps, timer=timer, device=device)
    table: List[Dict[str, Any]] = []
    for cand in candidate_plans(sc):
        row: Dict[str, Any] = {"name": cand.name, "site": cand.site,
                               "plan": planner.plan_to_dict(cand.plan)}
        if cand.site in ("analytic", "part", "int"):
            st = driver.measure_train(cand)
            if st:
                row["train_steady_p50_s"] = st.get("steady_p50_s")
                row["train_compile_s"] = st.get("compile_s")
        if cand.site in ("analytic", "walk"):
            st = driver.measure_predict(cand)
            if st:
                row["predict_steady_p50_s"] = st.get("steady_p50_s")
                row["predict_compile_s"] = st.get("compile_s")
        table.append(row)
        if progress is not None:
            progress(row)

    base = table[0]
    winner = planner.plan_from_dict(base["plan"])
    parts, margin = [], {}
    for site, metric, fields in (
            ("part", "train_steady_p50_s", ("part_block_bytes",)),
            ("int", "train_steady_p50_s", ("int_fill_blocks",)),
            ("walk", "predict_steady_p50_s", ("walk_temp_bytes",))):
        rows = [r for r in table if r["site"] in ("analytic", site)
                and r.get(metric) is not None]
        if len(rows) < 2:
            continue
        best = min(rows, key=lambda r: r[metric])
        if best["name"] != "analytic":
            w = planner.plan_from_dict(best["plan"])
            winner = winner._replace(**{f: getattr(w, f) for f in fields})
            parts.append(best["name"])
        if base.get(metric):
            margin[site] = (float(base[metric])
                            / max(float(best[metric]), 1e-12))
    winner = winner._replace(provenance="tuned")
    planner.validate_plan(winner)
    return {"key": planner.plan_key(sc), "shape": list(sc),
            "candidates": table,
            "winner": {"name": "+".join(parts) or "analytic",
                       "plan": planner.plan_to_dict(winner)},
            "margin": margin}


def run_sweep(shapes, *, cache_path: Optional[str] = None, reps: int = 4,
              timer=None, device_kind: Optional[str] = None,
              fixture_rows: Optional[int] = None, trees: int = 8,
              device=None, progress=None) -> Dict[str, Any]:
    """Tune every shape class, persist the winners into the plan cache and
    return the report.  ``fixture_rows`` caps the synthetic set's rows
    while the entry stays keyed by the requested class; ``progress(sc,
    res)`` is called after each class."""
    from . import device_specs
    if device_kind is None:
        device_kind = device_specs.current_device_kind(device)
    cache = _cache.PlanCache(device_kind=str(device_kind), path=cache_path)
    results = []
    for sc in shapes:
        sc = sc._replace(device_kind=str(device_kind))
        fx = sc.n_rows if fixture_rows is None else min(sc.n_rows,
                                                        int(fixture_rows))
        driver = TuneDriver(sc._replace(n_rows=fx), reps=reps, timer=timer,
                            trees=trees, device=device)
        res = tune_shape(sc._replace(n_rows=fx), driver=driver)
        res["key"] = planner.plan_key(sc)
        res["fixture_rows"] = fx
        cache.put(sc, planner.plan_from_dict(res["winner"]["plan"]),
                  metrics=res["margin"])
        results.append(res)
        if progress is not None:
            progress(sc, res)
    path = cache.save(cache_path) if results else None
    return {"device_kind": str(device_kind), "cache": path,
            "shapes": results}
