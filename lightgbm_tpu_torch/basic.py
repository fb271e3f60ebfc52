"""Public ``Dataset`` and ``Booster``: ``lightgbm_tpu/basic.py``
(python-package/lightgbm/basic.py) for the PyTorch port (which imports
nothing of the JAX package).

A :class:`Dataset` is binned on the host (lazily, at ``construct``); a
validation set made with ``reference=`` (or ``create_valid``) is binned with
the training set's bin mappers.  Its data is a numpy matrix, a pandas
DataFrame (category columns become their codes, basic.py:47-82), a sparse
matrix, or the path of a text or binary file, loaded by
``io.loader.DatasetLoader`` with its side files.  ``subset``, the
``set_``/``get_`` fields, ``save_binary`` (the ``LGBMTPU1`` format) and
``set_categorical_feature`` follow the JAX package (basic.py:259-359).  A
:class:`Booster` trains on the device its ``device=`` names, ``cuda`` unless
the caller passes ``"cpu"``, and pickles through its model text onto the
same device type.

``Booster.update(fobj=...)`` trains on a custom objective's gradients.  The
booster is built by ``boosting.create_boosting``: ``boosting=gbdt``,
``dart``, ``goss`` or ``rf`` (aliases resolved by the config).  Sparse input
(a scipy sparse matrix or :class:`CSRData`) is binned straight from CSR
without densifying (``BinnedDataset.from_csr``, whose EFB bundles the sparse
features) unless ``categorical_feature`` is given, which the sparse binner
does not take: then it is densified, as in the JAX package (basic.py:85-112,
:227-250).  ``predict`` takes ``pred_leaf``, ``pred_contrib`` and
``precision`` (``exact`` or ``bf16``), ``predict_binned`` a constructed
``Dataset``'s row store; ``save_checkpoint`` and ``resume_from_checkpoint``
carry the train state (``checkpoint.py``).  ``Booster.serve`` starts the
serving tier with the booster resident, and ``telemetry_summary`` reads
the active telemetry run (``obs``).
"""
from __future__ import annotations

import sys
from copy import deepcopy
from typing import Any, Dict, List, Optional, Union

import numpy as np

from .boosting import create_boosting
from .boosting.gbdt import GBDT
from .config import Config, alias_transform
from .device import DeviceLike
from .io.dataset import BinnedDataset
from .io.loader import DatasetLoader
from .metric.metric import create_metrics
from .objective import create_objective
from .utils.log import LightGBMError

__all__ = ["Dataset", "Booster", "CSRData", "LightGBMError"]


_PANDAS_DTYPES = {"int8", "int16", "int32", "int64", "uint8", "uint16",
                  "uint32", "uint64", "float16", "float32", "float64", "bool"}


def _pandas_type(data, name: str) -> bool:
    """``data`` is a pandas ``name`` (DataFrame, Series): pandas is then
    imported already, so the check imports nothing."""
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(data, getattr(pd, name))


def _list_to_1d_numpy(data, dtype):
    if data is None:
        return None
    if _pandas_type(data, "Series"):
        data = data.values
    return np.asarray(data, dtype=dtype).reshape(-1)


def _data_from_pandas(data, feature_name, categorical_feature):
    """DataFrame -> (float64 matrix, names, categorical indices): category
    columns become their codes, -1 becoming NaN (basic.py:47-82 of the JAX
    package, the reference's basic.py:263-330)."""
    if data.shape[0] == 0:
        raise LightGBMError("Input data must not be empty")
    names = [str(c) for c in data.columns]
    cat_cols = [i for i, c in enumerate(data.columns)
                if str(data[c].dtype) == "category"]
    if categorical_feature == "auto":
        categorical = cat_cols
    elif categorical_feature is None:
        categorical = []
    else:
        categorical = [names.index(c) if isinstance(c, str) else int(c)
                       for c in categorical_feature
                       if not isinstance(c, str) or c in names]
    out = np.empty(data.shape, dtype=np.float64)
    for i, c in enumerate(data.columns):
        col = data[c]
        if str(col.dtype) == "category":
            codes = col.cat.codes.values.astype(np.float64)
            codes[codes < 0] = np.nan
            out[:, i] = codes
        else:
            if str(col.dtype) not in _PANDAS_DTYPES:
                raise LightGBMError(
                    "DataFrame.dtypes for data must be int, float or bool. "
                    "Did not expect the data types in field %s" % c)
            out[:, i] = col.values.astype(np.float64)
    if feature_name == "auto":
        feature_name = names
    return out, feature_name, categorical


class CSRData:
    """Sparse input as raw CSR arrays (the JAX package's ``CSRData``): it
    stays sparse through binning; scipy is not required."""

    def __init__(self, indptr, indices, values, num_col: int) -> None:
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int64)
        self.values = np.asarray(values, dtype=np.float64)
        self.num_col = int(num_col)

    @property
    def shape(self):
        return (len(self.indptr) - 1, self.num_col)


def _as_csr(data) -> Optional[CSRData]:
    """CSRData or a scipy sparse matrix -> CSRData; anything else -> None."""
    if isinstance(data, CSRData):
        return data
    if hasattr(data, "tocsr"):
        m = data.tocsr()
        return CSRData(m.indptr, m.indices, m.data, m.shape[1])
    return None


def _to_matrix(data, feature_name="auto", categorical_feature="auto"):
    """(dense 2-D numpy matrix, feature names or None, categorical
    indices): a DataFrame through :func:`_data_from_pandas`, sparse input
    densified; f32 stays f32 (binning reads it as f64)."""
    if _pandas_type(data, "DataFrame"):
        return _data_from_pandas(data, feature_name, categorical_feature)
    csr = _as_csr(data)
    if csr is not None:
        arr = np.zeros(csr.shape, dtype=np.float64)
        rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
        arr[rows, csr.indices] = csr.values
    else:
        arr = np.asarray(data)
        if arr.dtype not in (np.float32, np.float64):
            arr = arr.astype(np.float64)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    cats = ([] if categorical_feature in ("auto", None)
            else [int(c) for c in categorical_feature])
    names = None if feature_name == "auto" else list(feature_name)
    return arr, names, cats


class Dataset:
    """Dataset for training or validation: a lazily binned numpy matrix,
    DataFrame, sparse matrix or text file."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True) -> None:
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = deepcopy(params) if params else {}
        self.free_raw_data = free_raw_data
        self.handle: Optional[BinnedDataset] = None
        self.used_indices: Optional[np.ndarray] = None

    def construct(self) -> "Dataset":
        """Bin the data (basic.py:712 ``_lazy_init``): with the reference's
        bin mappers when there is one; a subset takes its reference's rows;
        a path goes through ``io.loader.DatasetLoader`` (side files
        included) and the fields given here replace the file's."""
        if self.handle is not None:
            return self
        if self.used_indices is not None:
            ref = self.reference.construct()
            self.handle = ref.handle.subset(self.used_indices)
            if self.label is not None:
                self.handle.metadata.set_label(
                    _list_to_1d_numpy(self.label, np.float64))
            return self
        cfg = Config(alias_transform(dict(self.params)))
        ref = None
        if self.reference is not None:
            ref = self.reference.construct().handle
        label = _list_to_1d_numpy(self.label, np.float64)
        weight = _list_to_1d_numpy(self.weight, np.float64)
        group = _list_to_1d_numpy(self.group, np.int32)
        init_score = _list_to_1d_numpy(self.init_score, np.float64)
        if isinstance(self.data, str):
            self.handle = DatasetLoader(cfg).load_from_file(self.data,
                                                            reference=ref)
            meta = self.handle.metadata
            for value, setter in ((label, meta.set_label),
                                  (weight, meta.set_weights),
                                  (group, meta.set_group),
                                  (init_score, meta.set_init_score)):
                if value is not None:
                    setter(value)
            return self
        chunk_rows = int(cfg.data_chunk_rows or 0)
        common = dict(
            label=label, weight=weight, group=group, init_score=init_score,
            max_bin=int(cfg.max_bin), min_data_in_bin=int(cfg.min_data_in_bin),
            min_data_in_leaf=int(cfg.min_data_in_leaf),
            bin_construct_sample_cnt=int(cfg.bin_construct_sample_cnt),
            use_missing=bool(cfg.use_missing),
            zero_as_missing=bool(cfg.zero_as_missing),
            data_random_seed=int(cfg.data_random_seed),
            enable_bundle=bool(cfg.enable_bundle), reference=ref,
            max_bin_by_feature=(list(cfg.max_bin_by_feature)
                                if cfg.max_bin_by_feature else None))
        csr = _as_csr(self.data)
        if csr is not None and self.categorical_feature in ("auto", None):
            self.handle = BinnedDataset.from_csr(
                csr.indptr, csr.indices, csr.values, csr.num_col,
                feature_names=(None if self.feature_name == "auto"
                               else list(self.feature_name)),
                data_chunk_rows=chunk_rows, **common)
        else:
            mat, names, cats = _to_matrix(self.data, self.feature_name,
                                          self.categorical_feature)
            if chunk_rows > 0 and self.free_raw_data:
                # two-pass chunked construction (from_row_chunks, equal to
                # from_matrix): binning holds one chunk at a time
                self.handle = BinnedDataset.from_row_chunks(
                    lambda: (mat[i:i + chunk_rows]
                             for i in range(0, mat.shape[0], chunk_rows)),
                    categorical_feature=cats, feature_names=names, **common)
            else:
                self.handle = BinnedDataset.from_matrix(
                    mat, categorical_feature=cats, feature_names=names,
                    keep_raw=not self.free_raw_data, **common)
        if self.free_raw_data:
            self.data = None
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       feature_name=self.feature_name,
                       categorical_feature=self.categorical_feature,
                       params=params or self.params)

    def subset(self, used_indices, params=None) -> "Dataset":
        """The rows ``used_indices`` (sorted) of this dataset, binned with
        its mappers (basic.py:259)."""
        ret = Dataset(None, reference=self, feature_name=self.feature_name,
                      categorical_feature=self.categorical_feature,
                      params=params or self.params,
                      free_raw_data=self.free_raw_data)
        ret.used_indices = np.sort(np.asarray(used_indices))
        return ret

    def set_reference(self, reference: "Dataset") -> "Dataset":
        self.reference = reference
        return self

    # ---- fields (basic.py:268-335) ----

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self.handle is not None:
            self.handle.metadata.set_label(_list_to_1d_numpy(label,
                                                             np.float64))
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self.handle is not None and weight is not None:
            self.handle.metadata.set_weights(_list_to_1d_numpy(weight,
                                                               np.float64))
        return self

    def set_group(self, group) -> "Dataset":
        """Per-query sizes (ranking), before or after ``construct``."""
        self.group = group
        if self.handle is not None and group is not None:
            self.handle.metadata.set_group(_list_to_1d_numpy(group, np.int32))
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self.handle is not None and init_score is not None:
            self.handle.metadata.set_init_score(
                _list_to_1d_numpy(init_score, np.float64))
        return self

    def get_label(self):
        if self.handle is not None:
            return np.asarray(self.handle.metadata.label)
        return self.label

    def get_weight(self):
        if self.handle is not None:
            return self.handle.metadata.weights
        return self.weight

    def get_group(self):
        if (self.handle is not None
                and self.handle.metadata.query_boundaries is not None):
            return np.diff(self.handle.metadata.query_boundaries)
        return self.group

    def get_init_score(self):
        if self.handle is not None:
            return self.handle.metadata.init_score
        return self.init_score

    def get_data(self):
        return self.data

    def get_field(self, field_name: str):
        getter = {"label": self.get_label, "weight": self.get_weight,
                  "group": self.get_group, "init_score": self.get_init_score}
        if field_name not in getter:
            raise LightGBMError("Unknown field name %s" % field_name)
        return getter[field_name]()

    def set_field(self, field_name: str, data) -> "Dataset":
        setter = {"label": self.set_label, "weight": self.set_weight,
                  "group": self.set_group, "init_score": self.set_init_score}
        if field_name not in setter:
            raise LightGBMError("Unknown field name %s" % field_name)
        return setter[field_name](data)

    def num_data(self) -> int:
        return self.construct().handle.num_data

    def num_feature(self) -> int:
        return self.construct().handle.num_total_features

    def get_feature_name(self) -> List[str]:
        return list(self.construct().handle.feature_names)

    def save_binary(self, filename: str) -> "Dataset":
        """The binned dataset in the ``LGBMTPU1`` binary format, which a
        path given to ``Dataset`` or the CLI loads back."""
        self.construct().handle.save_binary(filename)
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        if self.handle is not None:
            raise LightGBMError(
                "Cannot set categorical feature after freed raw data")
        self.categorical_feature = categorical_feature
        return self


class Booster:
    """Booster: a host object over the port's GBDT (basic.py:1666)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None,
                 device: DeviceLike = None) -> None:
        self.params = deepcopy(params) if params else {}
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._train_set = train_set
        self._valid_sets: List[Dataset] = []
        self.name_valid_sets: List[str] = []
        self.config = Config(self.params)
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance, "
                                "met " + type(train_set).__name__)
            train_set.construct()
            objective = create_objective(self.config.objective, self.config,
                                         device=device)
            self._booster = create_boosting(self.config.boosting, self.config,
                                            train_set.handle, objective,
                                            device=device)
            self._booster.add_train_metrics(
                create_metrics(self.config.metric, self.config))
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as fh:
                    model_str = fh.read()
            self._booster = GBDT(self.config, device=device)
            self._booster.load_model_from_string(model_str)
        else:
            raise TypeError("Need at least one training dataset or model file "
                            "or model string to create Booster instance")

    @property
    def device(self):
        return self._booster.device

    # ---- training ----

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; True when no further split is possible.
        ``fobj(raw_scores, train_set) -> (grad, hess)`` supplies the
        gradients (class-major [K * N] scores, as the JAX package)."""
        if train_set is not None and train_set is not self._train_set:
            train_set.construct()
            self._train_set = train_set
            self._booster.reset_training_data(train_set.handle,
                                              self._booster.objective)
        if fobj is None:
            return self._booster.watched_iter()
        grad, hess = fobj(self._flat_score("train"), self._train_set)
        return self._booster.watched_iter(np.asarray(grad, dtype=np.float32),
                                          np.asarray(hess, dtype=np.float32))

    def rollback_one_iter(self) -> "Booster":
        self._booster.rollback_one_iter()
        return self

    def current_iteration(self) -> int:
        return self._booster.current_iteration

    def num_model_per_iteration(self) -> int:
        return self._booster.num_tree_per_iteration

    def num_trees(self) -> int:
        return self._booster.num_trees

    def num_feature(self) -> int:
        return self._booster.max_feature_idx + 1

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        self.params.update(params)
        self.config.set(alias_transform(params))
        if "learning_rate" in alias_transform(params):
            self._booster.shrinkage_rate = float(self.config.learning_rate)
        return self

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        if not isinstance(data, Dataset):
            raise TypeError("Validation data should be Dataset instance, met "
                            + type(data).__name__)
        data.construct()
        self._booster.add_valid_data(data.handle, name)
        self._valid_sets.append(data)
        self.name_valid_sets.append(name)
        return self

    # ---- evaluation ----

    def _flat_score(self, which: Union[str, int]) -> np.ndarray:
        """Raw scores of the training set ('train') or the i-th valid set:
        [N], or class-major [K * N]."""
        b = self._booster
        score = (b.get_training_score() if which == "train"
                 else b.valid_sets[which]["score"])
        return score.reshape(-1).double().cpu().numpy()

    def _apply_feval(self, feval, which, data: Dataset, data_name: str):
        if feval is None:
            return []
        ret = feval(self._flat_score(which), data)
        if ret is None:
            return []
        return [(data_name, name, val, hib) for name, val, hib in
                (ret if isinstance(ret, list) else [ret])]

    def eval_train(self, feval=None) -> List:
        return (self._booster.eval_train()
                + self._apply_feval(feval, "train", self._train_set,
                                    "training"))

    def eval_valid(self, feval=None) -> List:
        out = self._booster.eval_valid()
        for i, (vs, name) in enumerate(zip(self._valid_sets,
                                           self.name_valid_sets)):
            out += self._apply_feval(feval, i, vs, name)
        return out

    def eval(self, data: Dataset, name: str, feval=None) -> List:
        """The metrics of ``data``: the training set or a validation set
        added with ``add_valid`` (basic.py:491)."""
        if data is self._train_set:
            return [(name, m, v, h) for (_, m, v, h) in self.eval_train(feval)]
        for i, vs in enumerate(self._valid_sets):
            if data is vs:
                out = [r for r in self._booster.eval_valid()
                       if r[0] == self.name_valid_sets[i]]
                return out + self._apply_feval(feval, i, vs, name)
        raise LightGBMError("Data should be added in Booster.add_valid() "
                            "first")

    # ---- prediction ----

    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                precision: str = "exact", **kwargs) -> np.ndarray:
        """Scores of raw rows ([n], or [n, K] for K classes); with
        ``pred_leaf`` the [n, num_models] leaf indices, with
        ``pred_contrib`` the SHAP contributions (exact only).
        ``precision="bf16"`` is the bf16 tier of the scores."""
        if isinstance(data, Dataset):
            raise TypeError("Cannot use Dataset instance for prediction, "
                            "please use raw data instead")
        mat = _to_matrix(data)[0]
        num_iteration = self._num_iteration(num_iteration)
        if pred_leaf:
            # leaf indices are routing only: no precision tier
            return self._booster.predict_leaf_index(mat, num_iteration)
        if pred_contrib:
            if precision != "exact":
                raise LightGBMError("pred_contrib has no bf16 tier: "
                                    "precision must be 'exact'")
            return self._booster.predict_contrib(
                mat, num_iteration, start_iteration=start_iteration)
        return self._booster.predict(
            mat, raw_score=raw_score, num_iteration=num_iteration,
            start_iteration=start_iteration, precision=precision)

    def predict_binned(self, data: Dataset, start_iteration: int = 0,
                       num_iteration: Optional[int] = None,
                       raw_score: bool = False,
                       pred_leaf: bool = False) -> np.ndarray:
        """Predict from a constructed ``Dataset``'s binned row store (the
        training set, or one made with ``reference=`` it), routed by
        integer compares (basic.py:534-553)."""
        if not isinstance(data, Dataset):
            raise TypeError("predict_binned wants a Dataset instance; use "
                            "predict() for raw feature matrices")
        data.construct()
        num_iteration = self._num_iteration(num_iteration)
        if pred_leaf:
            return self._booster.predict_leaf_index_binned(data.handle,
                                                           num_iteration)
        return self._booster.predict_binned(data.handle, raw_score=raw_score,
                                            num_iteration=num_iteration,
                                            start_iteration=start_iteration)

    # ---- model IO ----

    def _num_iteration(self, num_iteration: Optional[int]) -> int:
        if num_iteration is None:
            return self.best_iteration if self.best_iteration > 0 else -1
        return num_iteration

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        self._booster.save_model(filename, start_iteration,
                                 self._num_iteration(num_iteration))
        return self

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        return self._booster.save_model_to_string(
            start_iteration, self._num_iteration(num_iteration))

    def model_from_string(self, model_str: str) -> "Booster":
        self._booster = GBDT(self.config, device=self._booster.device)
        self._booster.load_model_from_string(model_str)
        return self

    def save_checkpoint(self, checkpoint_prefix: str) -> "Booster":
        """Write the full train state atomically to
        ``<prefix>.ckpt_iter_<n>`` (``checkpoint.py``)."""
        self._booster.save_checkpoint(checkpoint_prefix)
        return self

    def resume_from_checkpoint(self, checkpoint_prefix: str) -> int:
        """Restore the newest valid checkpoint of ``checkpoint_prefix`` into
        this booster, which has the checkpointed run's training data and
        validation sets attached; the restored iteration, 0 when there is
        none."""
        return self._booster.resume_from_checkpoint(checkpoint_prefix)

    # ---- serving (serving/) and telemetry (obs/), basic.py:589-630 ----

    def serve(self, name: str = "model", **server_kwargs):
        """Start a serving tier with this booster resident as ``name``, on
        the booster's device unless ``device=`` says otherwise.  The
        returned :class:`~lightgbm_tpu_torch.serving.Server` coalesces
        requests (``submit``/``predict``), takes per-request
        ``num_iteration``/``pred_early_stop`` and binned rows, holds more
        models (``register``) and hot-swaps (``swap``).  The knobs come
        from this booster's params (``max_batch_wait_us``,
        ``serve_residency_budget_mb``, ``serve_single_row_fast``);
        ``server_kwargs`` override them."""
        from .serving import Server
        server_kwargs.setdefault("device", self.device)
        server = Server(config=self.config, **server_kwargs)
        try:
            server.register(name, self._booster)
        except BaseException:
            server.close(drain=False)  # don't leak the dispatcher thread
            raise
        return server

    def telemetry_summary(self) -> Optional[Dict]:
        """Summary dict of the process-active telemetry run (counters,
        gauges, histograms with p50/p99, misses per bucket, split passes
        per growth mode, host-phase timings), or None when telemetry is
        off.  A run ``train`` opened for ``telemetry_out`` is finalized and
        closed when training ends; ``obs.configure`` opens one this method
        can read mid-flight."""
        from . import obs
        tele = obs.active()
        if tele is None:
            return None
        from .obs.report import summarize
        return summarize(tele)

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> Dict:
        """The model as a dict in the reference's JSON layout
        (gbdt_model_text.cpp:20, basic.py:627)."""
        b = self._booster
        num_iteration = self._num_iteration(num_iteration)
        K = b.num_tree_per_iteration
        total_iter = len(b.models) // max(K, 1)
        end_iter = total_iter if num_iteration <= 0 else min(
            total_iter, start_iteration + num_iteration)
        trees = [{"tree_index": i, **b.models[i].to_json()}
                 for i in range(start_iteration * K, end_iter * K)]
        return {
            "name": b.sub_model_name(),
            "version": "v3",
            "num_class": b.num_class,
            "num_tree_per_iteration": K,
            "label_index": b.label_idx,
            "max_feature_idx": b.max_feature_idx,
            "objective": b.objective.to_string() if b.objective else "none",
            "average_output": b.average_output,
            "feature_names": list(b.feature_names),
            "feature_importances": {
                name: int(v) for name, v in zip(
                    b.feature_names, b.feature_importance("split"))
                if v > 0},
            "tree_info": trees,
        }

    def get_split_value_histogram(self, feature, bins=None,
                                  xgboost_style: bool = False):
        """Histogram of the thresholds the trees use for ``feature`` (an
        index, or a name); categorical splits are refused (basic.py:658).
        ``xgboost_style`` gives the [value, count] rows of the nonempty
        bins as a numpy array."""
        model = self.dump_model()
        feature_names = model.get("feature_names")
        values: List[float] = []

        def walk(node):
            if "split_index" not in node:
                return
            f = node["split_feature"]
            name = (feature_names[f] if feature_names is not None
                    and isinstance(feature, str) else f)
            if name == feature:
                if node.get("decision_type") == "==":
                    raise LightGBMError("Cannot compute split value histogram "
                                        "for the categorical feature")
                values.append(float(node["threshold"]))
            walk(node["left_child"])
            walk(node["right_child"])

        for info in model["tree_info"]:
            walk(info["tree_structure"])
        if bins is None or (isinstance(bins, int) and xgboost_style):
            n_unique = len(np.unique(values))
            bins = max(min(n_unique, bins) if bins is not None else n_unique,
                       1)
        hist, bin_edges = np.histogram(values, bins=bins)
        if xgboost_style:
            ret = np.column_stack((bin_edges[1:], hist))
            return ret[ret[:, 1] > 0]
        return hist, bin_edges

    # ---- introspection ----

    def feature_name(self) -> List[str]:
        return list(self._booster.feature_names)

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        imp = self._booster.feature_importance(
            importance_type, -1 if iteration is None else iteration)
        return imp.astype(np.int32) if importance_type == "split" else imp

    # ---- pickling (basic.py:707-724) ----

    def __getstate__(self):
        """The model text, params and best iteration/score; the training
        and validation sets are dropped.  The device type is kept: a CUDA
        booster unpickles onto CUDA (and raises without it), a CPU booster
        onto the CPU."""
        return {"params": self.params,
                "model_str": self._booster.save_model_to_string(),
                "best_iteration": self.best_iteration,
                "best_score": self.best_score,
                "device": self.device.type}

    def __setstate__(self, state):
        self.params = state["params"]
        self.best_iteration = state["best_iteration"]
        self.best_score = state["best_score"]
        self._train_set = None
        self._valid_sets = []
        self.name_valid_sets = []
        self.config = Config(self.params)
        self._booster = GBDT(self.config, device=state["device"])
        self._booster.load_model_from_string(state["model_str"])
