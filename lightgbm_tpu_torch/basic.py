"""Public ``Dataset`` and ``Booster``: the numpy subset of
``lightgbm_tpu/basic.py`` (python-package/lightgbm/basic.py), for the PyTorch
port (which imports nothing of the JAX package).

A :class:`Dataset` is binned on the host (lazily, at ``construct``); a
validation set made with ``reference=`` (or ``create_valid``) is binned with
the training set's bin mappers.  A :class:`Booster` trains on the device its
``device=`` names, ``cuda`` unless the caller passes ``"cpu"``.

``Booster.update(fobj=...)`` trains on a custom objective's gradients.  The
booster is built by ``boosting.create_boosting``: ``boosting=gbdt``,
``dart``, ``goss`` or ``rf`` (aliases resolved by the config).  Sparse input
(a scipy sparse matrix or :class:`CSRData`) is binned straight from CSR
without densifying (``BinnedDataset.from_csr``, whose EFB bundles the sparse
features) unless ``categorical_feature`` is given, which the sparse binner
does not take: then it is densified, as in the JAX package (basic.py:85-112,
:227-250).  Not carried over yet, and refused with ``NotImplementedError``:
pandas input (ROADMAP queue 1 item 1), leaf-index and contribution
prediction (queue 1 items 6 and 12).  Telemetry, serving and checkpoints are
TPU-era planes with no counterpart here (queue 1 items 11 and 15).
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Union

import numpy as np

from .boosting import create_boosting
from .boosting.gbdt import GBDT
from .config import Config, alias_transform
from .device import DeviceLike
from .io.dataset import BinnedDataset
from .metric.metric import create_metrics
from .objective import create_objective
from .utils.log import LightGBMError

__all__ = ["Dataset", "Booster", "CSRData", "LightGBMError"]


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError("%s is not ported to lightgbm_tpu_torch yet "
                              "(ROADMAP %s)" % (what, item))


def _list_to_1d_numpy(data, dtype):
    if data is None:
        return None
    return np.asarray(data, dtype=dtype).reshape(-1)


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


def _check_input(data) -> None:
    """Refuse the inputs the port cannot bin yet."""
    if type(data).__module__.split(".")[0] == "pandas":
        _refuse("pandas input", "queue 1 item 1")


def _to_matrix(data) -> np.ndarray:
    """A dense 2-D numpy matrix (f32 stays f32; binning reads it as f64);
    sparse input is densified."""
    _check_input(data)
    csr = _as_csr(data)
    if csr is not None:
        arr = np.zeros(csr.shape, dtype=np.float64)
        rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
        arr[rows, csr.indices] = csr.values
        return arr
    arr = np.asarray(data)
    if arr.dtype not in (np.float32, np.float64):
        arr = arr.astype(np.float64)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    return arr


class Dataset:
    """Dataset for training or validation: a lazily binned numpy matrix."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True) -> None:
        _check_input(data)
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

    def construct(self) -> "Dataset":
        """Bin the matrix (basic.py:712 ``_lazy_init``): with the reference's
        bin mappers when there is one."""
        if self.handle is not None:
            return self
        cfg = Config(alias_transform(dict(self.params)))
        ref = None
        if self.reference is not None:
            ref = self.reference.construct().handle
        cats = ([] if self.categorical_feature in ("auto", None)
                else [int(c) for c in self.categorical_feature])
        common = dict(
            label=_list_to_1d_numpy(self.label, np.float64),
            weight=_list_to_1d_numpy(self.weight, np.float64),
            group=_list_to_1d_numpy(self.group, np.int32),
            init_score=_list_to_1d_numpy(self.init_score, np.float64),
            max_bin=int(cfg.max_bin), min_data_in_bin=int(cfg.min_data_in_bin),
            min_data_in_leaf=int(cfg.min_data_in_leaf),
            bin_construct_sample_cnt=int(cfg.bin_construct_sample_cnt),
            use_missing=bool(cfg.use_missing),
            zero_as_missing=bool(cfg.zero_as_missing),
            data_random_seed=int(cfg.data_random_seed),
            enable_bundle=bool(cfg.enable_bundle),
            feature_names=(None if self.feature_name == "auto"
                           else list(self.feature_name)),
            reference=ref,
            max_bin_by_feature=(list(cfg.max_bin_by_feature)
                                if cfg.max_bin_by_feature else None))
        csr = _as_csr(self.data)
        if csr is not None and self.categorical_feature in ("auto", None):
            self.handle = BinnedDataset.from_csr(
                csr.indptr, csr.indices, csr.values, csr.num_col, **common)
        else:
            self.handle = BinnedDataset.from_matrix(
                _to_matrix(self.data), categorical_feature=cats,
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

    def set_reference(self, reference: "Dataset") -> "Dataset":
        self.reference = reference
        return self

    def set_group(self, group) -> "Dataset":
        """Per-query sizes (ranking), before or after ``construct``."""
        self.group = group
        if self.handle is not None and group is not None:
            self.handle.metadata.set_group(_list_to_1d_numpy(group, np.int32))
        return self

    def get_group(self):
        if (self.handle is not None
                and self.handle.metadata.query_boundaries is not None):
            return np.diff(self.handle.metadata.query_boundaries)
        return self.group

    def get_label(self):
        if self.handle is not None:
            return np.asarray(self.handle.metadata.label)
        return self.label

    def num_data(self) -> int:
        return self.construct().handle.num_data

    def num_feature(self) -> int:
        return self.construct().handle.num_total_features

    def get_feature_name(self) -> List[str]:
        return list(self.construct().handle.feature_names)


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
            return self._booster.train_one_iter()
        grad, hess = fobj(self._flat_score("train"), self._train_set)
        return self._booster.train_one_iter(np.asarray(grad, dtype=np.float32),
                                            np.asarray(hess, dtype=np.float32))

    def current_iteration(self) -> int:
        return self._booster.current_iteration

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
        score = (b.train_score if which == "train"
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

    # ---- prediction ----

    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                **kwargs) -> np.ndarray:
        if isinstance(data, Dataset):
            raise TypeError("Cannot use Dataset instance for prediction, "
                            "please use raw data instead")
        if pred_leaf or pred_contrib:
            _refuse("pred_leaf / pred_contrib", "queue 1 items 6 and 12")
        return self._booster.predict(
            _to_matrix(data), raw_score=raw_score,
            num_iteration=self._num_iteration(num_iteration),
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

    # ---- introspection ----

    def feature_name(self) -> List[str]:
        return list(self._booster.feature_names)

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        imp = self._booster.feature_importance(
            importance_type, -1 if iteration is None else iteration)
        return imp.astype(np.int32) if importance_type == "split" else imp
