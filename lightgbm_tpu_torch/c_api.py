"""The C ABI: the 74 ``LGBM_*`` entry points over the PyTorch port.

Counterpart of ``lightgbm_tpu/c_api.py`` (the reference's
``src/c_api.cpp:465-1620`` and ``include/LightGBM/c_api.h``) for the port,
which imports nothing of the JAX package.  ``capi_build.py`` compiles a C
library, ``lib_lightgbm_tpu_torch.so``, whose every ``LGBM_*`` symbol takes
the interpreter lock, imports this module once, and calls the function of
the same name in the table :func:`bind` returns, with every pointer passed
as an integer address and every ``int``/``int64_t``/``double`` as a Python
number.  So ctypes, SWIG or R callers load it as they load the reference's
``lib_lightgbm.so``.

Two layers, as in the JAX package:

- ``_impl_*`` functions and the handle payloads ``_CDataset`` and
  ``_CBooster``: plain Python arguments (numpy arrays, str, int handles).
- :func:`bind`: the marshalling wrappers, which read and write the caller's
  memory through ``ctypes`` and numpy views of the raw addresses, write the
  out-parameters, and turn an exception into -1 with its text kept for
  ``LGBM_GetLastError`` (c_api.h:29-40).

Every buffer handed back to C is host memory that stays alive in its
handle: ``LGBM_DatasetGetField``'s arrays in ``_CDataset.field_buffers``,
``LGBM_BoosterGetPredict``'s scores in ``_CBooster.predict_buffer``.  The
port's scores live on the device and are copied to numpy first.

The device of a C caller: the ABI has no device argument, so one
environment variable, ``LIGHTGBM_TPU_TORCH_DEVICE``, read once when this
module is imported, names it: unset or ``cuda`` means CUDA (and, without
CUDA, every entry that creates a dataset or booster fails with "CUDA is not
available; set LIGHTGBM_TPU_TORCH_DEVICE=cpu"); ``cpu`` means the CPU; any
other value is an error.  Nothing runs on the CPU unless asked.

``LGBM_TelemetryConfigure|Disable|Summary|RecompileCount`` drive the
port's telemetry plane (``obs``, c_api.py:295-330 of the JAX package): the
summary is the JSON of ``obs.report.summarize`` ("" with telemetry off)
and the count is ``obs.recompile.total()``, the port's misses.

Where the port differs from the JAX package:
``LGBM_PredictFallbackCount`` reads 0, since the port has no degraded path;
``LGBM_DatasetCreateFromCSRFunc`` takes a plain C callback (the
reference's ``std::function`` cannot be called from C):
``int get_row(int idx, int32_t* indices, double* values)`` writes row
``idx``'s nonzeros (at most ``num_col``) into the two buffers and returns
their count; and the three ``LGBM_Network*`` entries are no-ops, as in
the JAX package (c_api.py:940-955): the parallel learners run over a
``torch.distributed`` process group that the caller initializes, with
``tree_learner`` naming the learner.
"""
from __future__ import annotations

import ctypes
import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .basic import Booster, CSRData, Dataset, LightGBMError
from .config import alias_transform
from .device import resolve_device
from .utils.log import Log

# C_API_DTYPE_* (c_api.h:17-20)
DTYPE_FLOAT32 = 0
DTYPE_FLOAT64 = 1
DTYPE_INT32 = 2
DTYPE_INT64 = 3

# C_API_PREDICT_* (c_api.h:22-25)
PREDICT_NORMAL = 0
PREDICT_RAW_SCORE = 1
PREDICT_LEAF_INDEX = 2
PREDICT_CONTRIB = 3

_NP_DTYPE = {DTYPE_FLOAT32: np.float32, DTYPE_FLOAT64: np.float64,
             DTYPE_INT32: np.int32, DTYPE_INT64: np.int64}

DEVICE_ENV = "LIGHTGBM_TPU_TORCH_DEVICE"


def _device_setting(value: Optional[str]) -> str:
    """``cuda`` or ``cpu`` from the value of :data:`DEVICE_ENV`."""
    if value is None or value == "" or value == "cuda":
        return "cuda"
    if value == "cpu":
        return "cpu"
    raise ValueError("%s must be 'cuda' or 'cpu', got %r"
                     % (DEVICE_ENV, value))


_DEVICE_SETTING = _device_setting(os.environ.get(DEVICE_ENV))


def _device() -> torch.device:
    """The device of every dataset and booster made through the C ABI."""
    if _DEVICE_SETTING == "cpu":
        return torch.device("cpu")
    try:
        return resolve_device(None)
    except RuntimeError:
        raise LightGBMError("CUDA is not available; set %s=cpu"
                            % DEVICE_ENV) from None


_state = threading.local()


def _set_last_error(msg: str) -> None:
    _state.err = str(msg)


def get_last_error() -> str:
    return getattr(_state, "err", "Everything is fine")


class _CDataset:
    """Handle payload: a ``Dataset``, its streaming-push state, and the
    field buffers ``LGBM_DatasetGetField`` hands out (kept alive here)."""

    def __init__(self, ds: Dataset, num_total_row: Optional[int] = None,
                 ncol: Optional[int] = None) -> None:
        self.ds = ds
        self.field_buffers: Dict[str, np.ndarray] = {}
        # streaming construction (LGBM_DatasetPushRows*)
        self.pending: Optional[np.ndarray] = None
        self.pushed = 0
        if num_total_row is not None:
            self.pending = np.zeros((num_total_row, ncol), dtype=np.float64)

    def push(self, rows: np.ndarray, start_row: int) -> None:
        if self.pending is None:
            raise LightGBMError("Dataset not created for streaming push")
        self.pending[start_row:start_row + rows.shape[0]] = rows
        self.pushed += rows.shape[0]
        if self.pushed >= self.pending.shape[0]:
            self.ds.data = self.pending
            self.pending = None
            self.ds.construct()


class _CBooster:
    """Handle payload: a ``Booster``, its datasets, and the buffers
    ``LGBM_BoosterGetPredict`` hands out."""

    def __init__(self, booster: Booster) -> None:
        self.booster = booster
        self.train_ds: Optional[_CDataset] = None
        self.valid_ds: List[_CDataset] = []
        self.predict_buffer: Dict[int, np.ndarray] = {}


_handles: Dict[int, Any] = {}
_next_handle = [1]
_lock = threading.Lock()


def _new_handle(obj) -> int:
    with _lock:
        h = _next_handle[0]
        _next_handle[0] += 1
        _handles[h] = obj
    return h


def _get(h: int):
    try:
        return _handles[int(h)]
    except (KeyError, TypeError, ValueError):
        raise LightGBMError("Invalid handle %r" % (h,)) from None


def _free_handle(h: int) -> None:
    _handles.pop(int(h), None)


def _parse_params(parameters: str) -> Dict[str, str]:
    """'k1=v1 k2=v2' -> dict (config.cpp Str2Map: space-separated pairs)."""
    out: Dict[str, str] = {}
    for tok in str(parameters or "").split():
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def _host(a) -> np.ndarray:
    """``a`` as a numpy array in host memory."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# --------------------------------------------------------------------------
# dataset impls
# --------------------------------------------------------------------------

def _impl_dataset_create_from_file(filename: str, parameters: str,
                                   ref: Optional[int]) -> int:
    from .config import Config
    from .io.loader import DatasetLoader
    _device()
    params = _parse_params(parameters)
    cfg = Config(alias_transform(dict(params)))
    ref_ds = _get(ref).ds.construct().handle if ref else None
    binned = DatasetLoader(cfg).load_from_file(filename, reference=ref_ds)
    ds = Dataset(None, params=params)
    ds.handle = binned
    return _new_handle(_CDataset(ds))


def _impl_dataset_create_from_mat(mat: np.ndarray, parameters: str,
                                  ref: Optional[int]) -> int:
    _device()
    params = _parse_params(parameters)
    ref_ds = _get(ref).ds if ref else None
    ds = Dataset(mat, params=params, reference=ref_ds)
    ds.construct()
    return _new_handle(_CDataset(ds))


def _impl_dataset_create_sampled(ncol: int, num_total_row: int,
                                 parameters: str) -> int:
    # the pushed rows are binned whole, so the sample itself is not read
    _device()
    ds = Dataset(None, params=_parse_params(parameters))
    return _new_handle(_CDataset(ds, num_total_row=num_total_row, ncol=ncol))


def _impl_dataset_create_by_reference(ref: int, num_total_row: int) -> int:
    _device()
    ref_c = _get(ref)
    ds = Dataset(None, params=dict(ref_c.ds.params), reference=ref_c.ds)
    return _new_handle(_CDataset(ds, num_total_row=num_total_row,
                                 ncol=ref_c.ds.num_feature()))


def _csr_to_dense(indptr, indices, data, num_col) -> np.ndarray:
    indptr = np.asarray(indptr, dtype=np.int64)
    nrow = len(indptr) - 1
    mat = np.zeros((nrow, int(num_col)), dtype=np.float64)
    lo, hi = int(indptr[0]), int(indptr[-1])
    mat[np.repeat(np.arange(nrow), np.diff(indptr)),
        indices[lo:hi]] = data[lo:hi]
    return mat


def _csc_to_csr(col_ptr, indices, data, num_row):
    """CSC arrays -> CSR arrays in O(nnz)."""
    col_of = np.repeat(np.arange(len(col_ptr) - 1, dtype=np.int64),
                       np.diff(np.asarray(col_ptr, dtype=np.int64)))
    rows = np.asarray(indices, dtype=np.int64)
    order = np.argsort(rows, kind="stable")
    indptr = np.searchsorted(rows[order], np.arange(num_row + 1))
    return indptr, col_of[order], np.asarray(data, dtype=np.float64)[order]


def _csc_to_dense(col_ptr, indices, data, num_row) -> np.ndarray:
    return np.ascontiguousarray(
        _csr_to_dense(col_ptr, indices, data, num_row).T)


def _impl_dataset_create_from_csr(indptr, indices, values, num_col: int,
                                  parameters: str, ref: Optional[int]) -> int:
    _device()
    params = _parse_params(parameters)
    ref_ds = _get(ref).ds if ref else None
    ds = Dataset(CSRData(indptr, indices, values, num_col), params=params,
                 reference=ref_ds)
    ds.construct()
    return _new_handle(_CDataset(ds))


# --------------------------------------------------------------------------
# booster impls
# --------------------------------------------------------------------------

def _impl_booster_create(train: int, parameters: str) -> int:
    device = _device()
    params = _parse_params(parameters)
    c_train = _get(train)
    booster = Booster(params=alias_transform(dict(params)),
                      train_set=c_train.ds, device=device)
    cb = _CBooster(booster)
    cb.train_ds = c_train
    return _new_handle(cb)


def _impl_booster_load(model_file: Optional[str] = None,
                       model_str: Optional[str] = None):
    """(handle, iterations) of a booster loaded from a file or a string."""
    booster = Booster(model_file=model_file, model_str=model_str,
                      device=_device())
    return _new_handle(_CBooster(booster)), booster.current_iteration()


def _eval_names(cb: _CBooster) -> List[str]:
    return [n for m in cb.booster._booster.train_metrics for n in m.names]


_PRED_EARLY_STOP_KEYS = ("pred_early_stop", "pred_early_stop_freq",
                         "pred_early_stop_margin")


def _predict_matrix(cb: _CBooster, mat: np.ndarray, predict_type: int,
                    num_iteration: int, parameter: str) -> np.ndarray:
    """Predictions of ``mat`` as a flat f64 array, row-major (c_api.py
    :225-283 of the JAX package): ``start_iteration``, the
    ``pred_early_stop*`` keys (for this call only) and
    ``predict_precision=bf16`` (scores only) from ``parameter``."""
    params = alias_transform(_parse_params(parameter))
    kwargs = {}
    if "start_iteration" in params:
        kwargs["start_iteration"] = int(params.pop("start_iteration"))
    early_stop = {k: params.pop(k) for k in _PRED_EARLY_STOP_KEYS
                  if k in params}
    precision = str(params.pop("predict_precision", "exact"))
    if precision not in ("exact", "bf16"):
        raise LightGBMError("predict_precision must be 'exact' or 'bf16', "
                            "got %r" % (precision,))
    ignored = {k: v for k, v in params.items()
               if k not in ("verbosity", "predict_raw_score",
                            "predict_leaf_index", "predict_contrib")}
    if ignored:
        Log.warning("Ignoring unsupported prediction parameters: %s",
                    ",".join(sorted(ignored)))
    if num_iteration < 0:
        num_iteration = None
    cfg = cb.booster._booster.config
    saved = {k: getattr(cfg, k) for k in early_stop}
    if early_stop:
        cfg.set(early_stop)
    try:
        if predict_type == PREDICT_LEAF_INDEX:
            kwargs.pop("start_iteration", None)
            out = cb.booster.predict(mat, num_iteration=num_iteration,
                                     pred_leaf=True, **kwargs)
        elif predict_type == PREDICT_CONTRIB:
            if precision != "exact":
                raise LightGBMError("pred_contrib has no bf16 tier: "
                                    "predict_precision must be exact")
            out = cb.booster.predict(mat, num_iteration=num_iteration,
                                     pred_contrib=True, **kwargs)
        elif predict_type == PREDICT_RAW_SCORE:
            out = cb.booster.predict(mat, num_iteration=num_iteration,
                                     raw_score=True, precision=precision,
                                     **kwargs)
        else:
            out = cb.booster.predict(mat, num_iteration=num_iteration,
                                     precision=precision, **kwargs)
    finally:
        if early_stop:
            cfg.set({k: (str(v).lower() if isinstance(v, bool) else str(v))
                     for k, v in saved.items()})
    return np.ascontiguousarray(_host(out), dtype=np.float64)


def _num_predict_per_row(cb: _CBooster, predict_type: int,
                         num_iteration: int) -> int:
    b = cb.booster._booster
    n_iter = b.current_iteration
    if num_iteration > 0:
        n_iter = min(n_iter, num_iteration)
    if predict_type == PREDICT_LEAF_INDEX:
        return n_iter * b.num_tree_per_iteration
    if predict_type == PREDICT_CONTRIB:
        return (b.max_feature_idx + 2) * b.num_tree_per_iteration
    nc = max(int(b.num_class), 1)
    return nc if nc > 1 else 1


def _impl_predict_for_file(cb: _CBooster, data_filename: str,
                           data_has_header: int, predict_type: int,
                           num_iteration: int, parameter: str,
                           result_filename: str) -> None:
    from .io.parser import parse_file
    mat, _, _ = parse_file(data_filename, header=bool(data_has_header),
                           label_idx=0)
    out = _predict_matrix(cb, mat, predict_type, num_iteration, parameter)
    out2d = out.reshape(mat.shape[0], -1)
    with open(result_filename, "w") as fh:
        for row in out2d:
            fh.write("\t".join(repr(float(v)) for v in row) + "\n")


def _impl_telemetry_configure(out_path: str, freq: int) -> None:
    """Start (or restart) the process-active telemetry run; an empty
    ``out_path`` keeps the events in memory."""
    from . import obs
    obs.configure(out=out_path or None, freq=int(freq) or 1, entry="c_api")


def _impl_telemetry_disable() -> None:
    from . import obs
    obs.disable()


def _impl_telemetry_summary() -> str:
    """Summary JSON of the active telemetry run ("" when telemetry is
    off)."""
    from . import obs
    tele = obs.active()
    if tele is None:
        return ""
    from .obs.report import summarize
    return json.dumps(summarize(tele), default=str)


def _impl_telemetry_recompile_count() -> int:
    """The port's misses (``obs.recompile``: predictors stacked for a new
    key, the kernel build), always on."""
    from .obs import recompile
    return int(recompile.total())


def _impl_preemption_install() -> None:
    """Arm the SIGTERM/SIGINT preemption flag (``resilience.py``) for a
    host that trains through the C ABI; it polls
    ``LGBM_PreemptionRequested``."""
    from .resilience import install_preemption_handler
    install_preemption_handler()


def _impl_preemption_requested() -> int:
    from .resilience import preemption_requested
    return 1 if preemption_requested() else 0


def _impl_predict_fallback_count() -> int:
    """Degraded-path activations (``resilience.note_fallback``): 0 in the
    port, which has no degraded path."""
    from .resilience import fallback_counts
    return int(sum(fallback_counts().values()))


# --------------------------------------------------------------------------
# raw-address marshalling
# --------------------------------------------------------------------------

def _str(ptr: int) -> str:
    return ctypes.string_at(ptr).decode("utf-8") if ptr else ""


def _opt_handle(h: int) -> Optional[int]:
    return int(h) if h else None


def _nparr(ptr: int, n: int, dtype) -> np.ndarray:
    """A copy of ``n`` elements of ``dtype`` at address ``ptr``."""
    n = int(n)
    if n <= 0:
        return np.zeros(0, dtype=dtype)
    if not ptr:
        raise LightGBMError("NULL pointer for %d elements" % n)
    nbytes = n * np.dtype(dtype).itemsize
    buf = (ctypes.c_char * nbytes).from_address(ptr)
    return np.frombuffer(buf, dtype=dtype).copy()


def _typed(ptr: int, n: int, c_dtype: int) -> np.ndarray:
    if int(c_dtype) not in _NP_DTYPE:
        raise LightGBMError("Unknown data type %d" % int(c_dtype))
    return _nparr(ptr, n, _NP_DTYPE[int(c_dtype)])


def _write_out(ptr: int, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr)
    if arr.nbytes:
        ctypes.memmove(ptr, arr.ctypes.data, arr.nbytes)


def _put(ptr: int, ctype, value) -> None:
    """``*ptr = value`` for an out-parameter of C type ``ctype``."""
    ctype.from_address(ptr).value = value


def _mat_from_ptr(data: int, data_type: int, nrow: int, ncol: int,
                  is_row_major: int) -> np.ndarray:
    flat = _typed(data, int(nrow) * int(ncol), data_type)
    if is_row_major:
        return flat.reshape(int(nrow), int(ncol)).astype(np.float64,
                                                         copy=False)
    return flat.reshape(int(ncol), int(nrow)).T.astype(np.float64,
                                                       copy=False)


def _pointers(ptr: int, n: int) -> List[int]:
    """The ``n`` addresses of a C array of pointers."""
    return [int(p) for p in _nparr(ptr, n, np.uintp)]


def _copy_names(names: List[str], out_len: int, out_strs: int) -> None:
    """Reference semantics (c_api.cpp GetEvalNames/GetFeatureNames): the
    caller allocates each name's buffer and the library copies the
    NUL-terminated name into it, at most 128 bytes (this ABI version
    carries no buffer length; a UTF-8 sequence is never cut)."""
    _put(out_len, ctypes.c_int, len(names))
    if not out_strs:
        return
    for dst, n in zip(_pointers(out_strs, len(names)), names):
        raw = n.encode("utf-8")[:127]
        while raw and (raw[-1] & 0xC0) == 0x80:
            raw = raw[:-1]
        raw += b"\0"
        ctypes.memmove(dst, raw, len(raw))


def _text_to_buffer(text: str, buffer_len: int, out_len: int,
                    out_str: int) -> None:
    """Size-then-fill strings: ``*out_len`` is the size with the NUL; the
    text is copied only when ``buffer_len`` holds it."""
    data = text.encode("utf-8") + b"\0"
    _put(out_len, ctypes.c_int64, len(data))
    if int(buffer_len) >= len(data) and out_str:
        ctypes.memmove(out_str, data, len(data))


_I = ctypes.c_int
_I64 = ctypes.c_int64
_P = ctypes.c_void_p

# C_API row-callback of LGBM_DatasetCreateFromCSRFunc (see the docstring)
_GET_ROW = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_int32),
                            ctypes.POINTER(ctypes.c_double))


def _entries() -> Dict[str, Callable]:  # noqa: C901 - one table
    """The ``LGBM_*`` functions over raw addresses, unwrapped."""
    E: Dict[str, Callable] = {}

    def entry(fn):
        E[fn.__name__] = fn
        return fn

    # ---- dataset creation ----

    @entry
    def LGBM_DatasetCreateFromFile(filename, parameters, reference, out):
        h = _impl_dataset_create_from_file(_str(filename), _str(parameters),
                                           _opt_handle(reference))
        _put(out, _P, h)

    @entry
    def LGBM_DatasetCreateFromSampledColumn(sample_data, sample_indices, ncol,
                                            num_per_col, num_sample_row,
                                            num_total_row, parameters, out):
        _put(out, _P, _impl_dataset_create_sampled(
            int(ncol), int(num_total_row), _str(parameters)))

    @entry
    def LGBM_DatasetCreateByReference(reference, num_total_row, out):
        _put(out, _P, _impl_dataset_create_by_reference(
            _opt_handle(reference), int(num_total_row)))

    @entry
    def LGBM_DatasetPushRows(dataset, data, data_type, nrow, ncol, start_row):
        rows = _mat_from_ptr(data, data_type, nrow, ncol, 1)
        _get(dataset).push(rows, int(start_row))

    @entry
    def LGBM_DatasetPushRowsByCSR(dataset, indptr, indptr_type, indices, data,
                                  data_type, nindptr, nelem, num_col,
                                  start_row):
        ip = _typed(indptr, nindptr, indptr_type)
        idx = _nparr(indices, nelem, np.int32)
        vals = _typed(data, nelem, data_type)
        _get(dataset).push(_csr_to_dense(ip, idx, vals, num_col),
                           int(start_row))

    @entry
    def LGBM_DatasetCreateFromCSR(indptr, indptr_type, indices, data,
                                  data_type, nindptr, nelem, num_col,
                                  parameters, reference, out):
        ip = _typed(indptr, nindptr, indptr_type)
        idx = _nparr(indices, nelem, np.int32)
        vals = _typed(data, nelem, data_type)
        _put(out, _P, _impl_dataset_create_from_csr(
            ip, idx, vals, int(num_col), _str(parameters),
            _opt_handle(reference)))

    @entry
    def LGBM_DatasetCreateFromCSRFunc(get_row_funptr, num_rows, num_col,
                                      parameters, reference, out):
        if not get_row_funptr:
            raise LightGBMError("get_row_funptr is NULL")
        get_row = _GET_ROW(get_row_funptr)
        ncol = int(num_col)
        idx_buf = (ctypes.c_int32 * max(ncol, 1))()
        val_buf = (ctypes.c_double * max(ncol, 1))()
        indptr, indices, values = [0], [], []
        for i in range(int(num_rows)):
            nnz = int(get_row(i, idx_buf, val_buf))
            if not 0 <= nnz <= ncol:
                raise LightGBMError("get_row(%d) returned %d nonzeros for "
                                    "%d columns" % (i, nnz, ncol))
            indices.extend(idx_buf[:nnz])
            values.extend(val_buf[:nnz])
            indptr.append(len(indices))
        _put(out, _P, _impl_dataset_create_from_csr(
            np.asarray(indptr, np.int64), np.asarray(indices, np.int32),
            np.asarray(values, np.float64), ncol, _str(parameters),
            _opt_handle(reference)))

    @entry
    def LGBM_DatasetCreateFromCSC(col_ptr, col_ptr_type, indices, data,
                                  data_type, ncol_ptr, nelem, num_row,
                                  parameters, reference, out):
        cp = _typed(col_ptr, ncol_ptr, col_ptr_type)
        idx = _nparr(indices, nelem, np.int32)
        vals = _typed(data, nelem, data_type)
        ip, ridx, rvals = _csc_to_csr(cp, idx, vals, int(num_row))
        _put(out, _P, _impl_dataset_create_from_csr(
            ip, ridx, rvals, len(cp) - 1, _str(parameters),
            _opt_handle(reference)))

    @entry
    def LGBM_DatasetCreateFromMat(data, data_type, nrow, ncol, is_row_major,
                                  parameters, reference, out):
        mat = _mat_from_ptr(data, data_type, nrow, ncol, int(is_row_major))
        _put(out, _P, _impl_dataset_create_from_mat(
            mat, _str(parameters), _opt_handle(reference)))

    @entry
    def LGBM_DatasetCreateFromMats(nmat, data, data_type, nrow, ncol,
                                   is_row_major, parameters, reference, out):
        ptrs = _pointers(data, nmat)
        rows = _nparr(nrow, nmat, np.int32)
        mats = [_mat_from_ptr(p, data_type, r, ncol, int(is_row_major))
                for p, r in zip(ptrs, rows)]
        _put(out, _P, _impl_dataset_create_from_mat(
            np.concatenate(mats, axis=0), _str(parameters),
            _opt_handle(reference)))

    @entry
    def LGBM_DatasetGetSubset(handle, used_row_indices, num_used_row_indices,
                              parameters, out):
        c = _get(handle)
        idx = _nparr(used_row_indices, num_used_row_indices, np.int32)
        sub = c.ds.subset(idx, params=_parse_params(_str(parameters)))
        sub.construct()
        _put(out, _P, _new_handle(_CDataset(sub)))

    @entry
    def LGBM_DatasetSetFeatureNames(handle, feature_names, num_feature_names):
        c = _get(handle)
        names = [_str(p) for p in _pointers(feature_names,
                                            num_feature_names)]
        c.ds.construct().handle.feature_names = names

    @entry
    def LGBM_DatasetGetFeatureNames(handle, feature_names, num_feature_names):
        _copy_names(_get(handle).ds.get_feature_name(), num_feature_names,
                    feature_names)

    @entry
    def LGBM_DatasetFree(handle):
        _free_handle(handle)

    @entry
    def LGBM_DatasetSaveBinary(handle, filename):
        _get(handle).ds.save_binary(_str(filename))

    @entry
    def LGBM_DatasetDumpText(handle, filename):
        binned = _get(handle).ds.construct().handle
        with open(_str(filename), "w") as fh:
            fh.write("\t".join(binned.feature_names) + "\n")
            for row in np.asarray(binned.unbundled_matrix()):
                fh.write("\t".join(str(int(v)) for v in row) + "\n")

    @entry
    def LGBM_DatasetSetField(handle, field_name, field_data, num_element,
                             type):
        arr = _typed(field_data, num_element, type)
        _get(handle).ds.set_field(_str(field_name), arr)

    @entry
    def LGBM_DatasetGetField(handle, field_name, out_len, out_ptr, out_type):
        c = _get(handle)
        name = _str(field_name)
        val = c.ds.get_field(name)
        if val is None:
            _put(out_len, _I, 0)
            _put(out_ptr, _P, None)
            return
        val = _host(val)
        if name == "group":
            # the reference returns query boundaries (c_api.cpp Metadata)
            val = np.concatenate([[0], np.cumsum(val)])
            arr = np.ascontiguousarray(val, dtype=np.int32)
            dtype = DTYPE_INT32
        elif name == "init_score":
            arr = np.ascontiguousarray(val, dtype=np.float64)
            dtype = DTYPE_FLOAT64
        else:
            arr = np.ascontiguousarray(val, dtype=np.float32)
            dtype = DTYPE_FLOAT32
        c.field_buffers[name] = arr
        _put(out_type, _I, dtype)
        _put(out_len, _I, arr.shape[0])
        _put(out_ptr, _P, arr.ctypes.data)

    @entry
    def LGBM_DatasetUpdateParam(handle, parameters):
        _get(handle).ds.params.update(_parse_params(_str(parameters)))

    @entry
    def LGBM_DatasetGetNumData(handle, out):
        _put(out, _I, _get(handle).ds.num_data())

    @entry
    def LGBM_DatasetGetNumFeature(handle, out):
        _put(out, _I, _get(handle).ds.num_feature())

    @entry
    def LGBM_DatasetAddFeaturesFrom(target, source):
        _get(target).ds.construct().handle.add_features_from(
            _get(source).ds.construct().handle)

    # ---- booster ----

    @entry
    def LGBM_BoosterCreate(train_data, parameters, out):
        _put(out, _P, _impl_booster_create(_opt_handle(train_data),
                                           _str(parameters)))

    @entry
    def LGBM_BoosterCreateFromModelfile(filename, out_num_iterations, out):
        h, iters = _impl_booster_load(model_file=_str(filename))
        _put(out_num_iterations, _I, iters)
        _put(out, _P, h)

    @entry
    def LGBM_BoosterLoadModelFromString(model_str, out_num_iterations, out):
        h, iters = _impl_booster_load(model_str=_str(model_str))
        _put(out_num_iterations, _I, iters)
        _put(out, _P, h)

    @entry
    def LGBM_BoosterFree(handle):
        _free_handle(handle)

    @entry
    def LGBM_BoosterShuffleModels(handle, start_iter, end_iter):
        _get(handle).booster._booster.shuffle_models(int(start_iter),
                                                     int(end_iter))

    @entry
    def LGBM_BoosterMerge(handle, other_handle):
        _get(handle).booster._booster.merge_from(
            _get(other_handle).booster._booster)

    @entry
    def LGBM_BoosterAddValidData(handle, valid_data):
        cb = _get(handle)
        cv = _get(valid_data)
        cb.booster.add_valid(cv.ds, "valid_%d" % (len(cb.valid_ds) + 1))
        cb.valid_ds.append(cv)

    @entry
    def LGBM_BoosterResetTrainingData(handle, train_data):
        cb = _get(handle)
        ct = _get(train_data)
        ct.ds.construct()
        cb.booster._train_set = ct.ds
        cb.booster._booster.reset_training_data(
            ct.ds.handle, cb.booster._booster.objective)
        cb.train_ds = ct

    @entry
    def LGBM_BoosterResetParameter(handle, parameters):
        _get(handle).booster.reset_parameter(_parse_params(_str(parameters)))

    @entry
    def LGBM_BoosterGetNumClasses(handle, out_len):
        _put(out_len, _I,
             max(int(_get(handle).booster._booster.num_class), 1))

    @entry
    def LGBM_BoosterUpdateOneIter(handle, is_finished):
        _put(is_finished, _I, 1 if _get(handle).booster.update() else 0)

    @entry
    def LGBM_BoosterRefit(handle, leaf_preds, nrow, ncol):
        leaves = _nparr(leaf_preds, int(nrow) * int(ncol),
                        np.int32).reshape(int(nrow), int(ncol))
        _get(handle).booster._booster.refit(leaves)

    @entry
    def LGBM_BoosterUpdateOneIterCustom(handle, grad, hess, is_finished):
        b = _get(handle).booster._booster
        n = b.num_data * b.num_tree_per_iteration
        g = _nparr(grad, n, np.float32)
        h = _nparr(hess, n, np.float32)
        _put(is_finished, _I, 1 if b.watched_iter(g, h) else 0)

    @entry
    def LGBM_BoosterRollbackOneIter(handle):
        _get(handle).booster.rollback_one_iter()

    @entry
    def LGBM_BoosterGetCurrentIteration(handle, out_iteration):
        _put(out_iteration, _I, _get(handle).booster.current_iteration())

    @entry
    def LGBM_BoosterNumModelPerIteration(handle, out_tree_per_iteration):
        _put(out_tree_per_iteration, _I,
             _get(handle).booster.num_model_per_iteration())

    @entry
    def LGBM_BoosterNumberOfTotalModel(handle, out_models):
        _put(out_models, _I, _get(handle).booster.num_trees())

    @entry
    def LGBM_BoosterGetEvalCounts(handle, out_len):
        _put(out_len, _I, len(_eval_names(_get(handle))))

    @entry
    def LGBM_BoosterGetEvalNames(handle, out_len, out_strs):
        _copy_names(_eval_names(_get(handle)), out_len, out_strs)

    @entry
    def LGBM_BoosterGetFeatureNames(handle, out_len, out_strs):
        _copy_names(_get(handle).booster.feature_name(), out_len, out_strs)

    @entry
    def LGBM_BoosterGetNumFeature(handle, out_len):
        _put(out_len, _I, _get(handle).booster.num_feature())

    @entry
    def LGBM_BoosterGetEval(handle, data_idx, out_len, out_results):
        cb = _get(handle)
        if int(data_idx) == 0:
            res = cb.booster.eval_train()
        else:
            name = cb.booster.name_valid_sets[int(data_idx) - 1]
            res = [r for r in cb.booster.eval_valid() if r[0] == name]
        _put(out_len, _I, len(res))
        _write_out(out_results, np.asarray([float(r[2]) for r in res],
                                           dtype=np.float64))

    @entry
    def LGBM_BoosterGetNumPredict(handle, data_idx, out_len):
        cb = _get(handle)
        b = cb.booster._booster
        if int(data_idx) == 0:
            n = b.num_data
        else:
            n = cb.valid_ds[int(data_idx) - 1].ds.num_data()
        _put(out_len, _I64, n * max(int(b.num_class), 1))

    @entry
    def LGBM_BoosterGetPredict(handle, data_idx, out_len, out_result):
        cb = _get(handle)
        which = "train" if int(data_idx) == 0 else int(data_idx) - 1
        scores = cb.booster._flat_score(which)
        conv = cb.booster._booster.objective.convert_output(scores)
        arr = np.ascontiguousarray(_host(conv), dtype=np.float64).ravel()
        cb.predict_buffer[int(data_idx)] = arr
        _put(out_len, _I64, arr.shape[0])
        _write_out(out_result, arr)

    @entry
    def LGBM_BoosterPredictForFile(handle, data_filename, data_has_header,
                                   predict_type, num_iteration, parameter,
                                   result_filename):
        _impl_predict_for_file(_get(handle), _str(data_filename),
                               int(data_has_header), int(predict_type),
                               int(num_iteration), _str(parameter),
                               _str(result_filename))

    @entry
    def LGBM_BoosterCalcNumPredict(handle, num_row, predict_type,
                                   num_iteration, out_len):
        _put(out_len, _I64, int(num_row) * _num_predict_per_row(
            _get(handle), int(predict_type), int(num_iteration)))

    def predict_write(handle, mat, predict_type, num_iteration, parameter,
                      out_len, out_result):
        out = _predict_matrix(_get(handle), mat, int(predict_type),
                              int(num_iteration), _str(parameter)).ravel()
        _put(out_len, _I64, out.shape[0])
        _write_out(out_result, out)

    @entry
    def LGBM_BoosterPredictForCSR(handle, indptr, indptr_type, indices, data,
                                  data_type, nindptr, nelem, num_col,
                                  predict_type, num_iteration, parameter,
                                  out_len, out_result):
        ip = _typed(indptr, nindptr, indptr_type)
        idx = _nparr(indices, nelem, np.int32)
        vals = _typed(data, nelem, data_type)
        predict_write(handle, _csr_to_dense(ip, idx, vals, num_col),
                      predict_type, num_iteration, parameter, out_len,
                      out_result)

    @entry
    def LGBM_BoosterPredictForCSRSingleRow(handle, indptr, indptr_type,
                                           indices, data, data_type, nindptr,
                                           nelem, num_col, predict_type,
                                           num_iteration, parameter, out_len,
                                           out_result):
        LGBM_BoosterPredictForCSR(handle, indptr, indptr_type, indices, data,
                                  data_type, nindptr, nelem, num_col,
                                  predict_type, num_iteration, parameter,
                                  out_len, out_result)

    @entry
    def LGBM_BoosterPredictForCSC(handle, col_ptr, col_ptr_type, indices,
                                  data, data_type, ncol_ptr, nelem, num_row,
                                  predict_type, num_iteration, parameter,
                                  out_len, out_result):
        cp = _typed(col_ptr, ncol_ptr, col_ptr_type)
        idx = _nparr(indices, nelem, np.int32)
        vals = _typed(data, nelem, data_type)
        predict_write(handle, _csc_to_dense(cp, idx, vals, num_row),
                      predict_type, num_iteration, parameter, out_len,
                      out_result)

    @entry
    def LGBM_BoosterPredictForMat(handle, data, data_type, nrow, ncol,
                                  is_row_major, predict_type, num_iteration,
                                  parameter, out_len, out_result):
        mat = _mat_from_ptr(data, data_type, nrow, ncol, int(is_row_major))
        predict_write(handle, mat, predict_type, num_iteration, parameter,
                      out_len, out_result)

    @entry
    def LGBM_BoosterPredictForMatSingleRow(handle, data, data_type, ncol,
                                           is_row_major, predict_type,
                                           num_iteration, parameter, out_len,
                                           out_result):
        mat = _mat_from_ptr(data, data_type, 1, ncol, int(is_row_major))
        predict_write(handle, mat, predict_type, num_iteration, parameter,
                      out_len, out_result)

    @entry
    def LGBM_BoosterPredictForMats(handle, data, data_type, nrow, ncol,
                                   predict_type, num_iteration, parameter,
                                   out_len, out_result):
        mat = np.concatenate([_mat_from_ptr(p, data_type, 1, ncol, 1)
                              for p in _pointers(data, nrow)], axis=0)
        predict_write(handle, mat, predict_type, num_iteration, parameter,
                      out_len, out_result)

    @entry
    def LGBM_BoosterSaveModel(handle, start_iteration, num_iteration,
                              filename):
        ni = int(num_iteration)
        _get(handle).booster.save_model(
            _str(filename), num_iteration=None if ni < 0 else ni,
            start_iteration=int(start_iteration))

    @entry
    def LGBM_BoosterSaveCheckpoint(handle, checkpoint_prefix):
        # the full train state, atomic with a CRC trailer (checkpoint.py)
        _get(handle).booster.save_checkpoint(_str(checkpoint_prefix))

    @entry
    def LGBM_BoosterResumeFromCheckpoint(handle, checkpoint_prefix,
                                         out_iteration):
        # the newest valid checkpoint of the prefix; 0 when there is none
        _put(out_iteration, _I, _get(handle).booster.resume_from_checkpoint(
            _str(checkpoint_prefix)))

    @entry
    def LGBM_BoosterSaveModelToString(handle, start_iteration, num_iteration,
                                      buffer_len, out_len, out_str):
        ni = int(num_iteration)
        text = _get(handle).booster.model_to_string(
            num_iteration=None if ni < 0 else ni,
            start_iteration=int(start_iteration))
        _text_to_buffer(text, buffer_len, out_len, out_str)

    @entry
    def LGBM_BoosterDumpModel(handle, start_iteration, num_iteration,
                              buffer_len, out_len, out_str):
        ni = int(num_iteration)
        text = json.dumps(_get(handle).booster.dump_model(
            num_iteration=None if ni < 0 else ni,
            start_iteration=int(start_iteration)))
        _text_to_buffer(text, buffer_len, out_len, out_str)

    @entry
    def LGBM_BoosterGetLeafValue(handle, tree_idx, leaf_idx, out_val):
        tree = _get(handle).booster._booster.models[int(tree_idx)]
        _put(out_val, ctypes.c_double,
             float(tree.leaf_value[int(leaf_idx)]))

    @entry
    def LGBM_BoosterSetLeafValue(handle, tree_idx, leaf_idx, val):
        _get(handle).booster._booster.set_leaf_value(int(tree_idx),
                                                     int(leaf_idx),
                                                     float(val))

    @entry
    def LGBM_BoosterFeatureImportance(handle, num_iteration, importance_type,
                                      out_results):
        itype = "split" if int(importance_type) == 0 else "gain"
        imp = _get(handle).booster.feature_importance(
            importance_type=itype,
            iteration=None if int(num_iteration) <= 0 else int(num_iteration))
        _write_out(out_results, np.asarray(imp, dtype=np.float64))

    # ---- telemetry (obs) ----

    @entry
    def LGBM_TelemetryConfigure(out_path, freq):
        _impl_telemetry_configure(_str(out_path), int(freq))

    @entry
    def LGBM_TelemetryDisable():
        _impl_telemetry_disable()

    @entry
    def LGBM_TelemetrySummary(buffer_len, out_len, out_str):
        _text_to_buffer(_impl_telemetry_summary(), buffer_len, out_len,
                        out_str)

    @entry
    def LGBM_TelemetryRecompileCount(out_count):
        _put(out_count, ctypes.c_int64, _impl_telemetry_recompile_count())

    # ---- resilience (resilience.py) ----

    @entry
    def LGBM_PreemptionInstall():
        _impl_preemption_install()

    @entry
    def LGBM_PreemptionRequested(out_flag):
        _put(out_flag, _I64, _impl_preemption_requested())

    @entry
    def LGBM_PredictFallbackCount(out_count):
        _put(out_count, _I64, _impl_predict_fallback_count())

    # ---- network shims: no-ops; distribution is torch.distributed's ----

    @entry
    def LGBM_NetworkInit(machines, local_listen_port, listen_time_out,
                         num_machines):
        if int(num_machines) > 1:
            Log.warning("LGBM_NetworkInit is a compatibility no-op: the "
                        "parallel learners run over a torch.distributed "
                        "process group (init_process_group in every process, "
                        "then set tree_learner)")

    @entry
    def LGBM_NetworkFree():
        return None

    @entry
    def LGBM_NetworkInitWithFunctions(num_machines, rank,
                                      reduce_scatter_ext_fun,
                                      allgather_ext_fun):
        if int(num_machines) > 1:
            Log.warning("LGBM_NetworkInitWithFunctions is a compatibility "
                        "no-op: the collectives are torch.distributed's "
                        "(init_process_group in every process, then set "
                        "tree_learner)")

    return E


def bind() -> Dict[str, Callable]:
    """The table the C library calls through: ``LGBM_*`` name -> function
    of the entry's C arguments (pointers as integer addresses) returning 0,
    or -1 with the error kept for ``LGBM_GetLastError``.
    ``LGBM_GetLastError`` and ``LGBM_SetLastError`` live in the C library
    (a thread-local buffer), which reads :func:`get_last_error` after a -1."""
    def wrap(name, fn):
        def wrapper(*args):
            try:
                fn(*args)
                return 0
            except Exception as e:  # noqa: BLE001 - the ABI boundary
                _set_last_error("%s: %s" % (name, e))
                return -1
        wrapper.__name__ = name
        return wrapper
    return {name: wrap(name, fn) for name, fn in _entries().items()}
