"""Build ``lib_lightgbm_tpu_torch.so``: a C shared library exporting the 74
``LGBM_*`` symbols of the reference's ``lib_lightgbm.so`` ABI
(include/LightGBM/c_api.h, plus the checkpoint, telemetry, preemption and
fallback entries of the JAX package's ``tools/build_capi.py``) over the
PyTorch port.

Usage: ``python -m lightgbm_tpu_torch.capi_build [--host] [out_dir]``
(default ``build/capi`` at the repository root); prints the library's
path, and with ``--host`` also the path of the C host program
``lightgbm_tpu_torch_capi_host`` (``capi_host.c``: a file trained through
the ``LGBM_*`` calls alone, see :func:`build_host`).

The C source is generated from :data:`CDEF`, a copy of the JAX package's
ABI declaration list, and needs only ``gcc`` and ``Python.h``: no cffi.
Each ``LGBM_*`` function

1. takes the interpreter lock (``PyGILState_Ensure``);
2. on first use, initialises the interpreter if none runs in the process
   (``Py_IsInitialized``), puts the repository root on ``sys.path`` (and,
   in an interpreter it started, the ``sys.path`` of the Python that built
   it, so that ``torch`` is found), imports ``lightgbm_tpu_torch.c_api``
   and keeps the table its ``bind()`` returns;
3. calls the table's function of its name, with pointers as integers
   (``PyLong_FromVoidPtr``) and ``int``/``int64_t``/``double`` as Python
   numbers;
4. returns that function's ``int``;
5. on -1 or a Python exception, copies the error text into a thread-local
   C buffer, which ``LGBM_GetLastError`` returns and which outlives the
   call.

``libpython`` is linked where the interpreter is built shared
(``Py_ENABLE_SHARED`` = 1), so a process with no Python of its own (a C, R
or Java host) can load the library.  Where it is 0, the symbols of Python
come from the process that loads the library, so only callers hosted in a
Python process (ctypes, SWIG's Python wrapper) can use it.  The header
``lightgbm_tpu_torch_c_api.h`` is written beside the library.  The build
is keyed by a hash of this file, the flags and the paths it bakes in, so an
edit rebuilds it.
"""
from __future__ import annotations

import hashlib
import os
import re
import subprocess
import sys
import sysconfig
from pathlib import Path
from typing import List, Optional, Tuple

REPO_ROOT = Path(__file__).resolve().parent.parent
BUILD_DIR = REPO_ROOT / "build" / "capi"
LIB_NAME = "lib_lightgbm_tpu_torch.so"
HEADER_NAME = "lightgbm_tpu_torch_c_api.h"
HOST_NAME = "lightgbm_tpu_torch_capi_host"
HOST_SOURCE = Path(__file__).resolve().parent / "capi_host.c"
MODULE = "lightgbm_tpu_torch.c_api"

# the ABI surface (c_api.h:58-1044), spelled with plain C types; a copy of
# tools/build_capi.py's list (the test suite holds the two equal)
CDEF = r"""
typedef void* DatasetHandle;
typedef void* BoosterHandle;

const char* LGBM_GetLastError();
int LGBM_DatasetCreateFromFile(const char* filename, const char* parameters,
    const DatasetHandle reference, DatasetHandle* out);
int LGBM_DatasetCreateFromSampledColumn(double** sample_data,
    int** sample_indices, int32_t ncol, const int* num_per_col,
    int32_t num_sample_row, int32_t num_total_row, const char* parameters,
    DatasetHandle* out);
int LGBM_DatasetCreateByReference(const DatasetHandle reference,
    int64_t num_total_row, DatasetHandle* out);
int LGBM_DatasetPushRows(DatasetHandle dataset, const void* data,
    int data_type, int32_t nrow, int32_t ncol, int32_t start_row);
int LGBM_DatasetPushRowsByCSR(DatasetHandle dataset, const void* indptr,
    int indptr_type, const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t num_col, int64_t start_row);
int LGBM_DatasetCreateFromCSR(const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type, int64_t nindptr,
    int64_t nelem, int64_t num_col, const char* parameters,
    const DatasetHandle reference, DatasetHandle* out);
int LGBM_DatasetCreateFromCSRFunc(void* get_row_funptr, int num_rows,
    int64_t num_col, const char* parameters, const DatasetHandle reference,
    DatasetHandle* out);
int LGBM_DatasetCreateFromCSC(const void* col_ptr, int col_ptr_type,
    const int32_t* indices, const void* data, int data_type, int64_t ncol_ptr,
    int64_t nelem, int64_t num_row, const char* parameters,
    const DatasetHandle reference, DatasetHandle* out);
int LGBM_DatasetCreateFromMat(const void* data, int data_type, int32_t nrow,
    int32_t ncol, int is_row_major, const char* parameters,
    const DatasetHandle reference, DatasetHandle* out);
int LGBM_DatasetCreateFromMats(int32_t nmat, const void** data, int data_type,
    int32_t* nrow, int32_t ncol, int is_row_major, const char* parameters,
    const DatasetHandle reference, DatasetHandle* out);
int LGBM_DatasetGetSubset(const DatasetHandle handle,
    const int32_t* used_row_indices, int32_t num_used_row_indices,
    const char* parameters, DatasetHandle* out);
int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
    const char** feature_names, int num_feature_names);
int LGBM_DatasetGetFeatureNames(DatasetHandle handle, char** feature_names,
    int* num_feature_names);
int LGBM_DatasetFree(DatasetHandle handle);
int LGBM_DatasetSaveBinary(DatasetHandle handle, const char* filename);
int LGBM_DatasetDumpText(DatasetHandle handle, const char* filename);
int LGBM_DatasetSetField(DatasetHandle handle, const char* field_name,
    const void* field_data, int num_element, int type);
int LGBM_DatasetGetField(DatasetHandle handle, const char* field_name,
    int* out_len, const void** out_ptr, int* out_type);
int LGBM_DatasetUpdateParam(DatasetHandle handle, const char* parameters);
int LGBM_DatasetGetNumData(DatasetHandle handle, int* out);
int LGBM_DatasetGetNumFeature(DatasetHandle handle, int* out);
int LGBM_DatasetAddFeaturesFrom(DatasetHandle target, DatasetHandle source);
int LGBM_BoosterCreate(const DatasetHandle train_data, const char* parameters,
    BoosterHandle* out);
int LGBM_BoosterCreateFromModelfile(const char* filename,
    int* out_num_iterations, BoosterHandle* out);
int LGBM_BoosterLoadModelFromString(const char* model_str,
    int* out_num_iterations, BoosterHandle* out);
int LGBM_BoosterFree(BoosterHandle handle);
int LGBM_BoosterShuffleModels(BoosterHandle handle, int start_iter,
    int end_iter);
int LGBM_BoosterMerge(BoosterHandle handle, BoosterHandle other_handle);
int LGBM_BoosterAddValidData(BoosterHandle handle,
    const DatasetHandle valid_data);
int LGBM_BoosterResetTrainingData(BoosterHandle handle,
    const DatasetHandle train_data);
int LGBM_BoosterResetParameter(BoosterHandle handle, const char* parameters);
int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out_len);
int LGBM_BoosterUpdateOneIter(BoosterHandle handle, int* is_finished);
int LGBM_BoosterRefit(BoosterHandle handle, const int32_t* leaf_preds,
    int32_t nrow, int32_t ncol);
int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle, const float* grad,
    const float* hess, int* is_finished);
int LGBM_BoosterRollbackOneIter(BoosterHandle handle);
int LGBM_BoosterGetCurrentIteration(BoosterHandle handle, int* out_iteration);
int LGBM_BoosterNumModelPerIteration(BoosterHandle handle,
    int* out_tree_per_iteration);
int LGBM_BoosterNumberOfTotalModel(BoosterHandle handle, int* out_models);
int LGBM_BoosterGetEvalCounts(BoosterHandle handle, int* out_len);
int LGBM_BoosterGetEvalNames(BoosterHandle handle, int* out_len,
    char** out_strs);
int LGBM_BoosterGetFeatureNames(BoosterHandle handle, int* out_len,
    char** out_strs);
int LGBM_BoosterGetNumFeature(BoosterHandle handle, int* out_len);
int LGBM_BoosterGetEval(BoosterHandle handle, int data_idx, int* out_len,
    double* out_results);
int LGBM_BoosterGetNumPredict(BoosterHandle handle, int data_idx,
    int64_t* out_len);
int LGBM_BoosterGetPredict(BoosterHandle handle, int data_idx,
    int64_t* out_len, double* out_result);
int LGBM_BoosterPredictForFile(BoosterHandle handle, const char* data_filename,
    int data_has_header, int predict_type, int num_iteration,
    const char* parameter, const char* result_filename);
int LGBM_BoosterCalcNumPredict(BoosterHandle handle, int num_row,
    int predict_type, int num_iteration, int64_t* out_len);
int LGBM_BoosterPredictForCSR(BoosterHandle handle, const void* indptr,
    int indptr_type, const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t num_col, int predict_type,
    int num_iteration, const char* parameter, int64_t* out_len,
    double* out_result);
int LGBM_BoosterPredictForCSRSingleRow(BoosterHandle handle,
    const void* indptr, int indptr_type, const int32_t* indices,
    const void* data, int data_type, int64_t nindptr, int64_t nelem,
    int64_t num_col, int predict_type, int num_iteration,
    const char* parameter, int64_t* out_len, double* out_result);
int LGBM_BoosterPredictForCSC(BoosterHandle handle, const void* col_ptr,
    int col_ptr_type, const int32_t* indices, const void* data, int data_type,
    int64_t ncol_ptr, int64_t nelem, int64_t num_row, int predict_type,
    int num_iteration, const char* parameter, int64_t* out_len,
    double* out_result);
int LGBM_BoosterPredictForMat(BoosterHandle handle, const void* data,
    int data_type, int32_t nrow, int32_t ncol, int is_row_major,
    int predict_type, int num_iteration, const char* parameter,
    int64_t* out_len, double* out_result);
int LGBM_BoosterPredictForMatSingleRow(BoosterHandle handle, const void* data,
    int data_type, int ncol, int is_row_major, int predict_type,
    int num_iteration, const char* parameter, int64_t* out_len,
    double* out_result);
int LGBM_BoosterPredictForMats(BoosterHandle handle, const void** data,
    int data_type, int32_t nrow, int32_t ncol, int predict_type,
    int num_iteration, const char* parameter, int64_t* out_len,
    double* out_result);
int LGBM_BoosterSaveModel(BoosterHandle handle, int start_iteration,
    int num_iteration, const char* filename);
int LGBM_BoosterSaveCheckpoint(BoosterHandle handle,
    const char* checkpoint_prefix);
int LGBM_BoosterResumeFromCheckpoint(BoosterHandle handle,
    const char* checkpoint_prefix, int* out_iteration);
int LGBM_BoosterSaveModelToString(BoosterHandle handle, int start_iteration,
    int num_iteration, int64_t buffer_len, int64_t* out_len, char* out_str);
int LGBM_BoosterDumpModel(BoosterHandle handle, int start_iteration,
    int num_iteration, int64_t buffer_len, int64_t* out_len, char* out_str);
int LGBM_BoosterGetLeafValue(BoosterHandle handle, int tree_idx, int leaf_idx,
    double* out_val);
int LGBM_BoosterSetLeafValue(BoosterHandle handle, int tree_idx, int leaf_idx,
    double val);
int LGBM_BoosterFeatureImportance(BoosterHandle handle, int num_iteration,
    int importance_type, double* out_results);
int LGBM_TelemetryConfigure(const char* out_path, int freq);
int LGBM_TelemetryDisable();
int LGBM_TelemetrySummary(int64_t buffer_len, int64_t* out_len,
    char* out_str);
int LGBM_TelemetryRecompileCount(int64_t* out_count);
int LGBM_PreemptionInstall();
int LGBM_PreemptionRequested(int64_t* out_flag);
int LGBM_PredictFallbackCount(int64_t* out_count);
int LGBM_NetworkInit(const char* machines, int local_listen_port,
    int listen_time_out, int num_machines);
int LGBM_NetworkFree();
int LGBM_NetworkInitWithFunctions(int num_machines, int rank,
    void* reduce_scatter_ext_fun, void* allgather_ext_fun);
void LGBM_SetLastError(const char* msg);
"""

HEADER_PRELUDE = """\
/* lightgbm_tpu_torch_c_api.h - generated by lightgbm_tpu_torch/capi_build.py.
 * The LGBM_* ABI of lib_lightgbm_tpu_torch.so (the surface of the
 * reference's include/LightGBM/c_api.h).  Every function returns 0, or -1
 * with the message in LGBM_GetLastError().  The device is CUDA unless the
 * environment variable LIGHTGBM_TPU_TORCH_DEVICE=cpu is set before the
 * first call.  LGBM_DatasetCreateFromCSRFunc takes a C function
 *     int get_row(int idx, int32_t* indices, double* values)
 * that writes row idx's nonzeros (at most num_col) and returns their count. */
#ifndef LIGHTGBM_TPU_TORCH_C_API_H_
#define LIGHTGBM_TPU_TORCH_C_API_H_
#include <stdint.h>
#ifdef __cplusplus
extern "C" {
#endif
"""

HEADER_EPILOGUE = """\
#ifdef __cplusplus
}
#endif
#endif  /* LIGHTGBM_TPU_TORCH_C_API_H_ */
"""

_POINTER_TYPES = ("DatasetHandle", "BoosterHandle")


def declarations() -> List[Tuple[str, str, List[Tuple[str, str]]]]:
    """``(return type, name, [(param type, param name), ...])`` of every
    ``LGBM_*`` declaration of :data:`CDEF`, in order."""
    out = []
    for m in re.finditer(r"([\w\s\*]+?)\s*\b(LGBM_\w+)\s*\(([^)]*)\)\s*;",
                         CDEF):
        ret, name, plist = m.group(1).strip(), m.group(2), m.group(3)
        params = []
        for p in (x.strip() for x in plist.split(",")):
            if not p or p == "void":
                continue
            pm = re.match(r"(.*?)(\w+)$", " ".join(p.split()))
            params.append((pm.group(1).strip(), pm.group(2)))
        out.append((ret, name, params))
    return out


def _is_pointer(ctype: str) -> bool:
    return "*" in ctype or any(t in ctype.split() for t in _POINTER_TYPES)


def _c_literal(s: str) -> str:
    """``s`` as a C string literal (UTF-8, octal escapes outside ASCII)."""
    out = []
    for b in s.encode("utf-8"):
        c = chr(b)
        if c in "\\\"":
            out.append("\\" + c)
        elif 32 <= b < 127 and c != "?":
            out.append(c)
        else:
            out.append("\\%03o" % b)
    return '"' + "".join(out) + '"'


_C_RUNTIME = r"""
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <pthread.h>
#include <stdlib.h>
#include <string.h>
#include "%(header)s"

static const char *lgbm_repo_root = %(repo)s;
static const char *lgbm_build_path[] = {%(paths)s NULL};
static pthread_mutex_t lgbm_mu = PTHREAD_MUTEX_INITIALIZER;
static volatile int lgbm_ready = 0;
static PyObject *lgbm_table = NULL;   /* name -> function, never freed */
static __thread char *lgbm_err = NULL;
static __thread size_t lgbm_err_cap = 0;

static void lgbm_store_error(const char *msg) {
  size_t n = strlen(msg) + 1;
  if (n > lgbm_err_cap) {
    char *p = (char *)realloc(lgbm_err, n);
    if (p == NULL) return;
    lgbm_err = p;
    lgbm_err_cap = n;
  }
  memcpy(lgbm_err, msg, n);
}

/* the text of the pending Python exception into the error buffer (GIL
   held); clears the exception */
static void lgbm_error_from_python(void) {
  PyObject *type, *value, *tb, *s = NULL;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  if (value != NULL) s = PyObject_Str(value);
  if (s != NULL && PyUnicode_Check(s)) {
    const char *u = PyUnicode_AsUTF8(s);
    const char *tn = type ? ((PyTypeObject *)type)->tp_name : "error";
    size_t n = strlen(tn) + strlen(u ? u : "") + 3;
    char *msg = (char *)malloc(n);
    if (msg != NULL) {
      snprintf(msg, n, "%%s: %%s", tn, u ? u : "");
      lgbm_store_error(msg);
      free(msg);
    }
  } else {
    lgbm_store_error("lib_lightgbm_tpu_torch: Python error");
  }
  PyErr_Clear();
  Py_XDECREF(s);
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

/* the error text the Python side kept for this thread (GIL held) */
static void lgbm_error_from_module(void) {
  PyObject *mod = PyImport_ImportModule("%(module)s");
  PyObject *r = mod ? PyObject_CallMethod(mod, "get_last_error", NULL) : NULL;
  const char *u = (r != NULL && PyUnicode_Check(r)) ? PyUnicode_AsUTF8(r)
                                                    : NULL;
  if (u != NULL) lgbm_store_error(u);
  else lgbm_error_from_python();
  Py_XDECREF(r);
  Py_XDECREF(mod);
}

static int lgbm_path_add(PyObject *path, const char *dir, int front) {
  PyObject *p = PyUnicode_FromString(dir);
  int has, rc = 0;
  if (p == NULL) return -1;
  has = PySequence_Contains(path, p);
  if (has == 0) rc = front ? PyList_Insert(path, 0, p) : PyList_Append(path, p);
  else if (has < 0) rc = -1;
  Py_DECREF(p);
  return rc;
}

/* runs with the GIL held: sys.path, the import, the entry table */
static int lgbm_load(int own_interpreter) {
  PyObject *path = PySys_GetObject("path"), *mod, *table;
  int i;
  if (path == NULL || !PyList_Check(path)) {
    PyErr_SetString(PyExc_RuntimeError, "sys.path is not a list");
    return -1;
  }
  if (lgbm_path_add(path, lgbm_repo_root, 1) != 0) return -1;
  if (own_interpreter)
    for (i = 0; lgbm_build_path[i] != NULL; ++i)
      if (lgbm_path_add(path, lgbm_build_path[i], 0) != 0) return -1;
  mod = PyImport_ImportModule("%(module)s");
  if (mod == NULL) return -1;
  table = PyObject_CallMethod(mod, "bind", NULL);
  Py_DECREF(mod);
  if (table == NULL) return -1;
  if (!PyDict_Check(table)) {
    Py_DECREF(table);
    PyErr_SetString(PyExc_TypeError, "bind() did not return a dict");
    return -1;
  }
  lgbm_table = table;
  return 0;
}

/* the interpreter and the entry table, made once; 0 on success */
static int lgbm_ensure(void) {
  int rc = 0;
  if (lgbm_ready) return 0;
  pthread_mutex_lock(&lgbm_mu);
  if (!lgbm_ready) {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);   /* this thread now holds the GIL */
      if (lgbm_load(1) != 0) {
        lgbm_error_from_python();
        rc = -1;
      } else {
        lgbm_ready = 1;
      }
      PyEval_SaveThread();   /* let every thread take it */
    } else {
      PyGILState_STATE g = PyGILState_Ensure();
      if (lgbm_load(0) != 0) {
        lgbm_error_from_python();
        rc = -1;
      } else {
        lgbm_ready = 1;
      }
      PyGILState_Release(g);
    }
  }
  pthread_mutex_unlock(&lgbm_mu);
  return rc;
}

/* call the table's entry with args (a new reference, stolen); GIL held */
static int lgbm_call(const char *name, PyObject *args) {
  PyObject *fn, *res;
  long rc = -1;
  if (args == NULL) {
    lgbm_error_from_python();
    return -1;
  }
  fn = PyDict_GetItemString(lgbm_table, name);
  if (fn == NULL) {
    Py_DECREF(args);
    lgbm_store_error("lib_lightgbm_tpu_torch: no Python entry for this "
                     "symbol");
    return -1;
  }
  res = PyObject_CallObject(fn, args);
  Py_DECREF(args);
  if (res == NULL) {
    lgbm_error_from_python();
    return -1;
  }
  rc = PyLong_AsLong(res);
  Py_DECREF(res);
  if (rc == -1 && PyErr_Occurred()) {
    lgbm_error_from_python();
    return -1;
  }
  if (rc != 0) lgbm_error_from_module();
  return (int)rc;
}

const char* LGBM_GetLastError() {
  return lgbm_err != NULL ? lgbm_err : "Everything is fine";
}

void LGBM_SetLastError(const char* msg) {
  lgbm_store_error(msg != NULL ? msg : "");
}
"""

_C_ENTRY = """
%(ret)s %(name)s(%(params)s) {
  PyGILState_STATE g;
  int rc;
  if (lgbm_ensure() != 0) return -1;
  g = PyGILState_Ensure();
  rc = lgbm_call("%(name)s", Py_BuildValue("(%(fmt)s)"%(args)s));
  PyGILState_Release(g);
  return rc;
}
"""


def _search_path() -> List[str]:
    """The building interpreter's ``sys.path`` directories, for an
    interpreter the library starts itself."""
    root = str(REPO_ROOT)
    return [p for p in sys.path
            if p and os.path.isabs(p) and os.path.isdir(p) and p != root]


def c_source() -> str:
    """The library's C source."""
    paths = "".join("%s, " % _c_literal(p) for p in _search_path())
    parts = [_C_RUNTIME % dict(header=HEADER_NAME,
                               repo=_c_literal(str(REPO_ROOT)), paths=paths,
                               module=MODULE)]
    for ret, name, params in declarations():
        if name in ("LGBM_GetLastError", "LGBM_SetLastError"):
            continue
        fmt, args = [], []
        for ctype, pname in params:
            if _is_pointer(ctype):
                fmt.append("N")
                args.append("PyLong_FromVoidPtr((void *)%s)" % pname)
            elif ctype.endswith("double"):
                fmt.append("d")
                args.append("(double)%s" % pname)
            elif ctype.endswith("int64_t"):
                fmt.append("L")
                args.append("(long long)%s" % pname)
            else:
                fmt.append("i")
                args.append("(int)%s" % pname)
        parts.append(_C_ENTRY % dict(
            ret=ret, name=name,
            params=", ".join("%s %s" % p for p in params) or "void",
            fmt="".join(fmt), args="".join(", " + a for a in args)))
    return "".join(parts)


def header() -> str:
    return HEADER_PRELUDE + CDEF + HEADER_EPILOGUE


def _link_flags() -> List[str]:
    """``-lpython3.x`` where the interpreter is built shared; nothing
    where it is static (the loading process then provides Python)."""
    if str(sysconfig.get_config_var("Py_ENABLE_SHARED")) != "1":
        return []
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = sysconfig.get_config_var("LDVERSION") or (
        sysconfig.get_config_var("VERSION") or "")
    flags = ["-lpython%s" % ver]
    if libdir:
        flags = ["-L" + libdir, "-Wl,-rpath," + libdir] + flags
    return flags


def _command(src: Path, out: Path, include_dir: Path) -> List[str]:
    cc = os.environ.get("CC", "gcc")
    return ([cc, "-shared", "-fPIC", "-O2", "-Wall", "-Werror",
             "-Wno-unused-function",
             "-I" + sysconfig.get_paths()["include"], "-I" + str(include_dir),
             "-o", str(out), str(src), "-lpthread"] + _link_flags())


def _digest() -> str:
    h = hashlib.sha256(Path(__file__).read_bytes())
    h.update(repr((_command(Path("s"), Path("o"), Path("i")),
                   str(REPO_ROOT), _search_path())).encode())
    return h.hexdigest()[:16]


class CapiBuildError(RuntimeError):
    pass


def build(out_dir: Optional[str] = None) -> str:
    """Write the header and C source into ``out_dir`` (default
    ``build/capi``), compile the library there unless its stamp matches,
    and return the library's path."""
    out = Path(out_dir) if out_dir else BUILD_DIR
    out.mkdir(parents=True, exist_ok=True)
    lib = out / LIB_NAME
    stamp = out / (LIB_NAME + ".sha")
    digest = _digest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return str(lib)
    (out / HEADER_NAME).write_text(header())
    src = out / "lib_lightgbm_tpu_torch.c"
    src.write_text(c_source())
    tmp = out / (LIB_NAME + ".tmp%d" % os.getpid())
    proc = subprocess.run(_command(src, tmp, out), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise CapiBuildError("building %s failed (rc %d):\n%s%s"
                             % (LIB_NAME, proc.returncode, proc.stdout,
                                proc.stderr))
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return str(lib)


def build_host(out_dir: Optional[str] = None) -> str:
    """Build the library (:func:`build`) and the C host program of
    ``capi_host.c`` beside it, compiled with ``gcc`` against
    ``lightgbm_tpu_torch_c_api.h`` and linked to the library, which it
    finds at run time through its rpath; return the program's path.
    Rebuilt when the library, the source or the flags change.  It needs a
    Python built shared (``Py_ENABLE_SHARED`` = 1, as on the machines the
    port runs on): the library then brings ``libpython`` into a process
    that has no Python of its own."""
    if str(sysconfig.get_config_var("Py_ENABLE_SHARED")) != "1":
        raise CapiBuildError("the C host program needs a Python built "
                             "shared (Py_ENABLE_SHARED = 1)")
    lib = Path(build(out_dir))
    out = lib.parent
    exe = out / HOST_NAME
    cmd = [os.environ.get("CC", "gcc"), "-O2", "-Wall", "-Werror",
           "-I" + str(out), "-o", str(exe) + ".tmp%d" % os.getpid(),
           str(HOST_SOURCE), "-L" + str(out), "-Wl,-rpath," + str(out),
           "-l:" + LIB_NAME]
    h = hashlib.sha256(HOST_SOURCE.read_bytes())
    h.update(repr(cmd[:6] + cmd[7:]).encode())
    h.update((out / (LIB_NAME + ".sha")).read_bytes())
    digest = h.hexdigest()[:16]
    stamp = out / (HOST_NAME + ".sha")
    if exe.exists() and stamp.exists() and stamp.read_text() == digest:
        return str(exe)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise CapiBuildError("building %s failed (rc %d):\n%s%s"
                             % (HOST_NAME, proc.returncode, proc.stdout,
                                proc.stderr))
    os.replace(cmd[6], exe)
    stamp.write_text(digest)
    return str(exe)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(
        description="build lib_lightgbm_tpu_torch.so (the LGBM_* C ABI)")
    ap.add_argument("--host", action="store_true",
                    help="also build the C host program (capi_host.c)")
    ap.add_argument("out_dir", nargs="?", default=None)
    args = ap.parse_args()
    print(build(args.out_dir))
    if args.host:
        print(build_host(args.out_dir))
