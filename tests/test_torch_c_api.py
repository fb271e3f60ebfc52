"""The port's C ABI (``lib_lightgbm_tpu_torch.so``, built by
``lightgbm_tpu_torch/capi_build.py`` with ``gcc``, no cffi) against the JAX
package's library (built by ``tools/build_capi.py``), both loaded with
ctypes in this process, on the CPU (``LIGHTGBM_TPU_TORCH_DEVICE=cpu``, 63
bins, one torch thread).

``tests/test_c_api.py``'s sequence runs through both libraries call for
call: datasets from a file, a matrix, CSR and CSC and a binary round trip,
fields set and read back, the streaming push; boosters trained with a
validation set, evaluated every iteration, saved, loaded and used to
predict in all four predict types; ``LGBM_BoosterMerge``,
``ShuffleModels``, ``Get/SetLeafValue``, ``Refit``, ``RollbackOneIter`` and
``SaveCheckpoint``/``ResumeFromCheckpoint``.  The results are held to the
JAX library's: the same trees (split features, thresholds, children and
leaf counts equal; leaf values within ``leaf_value_tolerance`` of
``tests/test_torch_train.py``), evaluations within 1e-6, predictions within
``tests/test_torch_engine.py``'s 1e-5 (leaf indices equal), the shuffled
order equal.  Also: the two libraries' symbol lists equal (74 ``LGBM_*``
entries), ``tests/test_r_glue_sequence.py``'s call order against the
port's library, the row callback of ``LGBM_DatasetCreateFromCSRFunc``, the
error protocol, the telemetry entries, and the device rule: without CUDA
and without the variable, ``LGBM_BoosterCreate`` returns -1 naming it.
"""
import ast
import ctypes
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as P
from lightgbm_tpu_torch import GBDT, Config, c_api, capi_build
from test_torch_train import leaf_value_tolerance

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32, F64, I32, I64 = 0, 1, 2, 3
DS_PARAMS = b"max_bin=63"
BOOST_PARAMS = b"objective=binary metric=auc num_leaves=15 verbosity=-1"


@pytest.fixture(scope="module")
def cpu_setting():
    """The C ABI's device variable set to ``cpu`` (and the imported
    module's setting with it: the library calls this process's module)."""
    saved = (os.environ.get(c_api.DEVICE_ENV), c_api._DEVICE_SETTING)
    os.environ[c_api.DEVICE_ENV] = "cpu"
    c_api._DEVICE_SETTING = c_api._device_setting("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if saved[0] is None:
        os.environ.pop(c_api.DEVICE_ENV, None)
    else:
        os.environ[c_api.DEVICE_ENV] = saved[0]
    c_api._DEVICE_SETTING = saved[1]


def load(path):
    lib = ctypes.CDLL(path)
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    return lib


@pytest.fixture(scope="module")
def port_so(tmp_path_factory):
    return capi_build.build(str(tmp_path_factory.mktemp("port_capi")))


@pytest.fixture(scope="module")
def port(port_so, cpu_setting):
    return Capi(load(port_so))


@pytest.fixture(scope="module")
def jax(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from build_capi import build
    finally:
        sys.path.pop(0)
    return Capi(load(build(str(tmp_path_factory.mktemp("jax_capi")))))


@pytest.fixture(scope="module")
def data_files(tmp_path_factory):
    """tests/test_c_api.py's files: 800 + 200 rows x 6 features."""
    out = tmp_path_factory.mktemp("capi_data")
    rng = np.random.RandomState(7)
    paths = {}
    for name, n in (("train", 800), ("test", 200)):
        X = rng.normal(size=(n, 6))
        y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
             + rng.normal(scale=0.3, size=n) > 0).astype(int)
        path = out / ("binary.%s" % name)
        np.savetxt(path, np.column_stack([y, X]), delimiter="\t",
                   fmt="%.6f")
        paths[name] = str(path)
    return paths


def c_array(ctype, values):
    return (ctype * len(values))(*values)


def ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


class Capi:
    """One library's entries with Python arguments and results."""

    def __init__(self, lib):
        self.lib = lib

    def __call__(self, name, *args):
        rc = getattr(self.lib, name)(*args)
        assert rc == 0, "%s: %s" % (name, self.lib.LGBM_GetLastError())

    def error(self):
        return self.lib.LGBM_GetLastError().decode()

    # ---- datasets ----

    def from_file(self, path, ref=None, params=DS_PARAMS):
        h = ctypes.c_void_p()
        self("LGBM_DatasetCreateFromFile", path.encode(), params, ref,
             ctypes.byref(h))
        return h

    def from_mat(self, X, y=None, ref=None, row_major=True, dtype=F64,
                 params=DS_PARAMS):
        X = np.asarray(X, dtype=np.float64 if dtype == F64 else np.float32)
        mat = np.ascontiguousarray(X) if row_major else np.asfortranarray(X)
        h = ctypes.c_void_p()
        self("LGBM_DatasetCreateFromMat", ptr(mat), dtype,
             ctypes.c_int32(X.shape[0]), ctypes.c_int32(X.shape[1]),
             int(row_major), params, ref, ctypes.byref(h))
        if y is not None:
            self.set_field(h, "label", np.asarray(y, np.float32))
        return h

    def from_csr(self, X, ref=None):
        indptr, indices, data = dense_to_csr(X)
        h = ctypes.c_void_p()
        self("LGBM_DatasetCreateFromCSR", ptr(indptr), I64, ptr(indices),
             ptr(data), F64, ctypes.c_int64(len(indptr)),
             ctypes.c_int64(len(data)), ctypes.c_int64(X.shape[1]),
             DS_PARAMS, ref, ctypes.byref(h))
        return h

    def from_csc(self, X, ref=None):
        col_ptr, indices, data = dense_to_csr(np.asarray(X).T)
        h = ctypes.c_void_p()
        self("LGBM_DatasetCreateFromCSC", ptr(col_ptr.astype(np.int32)),
             I32, ptr(indices), ptr(data), F64, ctypes.c_int64(len(col_ptr)),
             ctypes.c_int64(len(data)), ctypes.c_int64(X.shape[0]),
             DS_PARAMS, ref, ctypes.byref(h))
        return h

    def set_field(self, h, name, arr):
        code = {np.dtype(np.float32): F32, np.dtype(np.float64): F64,
                np.dtype(np.int32): I32}[arr.dtype]
        self("LGBM_DatasetSetField", h, name.encode(), ptr(arr), len(arr),
             code)

    def get_field(self, h, name):
        n, p, t = ctypes.c_int(), ctypes.c_void_p(), ctypes.c_int()
        self("LGBM_DatasetGetField", h, name.encode(), ctypes.byref(n),
             ctypes.byref(p), ctypes.byref(t))
        if not n.value:
            return None
        dt = {F32: np.float32, F64: np.float64, I32: np.int32}[t.value]
        return np.frombuffer((ctypes.c_char * (n.value * np.dtype(dt)
                                                .itemsize)).from_address(
            p.value), dtype=dt).copy()

    def num(self, name, h, ctype=ctypes.c_int):
        out = ctype()
        self(name, h, ctypes.byref(out))
        return out.value

    def names(self, entry, h, count):
        bufs = [ctypes.create_string_buffer(128) for _ in range(count)]
        arr = (ctypes.c_char_p * count)(*[ctypes.addressof(b) for b in bufs])
        n = ctypes.c_int()
        if entry == "LGBM_DatasetGetFeatureNames":
            self(entry, h, arr, ctypes.byref(n))
        else:
            self(entry, h, ctypes.byref(n), arr)
        return [b.value.decode() for b in bufs[:n.value]]

    # ---- boosters ----

    def booster(self, train, params=BOOST_PARAMS, valid=()):
        b = ctypes.c_void_p()
        self("LGBM_BoosterCreate", train, params, ctypes.byref(b))
        for v in valid:
            self("LGBM_BoosterAddValidData", b, v)
        return b

    def update(self, b, n=1):
        fin = ctypes.c_int()
        for _ in range(n):
            self("LGBM_BoosterUpdateOneIter", b, ctypes.byref(fin))
        return fin.value

    def eval(self, b, idx):
        res = np.zeros(8)
        n = ctypes.c_int()
        self("LGBM_BoosterGetEval", b, idx, ctypes.byref(n),
             res.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return res[:n.value]

    def model(self, b, start=0, num=-1):
        n = ctypes.c_int64()
        self("LGBM_BoosterSaveModelToString", b, start, num,
             ctypes.c_int64(0), ctypes.byref(n), None)
        buf = ctypes.create_string_buffer(n.value)
        self("LGBM_BoosterSaveModelToString", b, start, num, n,
             ctypes.byref(n), buf)
        return buf.value.decode()

    def dump(self, b):
        n = ctypes.c_int64()
        self("LGBM_BoosterDumpModel", b, 0, -1, ctypes.c_int64(0),
             ctypes.byref(n), None)
        buf = ctypes.create_string_buffer(n.value)
        self("LGBM_BoosterDumpModel", b, 0, -1, n, ctypes.byref(n), buf)
        return json.loads(buf.value.decode())

    def load_string(self, text):
        b, it = ctypes.c_void_p(), ctypes.c_int()
        self("LGBM_BoosterLoadModelFromString", text.encode(),
             ctypes.byref(it), ctypes.byref(b))
        return b, it.value

    def predict(self, b, X, ptype, num_iter=-1, param=b""):
        X = np.ascontiguousarray(X, dtype=np.float64)
        want = ctypes.c_int64()
        self("LGBM_BoosterCalcNumPredict", b, X.shape[0], ptype, num_iter,
             ctypes.byref(want))
        out = np.zeros(want.value)
        n = ctypes.c_int64()
        self("LGBM_BoosterPredictForMat", b, ptr(X), F64,
             ctypes.c_int32(X.shape[0]), ctypes.c_int32(X.shape[1]), 1,
             ptype, num_iter, param, ctypes.byref(n),
             out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        assert n.value == want.value
        return out.reshape(X.shape[0], -1)

    def leaf(self, b, tree, leaf):
        v = ctypes.c_double()
        self("LGBM_BoosterGetLeafValue", b, tree, leaf, ctypes.byref(v))
        return v.value


def dense_to_csr(X):
    indptr, indices, data = [0], [], []
    for row in np.asarray(X):
        nz = np.nonzero(row)[0]
        indices.extend(int(j) for j in nz)
        data.extend(float(v) for v in row[nz])
        indptr.append(len(indices))
    return (np.asarray(indptr, np.int64), np.asarray(indices, np.int32),
            np.asarray(data, np.float64))


def read(path):
    raw = np.loadtxt(path, delimiter="\t")
    return raw[:, 1:], raw[:, 0]


def trees(text):
    g = GBDT(Config(), device="cpu")
    g.load_model_from_string(text)
    return g.models


NEAR_TIE_RTOL = 1e-6
# the held-out AUC after a near tie: the trees differ from there on
AUC_BUDGET = 5e-3


def assert_same_model(port_text, jax_text, n):
    """The same trees: structure and leaf counts equal, leaf values within
    ``leaf_value_tolerance``, up to the first split the two packages
    choose differently, which must be an f32 near tie (the two chosen
    gains within ``NEAR_TIE_RTOL`` of the tree's largest gain: a gain is a
    difference of f32 sums as large as the root's; ROADMAP queue 3).  The
    trees after it grow from other scores and are not compared.  Returns the number of
    trees held equal."""
    ours, ref = trees(port_text), trees(jax_text)
    assert len(ours) == len(ref)
    for i, (a, b) in enumerate(zip(ref, ours)):
        nl = a.num_leaves
        split = np.flatnonzero(
            (a.split_feature[:nl - 1] != b.split_feature[:nl - 1])
            | (a.threshold[:nl - 1] != b.threshold[:nl - 1]))
        if split.size and b.num_leaves > split[0]:
            k = split[0]
            scale = float(np.max(a.split_gain[:nl - 1]))
            assert abs(float(b.split_gain[k]) - float(a.split_gain[k])) \
                <= NEAR_TIE_RTOL * scale, "tree %d node %d" % (i, k)
            return i
        assert b.num_leaves == nl, "tree %d" % i
        for name in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:nl - 1],
                                          getattr(a, name)[:nl - 1],
                                          err_msg="tree %d %s" % (i, name))
        np.testing.assert_array_equal(b.leaf_count[:nl], a.leaf_count[:nl])
        np.testing.assert_array_less(
            np.abs(b.leaf_value[:nl] - a.leaf_value[:nl]),
            leaf_value_tolerance(a, n) + 1e-12, err_msg="tree %d" % i)
    return len(ref)


def cdef_names(path):
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "CDEF":
            text = node.value.value
    import re
    return re.findall(r"\b(LGBM_\w+)\s*\(", text)


def test_symbol_lists_equal(port_so):
    """The port's ABI list is tools/build_capi.py's, 74 entries, and the
    built library exports every one."""
    ours = cdef_names(os.path.join(REPO, "lightgbm_tpu_torch",
                                   "capi_build.py"))
    theirs = cdef_names(os.path.join(REPO, "tools", "build_capi.py"))
    assert ours == theirs and len(set(ours)) == 74
    assert [d[1] for d in capi_build.declarations()] == ours
    lib = ctypes.CDLL(port_so)
    for name in ours:
        assert hasattr(lib, name), name
    # every entry but the two error functions has its Python function
    assert set(c_api.bind()) == set(ours) - {"LGBM_GetLastError",
                                             "LGBM_SetLastError"}
    header = open(os.path.join(os.path.dirname(port_so),
                               capi_build.HEADER_NAME)).read()
    assert all(name in header for name in ours)


def test_datasets(port, jax, data_files, tmp_path):
    X, y = read(data_files["test"])
    for lib in (port, jax):
        train = lib.from_file(data_files["train"])
        assert lib.num("LGBM_DatasetGetNumData", train) == 800
        assert lib.num("LGBM_DatasetGetNumFeature", train) == 6
        for make in (lambda: lib.from_mat(X, y, train),
                     lambda: lib.from_mat(X, y, train, row_major=False,
                                          dtype=F32),
                     lambda: lib.from_csr(X, train),
                     lambda: lib.from_csc(X, train)):
            h = make()
            assert lib.num("LGBM_DatasetGetNumData", h) == 200
            lib("LGBM_DatasetFree", h)
        path = str(tmp_path / ("%s.bin" % id(lib)))
        lib("LGBM_DatasetSaveBinary", train, path.encode())
        again = lib.from_file(path)
        assert lib.num("LGBM_DatasetGetNumData", again) == 800
        lib("LGBM_DatasetFree", again)
        lib("LGBM_DatasetFree", train)


def test_fields_and_names(port, jax, data_files):
    X, y = read(data_files["train"])
    rng = np.random.RandomState(1)
    w = rng.uniform(0.5, 2, len(y)).astype(np.float32)
    init = rng.normal(size=len(y))
    group = np.asarray([300, 500], np.int32)
    got = {}
    for key, lib in (("port", port), ("jax", jax)):
        h = lib.from_mat(X, y)
        lib.set_field(h, "weight", w)
        lib.set_field(h, "init_score", init)
        lib.set_field(h, "group", group)
        fields = {name: lib.get_field(h, name)
                  for name in ("label", "weight", "init_score", "group")}
        # the buffers stay valid in the handle after further calls
        lib.num("LGBM_DatasetGetNumData", h)
        names = [("f%d" % i).encode() for i in range(6)]
        lib("LGBM_DatasetSetFeatureNames", h, c_array(ctypes.c_char_p, names),
            6)
        fields["names"] = lib.names("LGBM_DatasetGetFeatureNames", h, 6)
        got[key] = fields
        lib("LGBM_DatasetFree", h)
    for name in ("label", "weight", "init_score", "group"):
        np.testing.assert_array_equal(got["port"][name], got["jax"][name])
    np.testing.assert_array_equal(got["port"]["group"], [0, 300, 800])
    np.testing.assert_array_equal(got["port"]["label"], y.astype(np.float32))
    assert got["port"]["names"] == got["jax"]["names"] == \
        ["f%d" % i for i in range(6)]


def test_streaming_push_equals_matrix(port, jax, data_files):
    X, y = read(data_files["train"])
    Xt, yt = read(data_files["test"])
    texts = {}
    for key, lib in (("port", port), ("jax", jax)):
        train = lib.from_mat(X, y)
        pushed = ctypes.c_void_p()
        lib("LGBM_DatasetCreateByReference", train, ctypes.c_int64(200),
            ctypes.byref(pushed))
        for lo in (0, 120):
            part = np.ascontiguousarray(Xt[lo:lo + 120 if lo == 0 else 200])
            lib("LGBM_DatasetPushRows", pushed, ptr(part), F64,
                part.shape[0], part.shape[1], lo)
        lib.set_field(pushed, "label", yt.astype(np.float32))
        b = lib.booster(train, valid=[pushed])
        lib.update(b, 3)
        texts[key] = (lib.eval(b, 1), lib.model(b))
    np.testing.assert_allclose(texts["port"][0], texts["jax"][0], rtol=0,
                               atol=1e-6)
    assert_same_model(texts["port"][1], texts["jax"][1], 800)


@pytest.fixture(scope="module")
def trained(port, jax, data_files, tmp_path_factory):
    """tests/test_c_api.py's booster sequence through both libraries:
    20 iterations with the held-out file as a validation set, the AUC of
    every iteration, the model saved to a file and loaded back."""
    X, y = read(data_files["train"])
    Xt, yt = read(data_files["test"])
    out = tmp_path_factory.mktemp("capi_models")
    res = {}
    for key, lib in (("port", port), ("jax", jax)):
        train = lib.from_mat(X, y)
        test = lib.from_mat(Xt, yt, train)
        b = lib.booster(train, valid=[test])
        aucs = []
        for _ in range(20):
            lib.update(b)
            aucs.append(lib.eval(b, 1))
        path = str(out / ("%s.txt" % key))
        lib("LGBM_BoosterSaveModel", b, 0, -1, path.encode())
        loaded, iters = ctypes.c_void_p(), ctypes.c_int()
        lib("LGBM_BoosterCreateFromModelfile", path.encode(),
            ctypes.byref(iters), ctypes.byref(loaded))
        assert iters.value == 20
        res[key] = dict(lib=lib, booster=b, loaded=loaded, train=train,
                        test=test, aucs=np.concatenate(aucs),
                        text=open(path).read())
    # the same training through the port's Python API
    res["python"] = P.train(
        {"objective": "binary", "metric": "auc", "num_leaves": 15,
         "verbosity": -1}, P.Dataset(X, y, params={"max_bin": 63}),
        num_boost_round=20, verbose_eval=False, device="cpu")
    res["equal_trees"] = assert_same_model(res["port"]["text"],
                                           res["jax"]["text"], 800)
    return res


def cut(text):
    return text[:text.index("\nparameters:")]


def test_train_eval_save_load(trained, data_files):
    """The C ABI trains what the port's Python API trains, byte for byte,
    and the JAX library's trees up to a near tie; the AUC of every
    iteration equal to 1e-6 while the trees are, within ``AUC_BUDGET``
    after."""
    p, j = trained["port"], trained["jax"]
    assert cut(p["text"]) == cut(trained["python"].model_to_string())
    k = trained["equal_trees"]
    np.testing.assert_allclose(p["aucs"][:k], j["aucs"][:k], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(p["aucs"], j["aucs"], rtol=0, atol=AUC_BUDGET)
    assert p["aucs"][-1] > 0.7
    lib = p["lib"]
    assert lib.num("LGBM_BoosterGetCurrentIteration", p["booster"]) == 20
    assert lib.num("LGBM_BoosterGetNumClasses", p["booster"]) == 1
    assert lib.num("LGBM_BoosterNumModelPerIteration", p["booster"]) == 1
    assert lib.num("LGBM_BoosterNumberOfTotalModel", p["booster"]) == 20
    assert lib.num("LGBM_BoosterGetEvalCounts", p["booster"]) == 1
    assert lib.names("LGBM_BoosterGetEvalNames", p["booster"], 1) == \
        j["lib"].names("LGBM_BoosterGetEvalNames", j["booster"], 1) == \
        ["auc"]
    assert lib.names("LGBM_BoosterGetFeatureNames", p["loaded"], 6) == \
        j["lib"].names("LGBM_BoosterGetFeatureNames", j["loaded"], 6)
    assert cut(lib.model(p["loaded"])) == cut(p["text"])
    assert sorted(lib.dump(p["booster"])) == sorted(
        j["lib"].dump(j["booster"]))


@pytest.mark.parametrize("ptype", [0, 1, 2, 3],
                         ids=["normal", "raw", "leaf", "contrib"])
def test_predict_types(trained, data_files, ptype):
    """The four predict types: equal to the port's Python API on the whole
    model, and to the JAX library's over the trees the two hold equal
    (within 1e-5; leaf indices equal)."""
    Xt, _ = read(data_files["test"])
    p, j = trained["port"], trained["jax"]
    ours = p["lib"].predict(p["loaded"], Xt, ptype)
    kw = [{}, dict(raw_score=True), dict(pred_leaf=True),
          dict(pred_contrib=True)][ptype]
    python = trained["python"].predict(Xt, **kw)
    np.testing.assert_array_equal(ours, np.asarray(python).reshape(
        ours.shape))
    # the booster that trained predicts as the one loaded from its file
    np.testing.assert_array_equal(p["lib"].predict(p["booster"], Xt, ptype),
                                  ours)
    k = trained["equal_trees"]
    ours = p["lib"].predict(p["loaded"], Xt, ptype, k)
    theirs = j["lib"].predict(j["loaded"], Xt, ptype, k)
    assert ours.shape == theirs.shape
    if ptype == 2:
        np.testing.assert_array_equal(ours, theirs)
    else:
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)


def test_predict_other_inputs(trained, data_files, tmp_path):
    Xt, _ = read(data_files["test"])
    p = trained["port"]
    lib, b = p["lib"], p["loaded"]
    want = lib.predict(b, Xt, 1)[:, 0]
    # CSR, CSC, one row, an array of row pointers, and a file
    indptr, indices, data = dense_to_csr(Xt)
    out, n = np.zeros(len(Xt)), ctypes.c_int64()
    cout = out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    lib("LGBM_BoosterPredictForCSR", b, ptr(indptr), I64, ptr(indices),
        ptr(data), F64, ctypes.c_int64(len(indptr)),
        ctypes.c_int64(len(data)), ctypes.c_int64(6), 1, -1, b"",
        ctypes.byref(n), cout)
    np.testing.assert_array_equal(out, want)
    col_ptr, cidx, cdata = dense_to_csr(Xt.T)
    lib("LGBM_BoosterPredictForCSC", b, ptr(col_ptr), I64, ptr(cidx),
        ptr(cdata), F64, ctypes.c_int64(len(col_ptr)),
        ctypes.c_int64(len(cdata)), ctypes.c_int64(len(Xt)), 1, -1, b"",
        ctypes.byref(n), cout)
    np.testing.assert_array_equal(out, want)
    row = np.ascontiguousarray(Xt[3])
    one = np.zeros(1)
    lib("LGBM_BoosterPredictForMatSingleRow", b, ptr(row), F64, 6, 1, 1, -1,
        b"", ctypes.byref(n), one.ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)))
    np.testing.assert_allclose(one[0], want[3], rtol=0, atol=1e-12)
    rows = [np.ascontiguousarray(r) for r in Xt[:7]]
    ptrs = (ctypes.c_void_p * 7)(*[r.ctypes.data for r in rows])
    seven = np.zeros(7)
    lib("LGBM_BoosterPredictForMats", b, ptrs, F64, 7, 6, 1, -1, b"",
        ctypes.byref(n), seven.ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)))
    np.testing.assert_allclose(seven, want[:7], rtol=0, atol=1e-12)
    result = str(tmp_path / "preb.txt")
    lib("LGBM_BoosterPredictForFile", b, data_files["test"].encode(), 0, 0,
        25, b"", result.encode())
    np.testing.assert_allclose(np.loadtxt(result), lib.predict(b, Xt, 0)[:, 0],
                               rtol=1e-12)
    # start_iteration, num_iteration and prediction early stop
    part = lib.predict(b, Xt, 1, 5, b"start_iteration=3")
    theirs = trained["jax"]["lib"].predict(trained["jax"]["loaded"], Xt, 1,
                                           5, b"start_iteration=3")
    np.testing.assert_allclose(part, theirs, rtol=0, atol=1e-5)
    es = lib.predict(b, Xt, 0, -1, b"pred_early_stop=true "
                     b"pred_early_stop_freq=5 pred_early_stop_margin=1.5")
    es_jax = trained["jax"]["lib"].predict(
        trained["jax"]["loaded"], Xt, 0, -1, b"pred_early_stop=true "
        b"pred_early_stop_freq=5 pred_early_stop_margin=1.5")
    np.testing.assert_allclose(es, es_jax, rtol=0, atol=1e-5)


def test_train_scores_and_importance(trained):
    p, j = trained["port"], trained["jax"]
    got = {}
    for key, r in (("port", p), ("jax", j)):
        lib, b = r["lib"], r["booster"]
        for idx in (0, 1):
            want = ctypes.c_int64()
            lib("LGBM_BoosterGetNumPredict", b, idx, ctypes.byref(want))
            out = np.zeros(want.value)
            n = ctypes.c_int64()
            lib("LGBM_BoosterGetPredict", b, idx, ctypes.byref(n),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            got[key, idx] = out
        imp = np.zeros(6)
        lib("LGBM_BoosterFeatureImportance", b, -1, 0,
            imp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        got[key, "imp"] = imp
    for idx in (0, 1):
        assert got["port", idx].shape == got["jax", idx].shape
        np.testing.assert_allclose(got["port", idx], got["jax", idx], rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(got["port", "imp"], got["jax", "imp"])


def test_merge_shuffle_leaf_value_refit_rollback(port, jax, data_files):
    """Model surgery through both libraries, step by step."""
    X, y = read(data_files["train"])
    texts = {}
    for key, lib in (("port", port), ("jax", jax)):
        train = lib.from_mat(X, y)
        a = lib.booster(train, b"objective=binary num_leaves=7 verbosity=-1")
        lib.update(a, 4)
        other = lib.booster(train, b"objective=binary num_leaves=5 "
                                   b"learning_rate=0.3 verbosity=-1")
        lib.update(other, 3)
        lib("LGBM_BoosterMerge", a, other)
        merged = lib.model(a)
        other_text = lib.model(other)
        assert lib.num("LGBM_BoosterNumberOfTotalModel", a) == 7
        lib("LGBM_BoosterShuffleModels", a, 1, 6)
        shuffled = lib.model(a)
        lib("LGBM_BoosterShuffleModels", a, 0, 0)  # end <= 0: the last
        shuffled2 = lib.model(a)
        v = lib.leaf(a, 2, 1)
        lib("LGBM_BoosterSetLeafValue", a, 2, 1, ctypes.c_double(v + 0.25))
        assert lib.leaf(a, 2, 1) == v + 0.25
        leaf_set = lib.model(a)
        # the merged-in booster kept its own leaf values (deep copies)
        assert lib.model(other) == other_text
        # refit the first booster's trees on its leaf indices
        leaves = lib.predict(a, X, 2).astype(np.int32)
        lib("LGBM_BoosterRefit", a, ptr(np.ascontiguousarray(leaves)),
            leaves.shape[0], leaves.shape[1])
        refit = lib.model(a)
        c = lib.booster(train, b"objective=binary num_leaves=7 "
                               b"verbosity=-1")
        lib.update(c, 5)
        lib("LGBM_BoosterRollbackOneIter", c)
        assert lib.num("LGBM_BoosterGetCurrentIteration", c) == 4
        lib.update(c)
        rolled = lib.model(c)
        texts[key] = dict(merged=merged, shuffled=shuffled,
                          shuffled2=shuffled2, leaf_set=leaf_set,
                          refit=refit, rolled=rolled,
                          other=lib.model(other))
    for step in ("merged", "shuffled", "shuffled2", "leaf_set", "refit",
                 "rolled", "other"):
        assert_same_model(texts["port"][step], texts["jax"][step], 800)
    # the shuffle moved trees, and the same ones in both libraries
    assert texts["port"]["shuffled"] != texts["port"]["merged"]
    order = [t.num_leaves for t in trees(texts["port"]["shuffled"])]
    assert order == [t.num_leaves for t in trees(texts["jax"]["shuffled"])]
    assert sorted(order) == sorted(
        t.num_leaves for t in trees(texts["port"]["merged"]))


def test_custom_gradients_reset_and_subset(port, jax, data_files):
    X, y = read(data_files["train"])
    texts = {}
    for key, lib in (("port", port), ("jax", jax)):
        train = lib.from_mat(X, y)
        idx = np.arange(0, 800, 2, dtype=np.int32)
        sub = ctypes.c_void_p()
        lib("LGBM_DatasetGetSubset", train, ptr(idx), len(idx), DS_PARAMS,
            ctypes.byref(sub))
        assert lib.num("LGBM_DatasetGetNumData", sub) == 400
        b = lib.booster(sub, b"objective=binary num_leaves=7 verbosity=-1")
        lib.update(b, 2)
        lib("LGBM_BoosterResetParameter", b, b"learning_rate=0.05")
        p = 1 / (1 + np.exp(-0.3 * (y[idx] - 0.5)))
        g = (p - y[idx]).astype(np.float32)
        h = (p * (1 - p)).astype(np.float32)
        fin = ctypes.c_int()
        lib("LGBM_BoosterUpdateOneIterCustom", b, ptr(g), ptr(h),
            ctypes.byref(fin))
        texts[key] = lib.model(b)
    assert_same_model(texts["port"], texts["jax"], 400)


def test_checkpoint_resume(port, jax, data_files, tmp_path):
    """SaveCheckpoint after 3 iterations, resume in a new booster, 3 more:
    the uninterrupted 6 iterations' model, in both libraries."""
    X, y = read(data_files["train"])
    Xt, yt = read(data_files["test"])
    texts = {}
    for key, lib in (("port", port), ("jax", jax)):
        params = b"objective=binary num_leaves=15 bagging_fraction=0.8 " \
                 b"bagging_freq=2 verbosity=-1"
        train = lib.from_mat(X, y)
        full = lib.booster(train, params)
        lib.update(full, 6)
        prefix = str(tmp_path / key / "ck").encode()
        os.makedirs(str(tmp_path / key))
        first = lib.booster(train, params)
        lib.update(first, 3)
        lib("LGBM_BoosterSaveCheckpoint", first, prefix)
        again = lib.booster(train, params)
        it = ctypes.c_int()
        lib("LGBM_BoosterResumeFromCheckpoint", again, prefix,
            ctypes.byref(it))
        assert it.value == 3
        lib.update(again, 3)
        assert lib.model(again) == lib.model(full)
        texts[key] = lib.model(again)
    assert_same_model(texts["port"], texts["jax"], 800)


def test_r_glue_sequence(port):
    """tests/test_r_glue_sequence.py's call order (column-major matrices,
    f32 labels, size-then-fill model strings) against the port's
    library."""
    lib = port.lib
    rng = np.random.RandomState(0)
    n, f = 600, 5
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + X[:, 1] ** 2 > 0.5).astype(np.float64)
    colmajor = np.asfortranarray(X)
    ds = ctypes.c_void_p()
    assert lib.LGBM_DatasetCreateFromMat(
        colmajor.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(1),
        ctypes.c_int32(n), ctypes.c_int32(f), ctypes.c_int(0),
        b"max_bin=63", None, ctypes.byref(ds)) == 0, port.error()
    lab = y.astype(np.float32)
    assert lib.LGBM_DatasetSetField(
        ds, b"label", lab.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(n), ctypes.c_int(0)) == 0
    booster = ctypes.c_void_p()
    assert lib.LGBM_BoosterCreate(
        ds, b"objective=binary num_leaves=15 learning_rate=0.2 "
            b"metric=binary_logloss", ctypes.byref(booster)) == 0
    vds = ctypes.c_void_p()
    assert lib.LGBM_DatasetCreateFromMat(
        colmajor.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(1),
        ctypes.c_int32(n), ctypes.c_int32(f), ctypes.c_int(0),
        b"max_bin=63", ds, ctypes.byref(vds)) == 0
    assert lib.LGBM_DatasetSetField(
        vds, b"label", lab.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(n), ctypes.c_int(0)) == 0
    assert lib.LGBM_BoosterAddValidData(booster, vds) == 0
    fin = ctypes.c_int(0)
    for _ in range(10):
        assert lib.LGBM_BoosterUpdateOneIter(booster, ctypes.byref(fin)) == 0
    neval = ctypes.c_int(0)
    assert lib.LGBM_BoosterGetEvalCounts(booster, ctypes.byref(neval)) == 0
    out = (ctypes.c_double * max(neval.value, 1))()
    got = ctypes.c_int(0)
    assert lib.LGBM_BoosterGetEval(booster, 1, ctypes.byref(got), out) == 0
    assert got.value == neval.value and out[0] > 0

    def predict(ptype):
        want = ctypes.c_int64(0)
        assert lib.LGBM_BoosterCalcNumPredict(
            booster, ctypes.c_int(n), ctypes.c_int(ptype), ctypes.c_int(-1),
            ctypes.byref(want)) == 0
        res = (ctypes.c_double * want.value)()
        out_len = ctypes.c_int64(0)
        assert lib.LGBM_BoosterPredictForMat(
            booster, colmajor.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(1), ctypes.c_int32(n), ctypes.c_int32(f),
            ctypes.c_int(0), ctypes.c_int(ptype), ctypes.c_int(-1), b"",
            ctypes.byref(out_len), res) == 0
        return np.asarray(res).reshape(n, -1)

    prob = predict(0)[:, 0]
    raw = predict(1)[:, 0]
    contrib = predict(3)
    assert contrib.shape == (n, f + 1)
    assert np.mean((prob > 0.5) == (y > 0.5)) > 0.8
    assert np.corrcoef(prob, raw)[0, 1] > 0.99
    np.testing.assert_allclose(contrib.sum(axis=1), raw, rtol=1e-3,
                               atol=1e-3)
    out_len = ctypes.c_int64(0)
    assert lib.LGBM_BoosterSaveModelToString(
        booster, 0, -1, ctypes.c_int64(0), ctypes.byref(out_len), None) == 0
    buf = ctypes.create_string_buffer(out_len.value + 1)
    assert lib.LGBM_BoosterSaveModelToString(
        booster, 0, -1, ctypes.c_int64(out_len.value + 1),
        ctypes.byref(out_len), buf) == 0
    model_str = buf.value
    assert b"Tree=0" in model_str
    iters = ctypes.c_int(0)
    b2 = ctypes.c_void_p()
    assert lib.LGBM_BoosterLoadModelFromString(
        model_str, ctypes.byref(iters), ctypes.byref(b2)) == 0
    assert iters.value == 10
    nfeat = ctypes.c_int(0)
    assert lib.LGBM_BoosterGetNumFeature(booster, ctypes.byref(nfeat)) == 0
    imp = (ctypes.c_double * nfeat.value)()
    assert lib.LGBM_BoosterFeatureImportance(booster, -1, 1, imp) == 0
    assert np.argmax(np.asarray(imp)) in (0, 1)
    for h, free in ((b2, "LGBM_BoosterFree"), (booster, "LGBM_BoosterFree"),
                    (vds, "LGBM_DatasetFree"), (ds, "LGBM_DatasetFree")):
        assert getattr(lib, free)(h) == 0


GET_ROW = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int32),
                           ctypes.POINTER(ctypes.c_double))


def test_csr_row_callback(port, data_files):
    """LGBM_DatasetCreateFromCSRFunc calls a C row function back: the same
    dataset, and the same model, as LGBM_DatasetCreateFromCSR."""
    X, y = read(data_files["train"])
    calls = []

    def get_row(i, indices, values):
        calls.append(i)
        nz = np.nonzero(X[i])[0]
        for k, j in enumerate(nz):
            indices[k] = int(j)
            values[k] = float(X[i, j])
        return len(nz)

    cb = GET_ROW(get_row)
    h = ctypes.c_void_p()
    port("LGBM_DatasetCreateFromCSRFunc", ctypes.cast(cb, ctypes.c_void_p),
         len(X), ctypes.c_int64(6), DS_PARAMS, None, ctypes.byref(h))
    assert calls == list(range(len(X)))
    port.set_field(h, "label", y.astype(np.float32))
    direct = port.from_csr(X)
    port.set_field(direct, "label", y.astype(np.float32))
    texts = []
    for ds in (h, direct):
        b = port.booster(ds, b"objective=binary num_leaves=7 verbosity=-1")
        port.update(b, 2)
        texts.append(port.model(b))
    assert texts[0] == texts[1]


def test_error_protocol_and_refusals(port):
    lib = port.lib
    out = ctypes.c_void_p()
    assert lib.LGBM_BoosterCreate(ctypes.c_void_p(987654), b"",
                                  ctypes.byref(out)) == -1
    assert "Invalid handle" in port.error()
    lib.LGBM_SetLastError(b"set by the host")
    assert port.error() == "set by the host"
    # the telemetry entries drive the port's obs plane (an in-memory run)
    count = ctypes.c_int64(-1)
    assert lib.LGBM_TelemetryRecompileCount(ctypes.byref(count)) == 0
    assert count.value >= 0
    assert lib.LGBM_TelemetryConfigure(b"", 1) == 0
    need = ctypes.c_int64(0)
    assert lib.LGBM_TelemetrySummary(0, ctypes.byref(need), None) == 0
    buf = ctypes.create_string_buffer(need.value)
    assert lib.LGBM_TelemetrySummary(need.value, ctypes.byref(need),
                                     buf) == 0
    assert json.loads(buf.value.decode())["metric"] == "telemetry_run"
    assert lib.LGBM_TelemetryDisable() == 0
    assert lib.LGBM_TelemetrySummary(need.value, ctypes.byref(need),
                                     buf) == 0
    assert need.value == 1 and buf.value == b""
    assert lib.LGBM_NetworkInit(b"127.0.0.1:1234", 1234, 120, 1) == 0
    assert lib.LGBM_NetworkFree() == 0
    assert lib.LGBM_NetworkInitWithFunctions(1, 0, None, None) == 0
    count = ctypes.c_int64(-1)
    assert lib.LGBM_PredictFallbackCount(ctypes.byref(count)) == 0
    assert count.value == 0
    with pytest.raises(ValueError, match="LIGHTGBM_TPU_TORCH_DEVICE"):
        c_api._device_setting("gpu")


NO_CUDA_CHILD = """
import ctypes, os, sys
import torch
torch.cuda.is_available = lambda: False
lib = ctypes.CDLL(sys.argv[1])
lib.LGBM_GetLastError.restype = ctypes.c_char_p
out = ctypes.c_void_p()
rc = lib.LGBM_BoosterCreate(None, b"objective=binary", ctypes.byref(out))
print(rc, lib.LGBM_GetLastError().decode())
X = (ctypes.c_double * 6)()
rc = lib.LGBM_DatasetCreateFromMat(X, 1, 3, 2, 1, b"", None,
                                   ctypes.byref(out))
print(rc, lib.LGBM_GetLastError().decode())
"""


@pytest.mark.parametrize("setting", [None, "gpu"], ids=["unset", "invalid"])
def test_device_rule_without_cuda(port_so, setting):
    """Without CUDA and without the variable, creating a booster or a
    dataset returns -1 naming the variable; an invalid value is an error
    too.  Nothing falls back to the CPU."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop(c_api.DEVICE_ENV, None)
    if setting is not None:
        env[c_api.DEVICE_ENV] = setting
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(
        NO_CUDA_CHILD), port_so], env=env, capture_output=True, text=True,
        timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()[-2:]
    for line in lines:
        rc, msg = line.split(" ", 1)
        assert rc == "-1"
        if setting is None:
            assert "CUDA is not available; set LIGHTGBM_TPU_TORCH_DEVICE=cpu" \
                in msg, msg
        else:
            assert "LIGHTGBM_TPU_TORCH_DEVICE must be 'cuda' or 'cpu'" in msg
