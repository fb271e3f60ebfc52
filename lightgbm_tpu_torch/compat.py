"""Optional-dependency shims (python-package/lightgbm/compat.py).

The sklearn part of ``lightgbm_tpu/compat.py`` for the PyTorch port: with
sklearn the estimators of ``sklearn.py`` stand on its base classes, label
encoder and target check; without it, on the minimal ``get_params`` /
``set_params`` base and label encoder below, the path of a machine without
sklearn (a card machine may have none).  Only ``sklearn.py`` imports this
module.  pandas, matplotlib and graphviz are imported only where they are
used: ``basic.py`` tells a DataFrame by the pandas module already imported,
``plotting.py`` imports matplotlib and graphviz when it draws.  The JAX
module's flags for those three and its ``check_array``/``check_X_y`` shims
have no caller in the port and are left out.
"""
from __future__ import annotations

try:
    from sklearn.base import BaseEstimator as _SKBaseEstimator
    from sklearn.base import ClassifierMixin as _SKClassifierMixin
    from sklearn.base import RegressorMixin as _SKRegressorMixin
    from sklearn.preprocessing import LabelEncoder as _SKLabelEncoder
    from sklearn.utils.multiclass import check_classification_targets
    SKLEARN_INSTALLED = True
    _LGBMModelBase = _SKBaseEstimator
    _LGBMClassifierBase = _SKClassifierMixin
    _LGBMRegressorBase = _SKRegressorMixin
    LGBMLabelEncoder = _SKLabelEncoder
    _LGBMCheckClassificationTargets = check_classification_targets
except ImportError:
    SKLEARN_INSTALLED = False
    import numpy as _np

    class _LGBMModelBase:  # type: ignore[no-redef]
        def get_params(self, deep=True):
            import inspect
            sig = inspect.signature(self.__init__)
            return {k: getattr(self, k) for k in sig.parameters
                    if k not in ("self", "kwargs")}

        def set_params(self, **params):
            for k, v in params.items():
                setattr(self, k, v)
            return self

    class _LGBMClassifierBase:  # type: ignore[no-redef]
        pass

    class _LGBMRegressorBase:  # type: ignore[no-redef]
        pass

    class LGBMLabelEncoder:  # type: ignore[no-redef]
        def fit(self, y):
            self.classes_ = _np.unique(_np.asarray(y))
            return self

        def transform(self, y):
            return _np.searchsorted(self.classes_, _np.asarray(y))

        def fit_transform(self, y):
            return self.fit(y).transform(y)

        def inverse_transform(self, y):
            return self.classes_[_np.asarray(y, dtype=int)]

    def _LGBMCheckClassificationTargets(y):  # type: ignore[no-redef]
        return None
