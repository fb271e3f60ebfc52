"""Carry the reference's state across to the port.

A GBDT's counterpart of weights is its binned dataset and its trained trees,
so this module moves those two, as plain numpy arrays and text, from the JAX
package's objects into the port's (the port never imports the JAX package;
the caller extracts the numpy state):

- :func:`dataset_from_arrays` builds the port's :class:`BinnedDataset` from
  the reference dataset's ``binned`` matrix, per-feature ``num_bin``,
  missing types, default bins, ``is_categorical`` flags and label, plus
  (optionally) its bin mappers as ``BinMapper.to_dict()`` dicts, which carry
  the real-valued thresholds of the model text.
- :func:`gbdt_from_model_string` loads a reference model string into the
  port's :class:`GBDT`, and :func:`booster_from_model_string` a reference
  ``Booster``'s model string and params into the port's :class:`Booster`
  (which ``engine.train(init_model=...)`` can continue).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .basic import Booster
from .boosting.gbdt import GBDT
from .config import Config
from .device import DeviceLike
from .io.binning import BinMapper, BinType, MissingType
from .io.dataset import BinnedDataset
from .io.metadata import Metadata


def _synthetic_mapper(num_bin: int, missing_type: int, default_bin: int,
                      is_categorical: bool) -> BinMapper:
    """A mapper whose bin i holds the values in (i - 0.5, i + 0.5]: the model
    text then carries ``bin + 0.5`` as each threshold."""
    m = BinMapper()
    m.num_bin = int(num_bin)
    m.is_trivial = num_bin <= 1
    m.missing_type = MissingType(int(missing_type))
    m.default_bin = int(default_bin)
    m.most_freq_bin = int(default_bin)
    if is_categorical:
        m.bin_type = BinType.CATEGORICAL
        m.bin_2_categorical = list(range(num_bin))
        m.categorical_2_bin = {c: c for c in range(num_bin)}
    else:
        m.bin_upper_bound = np.append(np.arange(num_bin - 1) + 0.5, np.inf)
    m.min_val, m.max_val = 0.0, float(num_bin - 1)
    return m


def dataset_from_arrays(binned: np.ndarray, num_bin: Sequence[int],
                        missing_type: Sequence[int],
                        default_bin: Sequence[int],
                        is_categorical: Sequence[bool], label,
                        *, mapper_state: Optional[List[dict]] = None,
                        feature_names: Optional[Sequence[str]] = None
                        ) -> BinnedDataset:
    """The port's dataset from a reference dataset's numpy state.

    ``binned`` is [N, F] u8/u16 with one column per used feature (an
    unbundled store); the per-feature arrays describe those columns.
    ``mapper_state``, when given, is one ``BinMapper.to_dict()`` per ORIGINAL
    feature (trivial ones included) and must agree with the arrays."""
    binned = np.ascontiguousarray(binned)
    n, f = binned.shape
    per = [np.asarray(a).reshape(-1) for a in
           (num_bin, missing_type, default_bin, is_categorical)]
    if any(len(a) != f for a in per):
        raise ValueError("per-feature arrays must have %d entries" % f)
    ds = BinnedDataset()
    if mapper_state is not None:
        ds.bin_mappers = [BinMapper.from_dict(d) for d in mapper_state]
        used = [i for i, m in enumerate(ds.bin_mappers) if not m.is_trivial]
        if len(used) != f:
            raise ValueError("mapper_state has %d used features, binned has "
                             "%d columns" % (len(used), f))
        for j, i in enumerate(used):
            m = ds.bin_mappers[i]
            if (m.num_bin != int(per[0][j])
                    or int(m.missing_type) != int(per[1][j])
                    or m.default_bin != int(per[2][j])
                    or (m.bin_type == BinType.CATEGORICAL) != bool(per[3][j])):
                raise ValueError("mapper_state disagrees with the arrays at "
                                 "feature %d" % i)
    else:
        ds.bin_mappers = [_synthetic_mapper(*(a[j] for a in per))
                          for j in range(f)]
        used = list(range(f))
    ds.num_data = n
    ds.num_total_features = len(ds.bin_mappers)
    ds.used_feature_idx = used
    ds.inner_feature_map = {o: j for j, o in enumerate(used)}
    ds.num_bin_per_feature = [int(v) for v in per[0]]
    ds.feature_names = (list(feature_names) if feature_names is not None
                        else ["Column_%d" % i
                              for i in range(ds.num_total_features)])
    ds.feature_groups = [[j] for j in range(f)]
    ds._assign_group_layout()
    ds.binned = binned
    ds.metadata = Metadata(n)
    ds.metadata.set_label(np.asarray(label))
    return ds


def gbdt_from_model_string(text: str, config: Optional[Config] = None,
                           device: DeviceLike = None) -> GBDT:
    """A reference model string loaded into the port's :class:`GBDT`."""
    booster = GBDT(config or Config(), device=device)
    booster.load_model_from_string(text)
    return booster


def booster_from_model_string(text: str, params: Optional[dict] = None,
                              device: DeviceLike = None) -> Booster:
    """The port's :class:`Booster` of a reference booster's
    ``model_to_string()`` and params."""
    return Booster(params=params, model_str=text, device=device)
