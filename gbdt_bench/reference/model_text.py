"""Trees from LightGBM's model text, the public form a trained model takes."""
from __future__ import annotations

from typing import List

import numpy as np

from .gbdt import Tree

K_CATEGORICAL_MASK = 1


def parse_trees(text: str) -> List[Tree]:
    """Every ``Tree=`` block of ``text`` as a :class:`~.gbdt.Tree`; a
    categorical split is refused (the benchmark's data has none)."""
    blocks, cur = [], None
    for line in text.splitlines():
        if line.startswith("Tree="):
            cur = {}
            blocks.append(cur)
        elif line.startswith("end of trees"):
            break
        elif cur is not None and "=" in line:
            k, v = line.split("=", 1)
            cur[k] = v
    trees = []
    for b in blocks:
        nl = int(b["num_leaves"])

        def arr(key, dtype):
            s = b.get(key, "").strip()
            return (np.array(s.split(" "), dtype=np.float64).astype(dtype)
                    if s else np.zeros(0, dtype=dtype))
        dt = arr("decision_type", np.int64)
        if (dt & K_CATEGORICAL_MASK).any():
            raise ValueError("a categorical split in the model")
        trees.append(Tree(
            feature=arr("split_feature", np.int64)[:nl - 1],
            threshold=arr("threshold", np.float64)[:nl - 1],
            left=arr("left_child", np.int64)[:nl - 1],
            right=arr("right_child", np.int64)[:nl - 1],
            leaf_value=arr("leaf_value", np.float64)[:nl],
            leaf_count=arr("leaf_count", np.float64)[:nl]
            if "leaf_count" in b else None))
    return trees
