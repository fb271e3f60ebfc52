"""The cost model's bytes and adds on a hand-worked tree of two splits."""
import numpy as np
import pytest

from harness import cost
from reference.gbdt import Tree

# node 0 sends 30 rows to leaf 0 and 70 to node 1; node 1 sends 50 to leaf 1
# and 20 to leaf 2.  Two features of 4 and 3 bins.
TREE = Tree(feature=np.array([0, 1]), threshold=np.array([0.5, 1.5]),
            left=np.array([~0, ~1]), right=np.array([1, ~2]),
            leaf_value=np.zeros(3), leaf_count=np.array([30.0, 50.0, 20.0]))


def test_tree_work():
    w = cost.tree_work(TREE, 100)
    # routed: 100 rows at the root, 70 at node 1
    assert w["routed"] == 170.0
    # read by histograms: the root's 100, the smaller children 30 and 20
    assert w["hist_rows"] == 150.0
    assert w["histograms"] == 3.0


@pytest.mark.parametrize("precision,row_in", [("exact", 2 + 8),
                                              ("quantized", 2 + 2)])
def test_least_work(precision, row_in):
    got = cost.least_work([TREE], 100, [4, 3], precision)
    hist_out = 2 * 4 * (4 + 3)
    want_bytes = 2 * 170 * (row_in + 4) + 100 * row_in + 3 * hist_out
    assert got["bytes"] == want_bytes
    assert got["adds"] == 2 * 2 * 150
    assert got["seconds"] == max(want_bytes / 3.35e12, 600 / 1.7e13)
