"""The least time the kernels' work needs on the card, from the trees.

The work of a tree, whatever implements it:

- each split (or level) pass reads and writes each row it routes once: the
  row's bin bytes (``F`` times the bytes of a bin), its g/h pair and a
  4-byte row id.  A row is routed once for each node above its leaf, so a
  tree routes ``sum(leaf rows * leaf depth)`` rows;
- the pass also builds the smaller child's histogram from the rows it
  reads, so those rows are not counted again; it writes the histogram;
- the root histogram reads every row's bin bytes and g/h pair once and
  writes its histogram;
- a histogram is ``2 * sum(bins of each feature)`` f32 sums, and costs
  ``2 * F`` adds a row it reads (the root's rows and the smaller
  children's).

The g/h pair is two f32 (8 bytes) with exact histograms and one byte each
(``hist_precision=quantized``: levels in [-127, 127] and [0, 255]) when
quantized.  The least time is the larger of bytes over the card's memory
bandwidth and adds over its add rate.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the f64 rate without the
# tensor cores (34 TFLOP/s counting a fused multiply-add as two, so 1.7e13
# adds a second; the int32 add rate is about the same)
PEAK_BYTES_PER_S = 3.35e12
PEAK_ADDS_PER_S = 1.7e13
GH_BYTES = {"exact": 8, "quantized": 2}


def subtree_rows(tree, node: int) -> float:
    """Rows under a child pointer (a node id, or ``~leaf``)."""
    if node < 0:
        return float(tree.leaf_count[~node])
    return (subtree_rows(tree, int(tree.left[node]))
            + subtree_rows(tree, int(tree.right[node])))


def tree_work(tree, n_rows: int) -> Dict[str, float]:
    """Rows routed by the passes and rows read by histograms, of a tree
    with ``leaf_count`` (the model text's)."""
    counts = np.asarray(tree.leaf_count, dtype=np.float64)
    routed = float((counts * tree.depths()).sum())
    smaller = sum(min(subtree_rows(tree, int(tree.left[i])),
                      subtree_rows(tree, int(tree.right[i])))
                  for i in range(len(tree.feature)))
    return {"routed": routed, "hist_rows": float(n_rows) + smaller,
            "histograms": 1.0 + len(tree.feature)}


def least_work(trees: Sequence, n_rows: int, num_bins: Sequence[int],
               precision: str, bin_bytes: int = 1) -> Dict[str, float]:
    """Bytes, adds and the least seconds of the kernels that grew
    ``trees``."""
    F = len(num_bins)
    gh = GH_BYTES[precision]
    row_in = F * bin_bytes + gh
    hist_out = 2 * 4 * int(sum(num_bins))
    nbytes = adds = 0.0
    for t in trees:
        w = tree_work(t, n_rows)
        nbytes += (2.0 * w["routed"] * (row_in + 4) + n_rows * row_in
                   + w["histograms"] * hist_out)
        adds += 2.0 * F * w["hist_rows"]
    seconds = max(nbytes / PEAK_BYTES_PER_S, adds / PEAK_ADDS_PER_S)
    return {"bytes": nbytes, "adds": adds, "seconds": seconds}
