"""Split-pass launch accounting: split passes per tree build.

The counterpart of ``lightgbm_tpu/obs/launches.py`` (:1-86).  The JAX
package records the builder's trace-static launch budget per tree (its
leaf-wise ``fori_loop`` always runs L-1 passes, dead ones included).  The
port records what the build dispatched: ``SerialTreeLearner.train`` (and
through it every parallel learner) records each tree's split passes, read
from the tree it built (``TreeArrays.split_passes``): L-1 for a tree of the
device build (num_leaves = L; one ``partition_hist_window`` a step, dead
steps included, as the JAX loop), one ``partition_hist`` a split in the host
loop, one a level for ``tree_grow_mode=level`` (one ``partition_hist_level``
a level).
On the card each pass is one launch of the split-pass kernel, so this count
equals the kernels' own launch counters (``device.launches()["partition"]``
plus ``["partition_level"]``), which the card's path (W1) checks; on the CPU
the same passes run the plain versions and the count is the same.

The counts are attributed per growth mode (``leaf`` / ``level``).  Counting
is always on (one dict update per tree, never per row or split); with a
telemetry run active, launches also bump its ``tree_kernel_launches`` and
``trees_built`` counters.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

_lock = threading.Lock()
_counts: Dict[str, int] = {}
_trees: Dict[str, int] = {}


def record(mode: str, launches_per_tree: int, trees: int = 1) -> None:
    """Record ``trees`` tree builds of ``launches_per_tree`` launches each
    under growth mode ``mode`` ("leaf" / "level")."""
    n = int(launches_per_tree) * int(trees)
    with _lock:
        _counts[mode] = _counts.get(mode, 0) + n
        _trees[mode] = _trees.get(mode, 0) + int(trees)
    from . import active
    tele = active()
    if tele is not None:
        tele.counter("tree_kernel_launches").inc(n)
        tele.counter("trees_built").inc(int(trees))


def counts() -> Dict[str, int]:
    """{mode: total launches} since process start (or the last reset)."""
    with _lock:
        return dict(_counts)


def trees() -> Dict[str, int]:
    """{mode: tree builds} since process start (or the last reset)."""
    with _lock:
        return dict(_trees)


def total(mode: Optional[str] = None) -> int:
    with _lock:
        return sum(n for m, n in _counts.items()
                   if mode is None or m == mode)


def per_tree(mode: Optional[str] = None) -> Optional[float]:
    """Average launches per tree build, the headline the summary shows."""
    with _lock:
        nt = sum(n for m, n in _trees.items() if mode is None or m == mode)
        if not nt:
            return None
        nl = sum(n for m, n in _counts.items() if mode is None or m == mode)
    return nl / nt


def reset() -> None:
    """Zero the counters — pin a loop's launch structure from a clean
    baseline (same idiom as recompile.reset)."""
    with _lock:
        _counts.clear()
        _trees.clear()


def as_flat_dict() -> Dict[str, int]:
    """{mode: launches}, sorted by mode: the summary JSON's form
    (launches.py:83-87 of the JAX package)."""
    with _lock:
        return dict(sorted(_counts.items()))
