"""The kernel planner: one typed :class:`Plan` of the port's dispatch choices.

The counterpart of ``lightgbm_tpu/plan/planner.py`` (:1-231).
:class:`ShapeClass` and :func:`plan_key` are the JAX package's letter for
letter (planner.py:39-108), so a key reads the same in both packages.  The
JAX ``Plan`` describes Pallas grids the port does not have (bucket ladders,
the factored layout, VMEM budgets); the port's :class:`Plan` holds its own
dispatch choices instead:

- ``part_block_bytes``: row bytes a block of the split pass's count and
  scatter kernels takes (``core/partition.py`` ``part_tile_rows``, whose
  tile is this over the row width, clamped to [32, 2048] rows);
- ``int_fill_blocks``: the blocks the integer histogram kernel's grid aims
  at (``core/histogram.py`` ``int_hist_grid``, and a level pass's share);
- ``walk_temp_bytes``: the [rows, trees] temporaries one tree block of the
  predict walk may hold (``core/predict.py`` ``_Stacked.block_size``);
- ``predict_buckets``: the serving tier's row ladder
  (``core/predict_fused.py`` ``PREDICT_BUCKETS``);
- ``provenance``: analytic | tuned | pinned.

No field changes a result's bits: the split pass's partition is stable and
its child histogram's f64 segments come from the window's rows
(``_segments``), never from the tile; integer sums are exact whatever the
grid; the walk adds one tree at a time in tree order whatever the block;
the ladder pads rows.  The exact histogram's segment rule is deliberately
outside the plan: it fixes the f64 summation order.

:func:`analytic_plan` reproduces the constants the sites used before the
planner, byte for byte.  Callers go through ``plan.state``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

from . import device_specs

# bump when Plan fields or their meaning change: cache entries of another
# version fall back to analytic (plan/cache.py)
PLAN_SCHEMA_VERSION = 1

PROVENANCES = ("analytic", "tuned", "pinned")

# the analytic constants of the four sites
PART_BLOCK_BYTES = 128 << 10
WALK_TEMP_BYTES = 1 << 31
PREDICT_BUCKETS = (128, 1024, 8192, 65536, 524288)
# split-pass tiles allowed (kPartMaxTile in csrc/part_common.cuh), checked
# at the narrowest row store (W = 128 bytes)
PART_TILE_MIN, PART_TILE_MAX = 32, 2048
NARROWEST_ROW = 128


class ShapeClass(NamedTuple):
    """The planning key (planner.py:39-58 of the JAX package).  ``n_rows``
    stays exact; :func:`plan_key` buckets it to a power of two."""
    n_rows: int
    num_features: int
    num_bins: int          # kernel histogram block (power of two)
    bpc: int               # bytes per bin column (1 = u8, 2 = u16)
    packed: bool           # 4-bit nibble packing
    num_class: int
    device_kind: str
    quantized: bool = False


class Plan(NamedTuple):
    """One plan covering the port's four dispatch sites."""
    part_block_bytes: int     # split pass: row bytes a block
    int_fill_blocks: int      # integer histogram: target blocks
    walk_temp_bytes: int      # predict walk: temporaries a tree block
    predict_buckets: Tuple    # serving row ladder
    provenance: str           # analytic | tuned | pinned


def shape_class(n_rows: int, num_features: int, num_bins: int, *,
                bpc: int = 1, packed: bool = False, num_class: int = 1,
                device_kind: Optional[str] = None,
                quantized: bool = False) -> ShapeClass:
    """Normalize raw shape facts into the planning key."""
    if device_kind is None:
        device_kind = device_specs.current_device_kind()
    return ShapeClass(int(n_rows), int(num_features), int(num_bins),
                      int(bpc), bool(packed), int(num_class),
                      str(device_kind).lower(), bool(quantized))


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def plan_key(sc: ShapeClass) -> str:
    """Cache key of a shape class: rows bucketed to their power of two."""
    key = "n%d|f%d|b%d|bpc%d|pk%d|k%d|%s" % (
        _pow2_ceil(max(sc.n_rows, 1)), sc.num_features, sc.num_bins,
        sc.bpc, int(sc.packed), sc.num_class, sc.device_kind or "unknown")
    if getattr(sc, "quantized", False):
        key += "|q1"
    return key


def row_width(sc: ShapeClass) -> int:
    """The row store's width W of ``sc`` (``tree_learner.row_layout``
    without lazy CEGB bits)."""
    from ..core.tree_learner import row_layout
    if sc.packed:
        return row_layout((sc.num_features + 1) // 2, 1).W
    return row_layout(sc.num_features, sc.bpc).W


def part_tile(block_bytes: int, width: int) -> int:
    """Rows a block of the split pass takes at row width ``width``."""
    return max(PART_TILE_MIN, min(PART_TILE_MAX, int(block_bytes) // width))


def analytic_plan(sc: Optional[ShapeClass] = None) -> Plan:
    """The constants the four sites used before the planner (golden-pinned
    by tests/test_torch_plan.py); the same for every shape class."""
    del sc
    return Plan(part_block_bytes=PART_BLOCK_BYTES,
                int_fill_blocks=device_specs.INT_FILL_BLOCKS,
                walk_temp_bytes=WALK_TEMP_BYTES,
                predict_buckets=PREDICT_BUCKETS,
                provenance="analytic")


def validate_plan(plan: Plan) -> None:
    """Raise ``ValueError`` unless ``plan`` is a valid dispatch shape: the
    gate between a cache entry and the kernels."""
    if plan.provenance not in PROVENANCES:
        raise ValueError("unknown plan provenance %r" % (plan.provenance,))
    tile = int(plan.part_block_bytes) // NARROWEST_ROW
    if not PART_TILE_MIN <= tile <= PART_TILE_MAX:
        raise ValueError("part_block_bytes %d gives a %d-row tile at W = %d,"
                         " outside [%d, %d]"
                         % (plan.part_block_bytes, tile, NARROWEST_ROW,
                            PART_TILE_MIN, PART_TILE_MAX))
    if int(plan.int_fill_blocks) < 1:
        raise ValueError("int_fill_blocks must be >= 1")
    if int(plan.walk_temp_bytes) <= 0:
        raise ValueError("walk_temp_bytes must be positive")
    pb = [int(b) for b in plan.predict_buckets]
    if not pb or pb != sorted(pb) or len(set(pb)) != len(pb) or pb[0] < 1:
        raise ValueError("predict_buckets must be ascending positive sizes")


# ---- JSON-safe dicts for the persisted cache ----

FIELDS = ("part_block_bytes", "int_fill_blocks", "walk_temp_bytes",
          "predict_buckets", "provenance")


def plan_to_dict(plan: Plan) -> dict:
    return {"part_block_bytes": int(plan.part_block_bytes),
            "int_fill_blocks": int(plan.int_fill_blocks),
            "walk_temp_bytes": int(plan.walk_temp_bytes),
            "predict_buckets": [int(b) for b in plan.predict_buckets],
            "provenance": str(plan.provenance)}


def plan_from_dict(doc: dict) -> Plan:
    """The plan of a cache entry; a dict with other fields (a JAX package
    cache's entry) raises ``ValueError`` and is never half-applied."""
    if set(doc) != set(FIELDS):
        raise ValueError("plan fields %s are not the port's %s"
                         % (sorted(doc), sorted(FIELDS)))
    return Plan(part_block_bytes=int(doc["part_block_bytes"]),
                int_fill_blocks=int(doc["int_fill_blocks"]),
                walk_temp_bytes=int(doc["walk_temp_bytes"]),
                predict_buckets=tuple(int(b) for b in doc["predict_buckets"]),
                provenance=str(doc["provenance"]))
