"""Copied from ``lightgbm_tpu/io/sample.py`` for the PyTorch port (which imports nothing of
the JAX package); only imports and device hooks differ.

Deterministic bin-construct sampling for streaming ingestion.

The in-memory loader samples ``bin_construct_sample_cnt`` rows with an
index ``choice`` over the whole matrix; a streaming loader never sees the
whole matrix, and a sharded loader never even sees the whole file.  Both
need the SAME sample the serial in-memory path would draw, or the frozen
``BinMapper``s (and therefore the binned stores, splits, and models)
diverge — the round-21 bit-identity pin.

The trick is a *hash-priority* sample: every global row index ``i`` gets a
64-bit key ``splitmix64(seed, i)`` and the sample is the ``sample_cnt``
rows with the smallest keys (ties broken by index — keys are 64-bit so
ties essentially never happen, but determinism must not hinge on that).
Because the key depends only on ``(seed, i)``:

- it is **chunk-invariant** — feeding rows in any chunking yields the
  same winners, so pass 1 of the streaming loader can keep a bounded
  candidate pool and still land on the exact serial sample;
- it is **stripe-decomposable** — bottom-k of a union is the bottom-k of
  the concatenated per-stripe bottom-ks, so d hosts can each scan only
  their row range and allgather ``O(sample_cnt)`` candidates
  (:func:`encode_payload` / :func:`merge_payloads`) to reconstruct the
  identical global sample on every rank;
- it **degenerates to all rows** when ``n <= sample_cnt`` (every row
  wins), which keeps the small-data behavior identical to a full pass.

The reference's two-phase ``SampleTextDataFromFile`` (dataset_loader.cpp)
uses a sequential reservoir for the same purpose; a reservoir's state
depends on arrival order, which breaks stripe decomposition, so we trade
it for the order-free priority sample.  ``find_bin`` sorts its input, so
any exchangeable ``sample_cnt``-subset is statistically equivalent — only
*which* deterministic subset matters, and from this round on, this one is
the repo-wide discipline.
"""
from __future__ import annotations

import io
from typing import List, Optional, Sequence, Tuple

import numpy as np

_U64 = np.uint64
_GOLDEN = _U64(0x9E3779B97F4A7C15)
_MIX1 = _U64(0xBF58476D1CE4E5B9)
_MIX2 = _U64(0x94D049BB133111EB)


def _splitmix64(z: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (uint64 in, uint64 out)."""
    with np.errstate(over="ignore"):
        z = (z + _GOLDEN).astype(_U64)
        z = ((z ^ (z >> _U64(30))) * _MIX1).astype(_U64)
        z = ((z ^ (z >> _U64(27))) * _MIX2).astype(_U64)
        return (z ^ (z >> _U64(31))).astype(_U64)


def row_keys(indices: np.ndarray, seed: int) -> np.ndarray:
    """Priority key of each global row index under ``seed``."""
    idx = np.asarray(indices, dtype=np.int64).astype(_U64)
    seed_key = _splitmix64(np.asarray([seed], dtype=_U64))[0]
    return _splitmix64(idx ^ seed_key)


class RowSampler:
    """Bottom-``sample_cnt``-by-key sample over globally indexed rows.

    ``observe`` accepts either indices alone (index-only mode: the caller
    re-reads winners later, e.g. ``from_csr``), or indices plus aligned
    row payloads — a ``[m, D]`` float matrix or a 1-D object array of raw
    text lines (the streaming pass-1 keeps LINES and parses only the
    winners, so sampling costs a scan, not a parse).
    """

    def __init__(self, sample_cnt: int, seed: int) -> None:
        self.sample_cnt = max(int(sample_cnt), 1)
        self.seed = int(seed)
        self.total = 0  # rows observed (stripe-local under sharding)
        self._idx = np.zeros(0, dtype=np.int64)
        self._keys = np.zeros(0, dtype=_U64)
        self._rows: Optional[np.ndarray] = None
        self._have_rows = False

    def observe(self, indices: np.ndarray,
                rows: Optional[np.ndarray] = None) -> None:
        idx = np.asarray(indices, dtype=np.int64)
        self.total += len(idx)
        if len(idx) == 0:
            return
        keys = row_keys(idx, self.seed)
        if rows is not None:
            rows = np.asarray(rows)
            self._have_rows = True
        # cheap pre-filter: once the pool is full, only keys at or below
        # the current worst kept key can displace a winner
        if len(self._idx) >= self.sample_cnt:
            thresh = self._keys.max()
            live = keys <= thresh
            if not live.any():
                return
            idx, keys = idx[live], keys[live]
            if rows is not None:
                rows = rows[live]
        all_idx = np.concatenate([self._idx, idx])
        all_keys = np.concatenate([self._keys, keys])
        all_rows = None
        if self._have_rows:
            if self._rows is None:
                all_rows = rows
            elif rows is None:  # mixed feeding is a caller bug
                raise ValueError("RowSampler fed rows then indices only")
            else:
                all_rows = np.concatenate([self._rows, rows])
        if len(all_idx) > self.sample_cnt:
            order = np.lexsort((all_idx, all_keys))[:self.sample_cnt]
            order = order[np.argsort(all_idx[order], kind="stable")]
            all_idx, all_keys = all_idx[order], all_keys[order]
            if all_rows is not None:
                all_rows = all_rows[order]
        else:
            order = np.argsort(all_idx, kind="stable")
            all_idx, all_keys = all_idx[order], all_keys[order]
            if all_rows is not None:
                all_rows = all_rows[order]
        self._idx, self._keys, self._rows = all_idx, all_keys, all_rows

    def result(self) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """``(indices, keys, rows)`` of the winners, ascending by global
        index (``rows`` is None in index-only mode)."""
        return self._idx, self._keys, self._rows


def bottom_k_indices(n: int, sample_cnt: int,
                     seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The whole-data shortcut: ``(indices, keys)`` of the sample the
    chunked/striped machinery above converges to, computed in one shot
    when all ``n`` rows are addressable (the in-memory constructors)."""
    idx = np.arange(int(n), dtype=np.int64)
    keys = row_keys(idx, seed)
    if n > sample_cnt:
        sel = np.lexsort((idx, keys))[:max(int(sample_cnt), 1)]
        sel.sort()
        return idx[sel], keys[sel]
    return idx, keys


def efb_positions(keys: np.ndarray, eff: int) -> np.ndarray:
    """Positions (into the index-ascending sample) of the ``eff``
    smallest-key rows, ascending — the deterministic sub-sample the EFB
    conflict scan uses when the bin sample exceeds its 64Ki budget."""
    k = len(keys)
    if eff >= k:
        return np.arange(k)
    sel = np.argsort(np.asarray(keys, dtype=_U64), kind="stable")[:eff]
    sel.sort()
    return sel


# ---- multi-host candidate exchange (allgather payloads) ----

def encode_payload(idx: np.ndarray, keys: np.ndarray, rows: np.ndarray,
                   total: int, num_cols: int) -> bytes:
    """Serialize one rank's stripe-local winners for the allgather: the
    candidate indices/keys, the PARSED candidate rows ``[m, num_cols]``
    (f64 — lines never cross hosts), the stripe row count, and the
    stripe-local column count (LibSVM stripes can disagree on width)."""
    buf = io.BytesIO()
    np.savez(buf, idx=np.asarray(idx, dtype=np.int64),
             keys=np.asarray(keys, dtype=_U64),
             rows=np.asarray(rows, dtype=np.float64).reshape(
                 len(idx), int(num_cols)),
             total=np.asarray([int(total)], dtype=np.int64),
             num_cols=np.asarray([int(num_cols)], dtype=np.int64))
    return buf.getvalue()


def merge_payloads(parts: Sequence[bytes], sample_cnt: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Fold every rank's payload into the global bottom-k sample.

    Returns ``(idx, keys, rows, total_rows, num_cols)`` with rows
    ascending by global index — byte-identical on every rank, and (by
    stripe decomposition) byte-identical to a serial full scan.  LibSVM
    stripes narrower than the global width are zero-padded: absent
    columns are implicit zeros by the format's contract.
    """
    idxs: List[np.ndarray] = []
    keyss: List[np.ndarray] = []
    rowss: List[np.ndarray] = []
    total = 0
    num_cols = 0
    for blob in parts:
        with np.load(io.BytesIO(blob)) as z:
            idxs.append(z["idx"])
            keyss.append(z["keys"])
            rowss.append(z["rows"])
            total += int(z["total"][0])
            num_cols = max(num_cols, int(z["num_cols"][0]))
    padded = []
    for m in rowss:
        if m.shape[1] < num_cols:
            wide = np.zeros((m.shape[0], num_cols), dtype=np.float64)
            wide[:, :m.shape[1]] = m
            m = wide
        padded.append(m)
    idx = np.concatenate(idxs) if idxs else np.zeros(0, dtype=np.int64)
    keys = np.concatenate(keyss) if keyss else np.zeros(0, dtype=_U64)
    rows = (np.concatenate(padded) if padded
            else np.zeros((0, num_cols), dtype=np.float64))
    k = max(int(sample_cnt), 1)
    if len(idx) > k:
        order = np.lexsort((idx, keys))[:k]
    else:
        order = np.arange(len(idx))
    order = order[np.argsort(idx[order], kind="stable")]
    return idx[order], keys[order], rows[order], total, num_cols
