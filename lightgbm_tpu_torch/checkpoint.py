"""Training checkpoints: the full train state, resumable bit for bit.

Counterpart of ``lightgbm_tpu/checkpoint.py`` for the PyTorch port (which
imports nothing of the JAX package), byte-compatible with it: a checkpoint
either package writes, the other reads.  The model string alone loses the
bagging and feature-fraction streams, DART's drop history, the
early-stopping bookkeeping, CEGB's paid costs and the f32 score caches, so a
resume from it diverges; a checkpoint holds all of it:

  line 0   ``LGBMTPU-CKPT v1``
  line 1   JSON header: the trainer's meta (iteration, RNG states, ...), an
           array manifest (name, dtype, shape) and the model's byte length
  ...      raw C-order array bytes in manifest order (train_score, one
           score per validation set, CEGB state when active)
  ...      the model string (the text ``save_model`` writes)
  trailer  ``CRC32 xxxxxxxx nnnnnnnnnnnn`` over everything above

Files are written atomically (``utils.file_io.atomic_write``) at
``<prefix>.ckpt_iter_<n>``, the newest ``snapshot_keep`` kept, and found
newest first with each file's CRC checked: a corrupt or truncated newest
file falls back to the previous good one.  Scores go as binary f32 arrays,
never replayed from the model text: DART's drops make the f32 score sum
depend on its history.  Writes retry transient filesystem faults and fire
the fault hook of ``utils.file_io``.  With a telemetry run active, a write
records ``checkpoint_write_s``, a ``checkpoint_write`` event and span, a
skipped write ``checkpoint_skipped``, a restore ``checkpoint_restore_s``
(checkpoint.py:205-270, :340-362 of the JAX package); the age of the last
write feeds ``/healthz`` (:func:`last_checkpoint_time`).
"""
from __future__ import annotations

import glob
import json
import os
import re
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .utils.file_io import append_crc_trailer, atomic_write, check_crc_trailer
from .utils.log import LightGBMError, Log

CKPT_MAGIC = b"LGBMTPU-CKPT v1"
CKPT_VERSION = 1


class CheckpointError(LightGBMError):
    """A checkpoint failed validation (truncated, corrupt, wrong version) or
    does not fit the booster it is restored into."""


def checkpoint_path(prefix: str, iteration: int) -> str:
    return "%s.ckpt_iter_%d" % (prefix, iteration)


_CKPT_RE = re.compile(r"\.ckpt_iter_(\d+)$")


def list_checkpoints(prefix: str) -> List[Tuple[int, str]]:
    """Every checkpoint file of ``prefix``, newest (highest iteration)
    first."""
    out = []
    for path in glob.glob(glob.escape(prefix) + ".ckpt_iter_*"):
        m = _CKPT_RE.search(path)
        if m:
            out.append((int(m.group(1)), path))
    return sorted(out, reverse=True)


# ---- dataset identity ----

def mapper_digest(bin_mappers, crc: int = 0) -> int:
    """Every bin mapper (bin count, type, missing type, default bin, and
    the upper bounds or the categories) folded into a CRC32
    (checkpoint.py:71-89)."""
    for m in bin_mappers:
        crc = zlib.crc32(np.asarray(
            [int(m.num_bin), int(m.bin_type), int(m.missing_type),
             int(m.default_bin)], dtype=np.int64).tobytes(), crc)
        if m.bin_2_categorical:
            crc = zlib.crc32(np.asarray(m.bin_2_categorical,
                                        dtype=np.int64).tobytes(), crc)
        else:
            crc = zlib.crc32(np.asarray(m.bin_upper_bound,
                                        dtype=np.float64).tobytes(), crc)
    return crc


def dataset_fingerprint(ds) -> Dict[str, Any]:
    """Row and feature counts and a CRC32 of the bin mappers: a resume
    against another dataset is refused rather than training on score caches
    of rows that are not there."""
    crc = zlib.crc32(np.asarray(
        [ds.num_data, ds.num_total_features], dtype=np.int64).tobytes())
    crc = mapper_digest(ds.bin_mappers, crc)
    return {"num_rows": int(ds.num_data),
            "num_features": int(ds.num_total_features),
            "bin_digest": "%08x" % (crc & 0xFFFFFFFF)}


# ---- RNG state (np.random.RandomState <-> JSON) ----

def encode_rng_state(rng: np.random.RandomState) -> Dict[str, Any]:
    name, keys, pos, has_gauss, cached = rng.get_state()
    return {"name": name, "keys": np.asarray(keys, np.uint32).tolist(),
            "pos": int(pos), "has_gauss": int(has_gauss),
            "cached": float(cached)}


def decode_rng_state(d: Dict[str, Any]) -> Tuple:
    return (str(d["name"]), np.asarray(d["keys"], dtype=np.uint32),
            int(d["pos"]), int(d["has_gauss"]), float(d["cached"]))


# ---- serialization ----

def serialize_state(meta: Dict[str, Any], arrays: Dict[str, np.ndarray],
                    model_str: str) -> bytes:
    """One self-validating blob: magic, JSON header, raw arrays, model text
    and the CRC32 + length trailer."""
    model_bytes = model_str.encode("utf-8")
    manifest = []
    chunks = []
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        manifest.append({"name": name, "dtype": a.dtype.str,
                         "shape": list(a.shape)})
        chunks.append(a.tobytes())
    header = json.dumps({"version": CKPT_VERSION, "meta": meta,
                         "arrays": manifest,
                         "model_bytes": len(model_bytes)},
                        separators=(",", ":"))
    blob = b"".join([CKPT_MAGIC, b"\n", header.encode("utf-8"), b"\n"]
                    + chunks + [model_bytes])
    return append_crc_trailer(blob)


def deserialize_state(blob: bytes
                      ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray], str]:
    """Inverse of :func:`serialize_state`; :class:`CheckpointError` names
    the failing section."""
    try:
        payload = check_crc_trailer(blob)
    except ValueError as exc:
        raise CheckpointError(str(exc))
    nl0 = payload.find(b"\n")
    if nl0 < 0 or payload[:nl0] != CKPT_MAGIC:
        raise CheckpointError(
            "not a checkpoint file (magic %r missing)" % CKPT_MAGIC.decode())
    nl1 = payload.find(b"\n", nl0 + 1)
    if nl1 < 0:
        raise CheckpointError("checkpoint header line missing")
    try:
        header = json.loads(payload[nl0 + 1:nl1].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise CheckpointError("checkpoint header unparseable: %s" % exc)
    if int(header.get("version", -1)) != CKPT_VERSION:
        raise CheckpointError("unsupported checkpoint version %r (this "
                              "build reads v%d)" % (header.get("version"),
                                                    CKPT_VERSION))
    off = nl1 + 1
    arrays: Dict[str, np.ndarray] = {}
    for spec in header["arrays"]:
        dt = np.dtype(spec["dtype"])
        shape = tuple(int(s) for s in spec["shape"])
        nbytes = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        if off + nbytes > len(payload):
            raise CheckpointError("checkpoint array %r truncated"
                                  % spec["name"])
        arrays[spec["name"]] = np.frombuffer(
            payload[off:off + nbytes], dtype=dt).reshape(shape)
        off += nbytes
    model_bytes = int(header["model_bytes"])
    if off + model_bytes != len(payload):
        raise CheckpointError(
            "checkpoint model section length mismatch: header says %d bytes, "
            "%d present" % (model_bytes, len(payload) - off))
    return header["meta"], arrays, payload[off:].decode("utf-8")


# ---- save / load / discover ----

# wall-clock time of this process's newest successful checkpoint write:
# /healthz (obs/exporter.py) shows its age
_LAST_WRITE_TS: Optional[float] = None


def last_checkpoint_time() -> Optional[float]:
    """Unix time of this process's newest successful checkpoint write
    (None before the first one)."""
    return _LAST_WRITE_TS


def save_checkpoint(booster, prefix: str, keep: Optional[int] = None) -> str:
    """Capture the booster's train state and write it atomically to
    ``<prefix>.ckpt_iter_<iteration>``; keep the newest ``keep`` files
    (``snapshot_keep`` when None; <= 0 keeps every file)."""
    global _LAST_WRITE_TS
    t0, ts0 = time.perf_counter(), time.time()
    meta, arrays, model_str = booster.capture_train_state()
    path = checkpoint_path(prefix, int(meta["iteration"]))
    blob = serialize_state(meta, arrays, model_str)
    atomic_write(path, blob)
    _LAST_WRITE_TS = time.time()
    Log.info("Wrote checkpoint %s", path)
    from .obs import active as _telemetry_active
    tele = _telemetry_active()
    if tele is not None:
        from .obs import spans
        dt = time.perf_counter() - t0
        tele.histogram("checkpoint_write_s").observe(dt)
        tele.event("checkpoint_write", iteration=int(meta["iteration"]),
                   dt_s=dt, bytes=len(blob))
        spans.record_span(tele, "checkpoint_write", t0=ts0, dur_s=dt,
                          iteration=int(meta["iteration"]))
    if keep is None:
        keep = int(getattr(booster.config, "snapshot_keep", 0))
    prune_checkpoints(prefix, keep)
    return path


def save_checkpoint_best_effort(booster, prefix: str,
                                keep: Optional[int] = None) -> Optional[str]:
    """:func:`save_checkpoint` for a periodic write: an ``OSError`` (a full
    disk) skips this checkpoint with a warning and training goes on; the
    previous checkpoint stays the resume point."""
    try:
        return save_checkpoint(booster, prefix, keep=keep)
    except OSError as exc:
        skip_io_failure("checkpoint %s" % prefix, exc)
        return None


def skip_io_failure(what: str, exc: OSError) -> None:
    """Record a skipped best-effort durability write (checkpoint.py:254-265
    of the JAX package): a warning, and with a telemetry run the
    ``checkpoint_skipped`` counter and event.  The previous checkpoint
    stays the resume point."""
    Log.warning("%s failed (%s); training continues and the previous "
                "checkpoint remains the resume point", what, exc)
    from .obs import active as _telemetry_active
    tele = _telemetry_active()
    if tele is not None:
        tele.counter("checkpoint_skipped").inc()
        tele.event("checkpoint_skipped", what=what, error=str(exc)[:300])


def load_checkpoint(path: str
                    ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray], str]:
    try:
        with open(path, "rb") as fh:
            blob = fh.read()
    except OSError as exc:
        raise CheckpointError("cannot read checkpoint %s: %s" % (path, exc))
    return deserialize_state(blob)


def load_latest_checkpoint(prefix: str):
    """``(meta, arrays, model_str, path)`` of the newest checkpoint of
    ``prefix`` that validates (a corrupt or truncated newer one falls back
    to the previous), or None."""
    for _, path in list_checkpoints(prefix):
        try:
            meta, arrays, model_str = load_checkpoint(path)
        except CheckpointError as exc:
            Log.warning("Checkpoint %s failed validation (%s); falling back "
                        "to the previous one", path, exc)
            continue
        return meta, arrays, model_str, path
    return None


def prune_checkpoints(prefix: str, keep: int) -> None:
    """Keep the newest ``keep`` checkpoints (and ``.snapshot_iter_*`` model
    files) of ``prefix``; ``keep <= 0`` keeps every file."""
    if keep <= 0:
        return
    for _, old_path in list_checkpoints(prefix)[keep:]:
        _unlink_quiet(old_path)
    snaps = []
    for path in glob.glob(glob.escape(prefix) + ".snapshot_iter_*"):
        m = re.search(r"\.snapshot_iter_(\d+)$", path)
        if m:
            snaps.append((int(m.group(1)), path))
    for _, old_path in sorted(snaps, reverse=True)[keep:]:
        _unlink_quiet(old_path)


def cleanup_checkpoints(prefix: str) -> None:
    """Remove every checkpoint of ``prefix`` (after a run completes, so that
    a rerun of the same call trains instead of resuming a finished run);
    ``.snapshot_iter_*`` model files stay."""
    for _, path in list_checkpoints(prefix):
        _unlink_quiet(path)


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def restore_state(booster, state) -> int:
    """Restore a ``(meta, arrays, model_str, path)`` tuple of
    :func:`load_latest_checkpoint` into ``booster``; the restored
    iteration."""
    meta, arrays, model_str, path = state
    t0 = time.perf_counter()
    booster.restore_train_state(meta, arrays, model_str)
    dt = time.perf_counter() - t0
    Log.info("Resumed training from checkpoint %s (iteration %d, %.3f s)",
             path, booster.iter_, dt)
    from .obs import active as _telemetry_active
    tele = _telemetry_active()
    if tele is not None:
        tele.histogram("checkpoint_restore_s").observe(dt)
        tele.event("checkpoint_restore", iteration=int(meta["iteration"]),
                   dt_s=dt, path=path)
    return int(meta["iteration"])


def restore_checkpoint(booster, prefix: str) -> int:
    """Find, validate and restore the newest good checkpoint of ``prefix``;
    the restored iteration, 0 (and the booster untouched) when there is
    none."""
    found = load_latest_checkpoint(prefix)
    if found is None:
        return 0
    return restore_state(booster, found)
