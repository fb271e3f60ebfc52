"""Multi-process dataset assembly: rank resolution and schema agreement.

Counterpart of ``lightgbm_tpu/parallel/distdata.py``.  The sharded ingest of
``io/loader.py`` (``_load_streaming``) lets each rank read only its row
stripe and exchange the bin-finding samples over one allgather; that is sound
only if every rank then freezes identical bin mappers and EFB groups, since
the parallel learners exchange histograms by position.  This module is the
agreement layer:

- :func:`pod_info`: ``(rank, world size)`` of this process under
  ``torch.distributed`` (the reference's ``Network::rank()`` /
  ``num_machines()``); ``(0, 1)`` when no process group is initialized;
- :func:`schema_digest`: the bin mappers' CRC (``checkpoint.mapper_digest``,
  the one a resume trusts), the EFB group layout and the global row count;
- :func:`verify_schema`: allgathers the digest and fails on the first
  mismatch;
- :func:`stripe_bounds` / :func:`shard_of`: the row-stripe convention
  ``n*r//d .. n*(r+1)//d`` of the loader, and the stamp it leaves.
"""
from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np

from ..utils.log import Log
from .comm import group_rank, group_size


def pod_info() -> Tuple[int, int]:
    """``(rank, world size)`` of this process under ``torch.distributed``;
    ``(0, 1)`` when it is not initialized."""
    return group_rank(), group_size()


def stripe_bounds(num_total: int, rank: int,
                  num_machines: int) -> Tuple[int, int]:
    """Row range ``[begin, end)`` of ``rank``: the balanced stripes the
    serial loader uses for pre_partition=false (dataset_loader.cpp:168), so
    the stripes' union is the serial load."""
    num_total = int(num_total)
    begin = num_total * int(rank) // int(num_machines)
    end = num_total * (int(rank) + 1) // int(num_machines)
    return begin, end


def shard_of(ds) -> Optional[dict]:
    """The shard stamp the loader leaves on a rank's stripe
    (``{rank, num_machines, begin, end, num_total}``), None for a dataset of
    every row."""
    shard = getattr(ds, "shard", None)
    return dict(shard) if shard else None


def schema_digest(ds, total_rows: Optional[int] = None) -> str:
    """Digest of what every rank must agree on before training: the bin
    mappers, the EFB group layout and the global row count (not the local
    ``num_data`` or stripe bounds, which differ by rank)."""
    from ..checkpoint import mapper_digest
    crc = mapper_digest(ds.bin_mappers)
    crc = zlib.crc32(np.asarray(
        [int(ds.num_total_features),
         int(total_rows if total_rows is not None else ds.num_data)],
        dtype=np.int64).tobytes(), crc)
    for g in ds.feature_groups:
        crc = zlib.crc32(np.asarray([-1] + [int(f) for f in g],
                                    dtype=np.int64).tobytes(), crc)
    crc = zlib.crc32(np.asarray(ds.bin_offset,
                                dtype=np.int64).tobytes(), crc)
    return "%08x" % (crc & 0xFFFFFFFF)


def verify_schema(ds, allgather_fn, total_rows: Optional[int] = None) -> str:
    """Allgather :func:`schema_digest` over the ranks and fail on any
    divergence, naming the ranks; returns the agreed digest."""
    digest = schema_digest(ds, total_rows=total_rows)
    parts = [p.decode() for p in allgather_fn(digest.encode())]
    bad = [r for r, d in enumerate(parts) if d != parts[0]]
    if bad:
        Log.fatal("sharded ingest: schema digest mismatch across ranks "
                  "(digests %s; disagreeing ranks %s): all hosts must see "
                  "the same file and config", parts, bad)
    Log.info("sharded ingest: schema digest %s agreed across %d rank(s)",
             digest, len(parts))
    return digest
