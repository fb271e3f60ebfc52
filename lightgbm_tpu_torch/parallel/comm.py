"""Collectives of the parallel learners over a ``torch.distributed`` group.

The port's counterpart of the XLA collectives that the JAX learners call
under a mesh axis name (``jax.lax.psum``, ``psum_scatter``, ``pmax``,
``all_gather``, lightgbm_tpu/core/tree_learner.py:490-516, :586-627,
lightgbm_tpu/core/quant.py:71-73, lightgbm_tpu/core/split.py:592-600), and of
the reference's socket/MPI ``Network`` layer (src/network/).  Where the JAX
learners are one program over a mesh, the port runs one process per rank
over a process group, and :class:`ProcessComm` is the one place that calls
``torch.distributed``.

Every call is counted by kind: ``calls[kind]``, ``bytes[kind]`` (the bytes
this rank hands the collective) and ``records`` (kind, input shape, output
shape, dtype of the latest calls), which the tests and ``chip_smoke.py``
read in place of the lowered HLO that ``tests/test_comm_contract.py`` reads.

A tensor handed to a backend lives on the device that backend serves: NCCL
takes CUDA tensors, gloo CPU tensors and, for every collective called here,
CUDA tensors too, as ``probes/gloo_cuda.py`` and ``chip_smoke.py``'s path
(V2) found on the card (torch 2.11.0+cu128, one H100), so no payload is
staged through host memory.  A failed collective raises: nothing here
catches it.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

KINDS = ("all_reduce_sum", "all_reduce_max", "reduce_scatter", "all_gather",
         "all_gather_bytes")


class ProcessComm:
    """The collectives of one rank over ``group`` (the default group when
    None), on tensors of ``device`` (CUDA unless the caller asks for the
    CPU: the device rule)."""

    def __init__(self, group=None, device=None) -> None:
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: "
                               "init_process_group first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = torch.device("cuda" if device is None else device)
        self.reset()

    def reset(self) -> None:
        """Set every count to 0."""
        self.calls: Dict[str, int] = {k: 0 for k in KINDS}
        self.bytes: Dict[str, int] = {k: 0 for k in KINDS}
        self.records = collections.deque(maxlen=4096)

    def _note(self, kind: str, t: torch.Tensor, out_shape) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += t.numel() * t.element_size()
        self.records.append((kind, tuple(t.shape), tuple(out_shape),
                             str(t.dtype).replace("torch.", "")))

    def _all_reduce(self, kind: str, t: torch.Tensor, op) -> torch.Tensor:
        # the collective works in place: on a copy, not the caller's tensor
        buf = t.detach().clone(memory_format=torch.contiguous_format)
        self._note(kind, t, t.shape)
        dist.all_reduce(buf, op=op, group=self.group)
        return buf

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (``psum``)."""
        return self._all_reduce("all_reduce_sum", t, dist.ReduceOp.SUM)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``t`` over the ranks (``pmax``)."""
        return self._all_reduce("all_reduce_max", t, dist.ReduceOp.MAX)

    def reduce_scatter_features(self, h: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of histograms ``h`` [..., F, 2, B], of
        which this rank keeps the features ``[r F/d, (r + 1) F/d)``:
        [..., F/d, 2, B] (``psum_scatter(h, scatter_dimension=0,
        tiled=True)``).  F must be a multiple of the group's size."""
        kind = "reduce_scatter"
        F = h.shape[-3]
        if F % self.size:
            raise ValueError("%d features do not split over %d ranks"
                             % (F, self.size))
        parts = [p.contiguous() for p in h.detach().chunk(self.size, dim=-3)]
        out = torch.empty_like(parts[0])
        self._note(kind, h, out.shape)
        dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM,
                            group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t``, stacked in rank order: [d, *t.shape]."""
        kind = "all_gather"
        buf = t.detach().contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        self._note(kind, t, (self.size,) + tuple(t.shape))
        dist.all_gather(parts, buf, group=self.group)
        return torch.stack(parts)

    def all_gather_bytes(self, payload: bytes) -> List[bytes]:
        """Every rank's ``payload``, in rank order: the bytes allgather of
        the distributed loader (``allgather_fn``, lightgbm_tpu/io/
        loader.py:109-125).  Lengths first, then the payloads padded to the
        longest."""
        kind, dev = "all_gather_bytes", self.device
        data = torch.frombuffer(bytearray(payload), dtype=torch.uint8) \
            if payload else torch.zeros(0, dtype=torch.uint8)
        n = torch.tensor([data.numel()], dtype=torch.int64, device=dev)
        lens = [torch.empty_like(n) for _ in range(self.size)]
        dist.all_gather(lens, n, group=self.group)
        width = max(int(x.item()) for x in lens)
        buf = torch.zeros(max(width, 1), dtype=torch.uint8, device=dev)
        buf[:data.numel()] = data.to(dev)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        self._note(kind, buf, (self.size, buf.numel()))
        dist.all_gather(parts, buf, group=self.group)
        return [p[:int(k.item())].cpu().numpy().tobytes()
                for p, k in zip(parts, lens)]

    def summary(self) -> Dict[str, Dict[str, int]]:
        """{kind: {"calls", "bytes"}} of the kinds called since the last
        :meth:`reset`."""
        return {k: {"calls": self.calls[k], "bytes": self.bytes[k]}
                for k in KINDS if self.calls[k]}


def group_size(group=None) -> int:
    """World size of ``group``; 1 when ``torch.distributed`` is not
    initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    """This process's rank in ``group``; 0 when ``torch.distributed`` is not
    initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def default_group(num_ranks: Optional[int] = None):
    """The counterpart of ``default_mesh`` (lightgbm_tpu/parallel/
    learners.py:50-55): the initialized default group (None stands for it
    in ``torch.distributed``), or a new subgroup of its first
    ``num_ranks`` ranks.  ``new_group`` is collective: every rank of the
    default group must call it, also those outside the subgroup, which get
    a group they are not a member of."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("torch.distributed is not initialized: "
                           "init_process_group first")
    world = dist.get_world_size()
    if num_ranks is None or int(num_ranks) >= world:
        return None
    return dist.new_group(list(range(int(num_ranks))))
