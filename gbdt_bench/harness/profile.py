"""The traced window, read from ``torch.profiler``'s raw events.

``Trace`` keeps what the per-layer readers need: every device activity
(kernels, copies, fills) with its name, start and length, and the host
operations, to name what the host was doing while the device sat idle.
Nothing is written to disk.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# the port's own CUDA kernels: the histogram, split-pass and level-pass
# families of lightgbm_tpu_torch/csrc
_PORT = re.compile(r"^(?:void\s+)?(?:\w+::)*(?:hist|part|lvl)_\w*kernel\b")
_COPY = re.compile(r"^(Memcpy|Memset)")


def is_port_kernel(name: str) -> bool:
    return bool(_PORT.match(name))


@dataclass
class Trace:
    # (name, start_ns, duration_ns) of each device activity
    device: List[Tuple[str, int, int]] = field(default_factory=list)
    # (start_ns, end_ns, name) of each host operation, sorted by start
    host: List[Tuple[int, int, str]] = field(default_factory=list)

    @property
    def kernels(self) -> List[Tuple[str, int, int]]:
        return [e for e in self.device if not _COPY.match(e[0])]

    def busy_s(self) -> float:
        """Seconds in which some device activity ran (their union)."""
        total, end = 0, None
        for _, s, d in sorted(self.device, key=lambda e: e[1]):
            e = s + d
            if end is None or s > end:
                total += d
                end = e
            elif e > end:
                total += e - end
                end = e
        return total * 1e-9

    def gaps(self) -> List[Tuple[int, int]]:
        """(start_ns, end_ns) of each stretch between device activities."""
        out, end = [], None
        for _, s, d in sorted(self.device, key=lambda e: e[1]):
            if end is not None and s > end:
                out.append((end, s))
            end = s + d if end is None else max(end, s + d)
        return out

    def top_device_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, int] = defaultdict(int)
        for name, _, d in self.device:
            by[name] += d
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:200], v * 1e-9] for n, v in top]

    def idle_by_host(self, k: int = 10, attribute: int = 20000) -> List[list]:
        """Idle seconds by the innermost host operation running at the
        middle of each gap (the ``attribute`` longest gaps; "python" where
        no operation ran), the ``k`` largest."""
        starts = [h[0] for h in self.host]
        by: Dict[str, int] = defaultdict(int)
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:attribute]
        for a, b in gaps:
            mid = (a + b) // 2
            name = "python"
            j = bisect.bisect_right(starts, mid) - 1
            for i in range(j, max(j - 64, -1), -1):
                if self.host[i][1] >= mid:
                    name = self.host[i][2]
                    break
            by[name] += b - a
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:200], v * 1e-9] for n, v in top]


def from_profiler(prof) -> Trace:
    """The events of a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    t = Trace()
    host = []
    for e in events:
        d = e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # a named range over the kernels it launched, not an activity
            if not e.is_user_annotation():
                t.device.append((e.name(), e.start_ns(), d))
        elif d > 0:
            name = e.name()
            if not name.startswith("cuda"):
                host.append((e.start_ns(), e.start_ns() + d, name))
    host.sort()
    t.host = host
    return t
