"""What the run needs of the machine, and what it may not load."""
from __future__ import annotations

import sys
from typing import List

# compared by whole top-level module names: the port's own name begins
# with the JAX package's, and is allowed
FORBIDDEN = ("jax", "jaxlib", "flax", "lightgbm_tpu")


class NoCard(RuntimeError):
    pass


def one_host_thread() -> None:
    """One host thread for the CPU operators of the run (OpenMP, MKL,
    OpenBLAS, torch's intra-op pool).  On a host shared with other
    tenants, a pool of threads waits for its slowest member: with the
    default pool ``higgs-leaf`` spread 18% from run to run, with one
    thread 7% (PERF.md section 2).  Call before the first import of numpy
    or torch."""
    import os
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    if "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(1)


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the run may not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def require_cards(count: int) -> None:
    """Raise unless ``count`` CUDA cards are visible: device numbers are
    never taken from the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card (torch.cuda.is_available() is false)")
    if torch.cuda.device_count() < count:
        raise NoCard("%d CUDA card(s) visible, the cell needs %d"
                     % (torch.cuda.device_count(), count))


def device_record(count: int, peak_bytes: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(count), "memory_peak_bytes": int(peak_bytes)}
