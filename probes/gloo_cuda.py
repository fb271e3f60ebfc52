"""Which gloo collectives take CUDA tensors, for the table
``lightgbm_tpu_torch/parallel/comm.py`` ``GLOO_CUDA_KINDS``.

Two processes join a gloo group, both on CUDA device 0, and each calls every
collective the parallel learners use on CUDA tensors: all-reduce (sum, max,
and sum of bf16), reduce-scatter of a list, all-gather into a list (f32 and
u8), and ``reduce_scatter_tensor`` / ``all_gather_into_tensor`` beside them.
Each result is checked against the value it must have.  Needs one CUDA card;
run from the repository root::

    python3 probes/gloo_cuda.py

It prints torch's and CUDA's versions and one line per (rank, collective):
``ok``, ``WRONG`` or the exception it raised.  The last line is a JSON
object {collective: "ok" on both ranks, else what failed}.
"""
from __future__ import annotations

import json
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CASES = ("all_reduce_sum", "all_reduce_max", "all_reduce_bf16",
         "reduce_scatter_list", "reduce_scatter_tensor", "all_gather_list",
         "all_gather_into_tensor", "all_gather_u8")


def run_case(case: str, rank: int) -> bool:
    dev = torch.device("cuda:0")
    x = torch.arange(8, dtype=torch.float32, device=dev) + rank
    both = [2 * i + 1 for i in range(8)]           # x of rank 0 + rank 1
    if case == "all_reduce_sum":
        dist.all_reduce(x)
        return x.cpu().tolist() == both
    if case == "all_reduce_max":
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return x.cpu().tolist() == [i + 1 for i in range(8)]
    if case == "all_reduce_bf16":
        y = x.to(torch.bfloat16)
        dist.all_reduce(y)
        return y.float().cpu().tolist() == both
    mine = both[4 * rank:4 * rank + 4]
    if case == "reduce_scatter_list":
        out = torch.empty(4, device=dev)
        dist.reduce_scatter(out, list(x.chunk(2)))
        return out.cpu().tolist() == mine
    if case == "reduce_scatter_tensor":
        out = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return out.cpu().tolist() == mine
    if case in ("all_gather_list", "all_gather_u8"):
        t = x.to(torch.uint8) if case == "all_gather_u8" else x
        parts = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(parts, t)
        return parts[1].float().cpu().tolist() == [i + 1 for i in range(8)]
    if case == "all_gather_into_tensor":
        out = torch.empty(16, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out[8:].cpu().tolist() == [i + 1 for i in range(8)]
    raise ValueError(case)


def rank_main(rank: int, port: int, queue) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            rank=rank, world_size=2)
    res = {}
    for case in CASES:
        try:
            res[case] = "ok" if run_case(case, rank) else "WRONG"
        except Exception as exc:  # noqa: BLE001 - the finding is the result
            res[case] = "%s: %s" % (type(exc).__name__,
                                    str(exc).splitlines()[0][:160])
    queue.put((rank, res))
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda: needs a CUDA card", file=sys.stderr)
        return 2
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                    torch.cuda.get_device_name(0)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, port, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, res = queue.get(timeout=180)
            results[rank] = res
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
    for rank in sorted(results):
        for case, v in results[rank].items():
            print("rank %d %-24s %s" % (rank, case, v))
    print(json.dumps({c: ("ok" if all(r[c] == "ok" for r in results.values())
                          else {k: r[c] for k, r in results.items()})
                      for c in CASES}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
