"""Where the device memory of a level tree at the Epsilon width goes:
(D2)'s peak against its reckoning (the second row store and the level
workspace).

Needs one CUDA card and ``nvcc``; run from the repository root::

    python3 probes/level_wide_memory.py [--rows 100000] [--quantized]

It makes Epsilon-shaped rows (``chip_smoke.epsilon_task``, 2000 features),
bins them as (D) does, grows one level tree at (D)'s settings
(``tree_grow_mode=level``) to make the learner's buffers, then records the
allocator's history (``torch.cuda.memory._record_memory_history``) over a
second tree.  It replays the history to the moment of the peak and prints
the blocks live then, grouped by the innermost frame of the port that
asked for them, largest first, beside the level workspace's and the row
stores' bytes.  The last two lines are the card's name and power limit and
a JSON object of the numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.getcwd())


def live_at_peak(snapshot: dict, base: int):
    """Replay the allocator's trace: the peak of the bytes allocated during
    it (above ``base``, allocated before it began) and the blocks live at
    that moment, each with its size and its innermost frame of the
    port."""
    live, cur, peak, at_peak = {}, 0, 0, {}
    for trace in snapshot["device_traces"]:
        for e in trace:
            if e["action"] == "alloc":
                live[e["addr"]] = e
                cur += e["size"]
                if cur > peak:
                    peak, at_peak = cur, dict(live)
            elif e["action"] == "free_completed" and e["addr"] in live:
                cur -= live.pop(e["addr"])["size"]
    groups = {}
    for e in at_peak.values():
        frame = next((f for f in e.get("frames", [])
                      if "lightgbm_tpu_torch" in f["filename"]), None)
        key = ("%s:%d %s" % (frame["filename"].split("lightgbm_tpu_torch/")
                             [-1], frame["line"], frame["name"])
               if frame else "(outside the port)")
        n, size = groups.get(key, (0, 0))
        groups[key] = (n + 1, size + e["size"])
    return base + peak, sorted(groups.items(), key=lambda kv: -kv[1][1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--quantized", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("level_wide_memory: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as C
    from lightgbm_tpu_torch import (BinnedDataset, Config, GBDT,
                                    create_objective, kernels)
    from lightgbm_tpu_torch.utils.log import Log
    Log.reset_level(Log.level_from_verbosity(-1))
    dev = torch.device("cuda")
    card = C.gpu_name_and_power()
    kernels.build()
    X, y, _, _ = C.epsilon_task(args.rows, 1000, dev)
    ds = BinnedDataset.from_matrix(
        X, label=y, max_bin=255,
        bin_construct_sample_cnt=C.EPSILON_BIN_SAMPLE)
    extra = dict(tree_grow_mode="level")
    if args.quantized:
        extra["hist_precision"] = "quantized"
    cfg = Config(**dict(C.EPSILON_PARAMS, **extra))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    booster = GBDT(cfg, ds, create_objective("binary", cfg))
    booster.train_one_iter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=1_000_000)
    booster.train_one_iter()
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    peak_alloc = torch.cuda.max_memory_allocated()
    learner = booster.learner
    work = learner._level_work
    nbytes = dict(
        workspace=work.nbytes(),
        partials=work.partial.numel() * work.partial.element_size(),
        row_store=learner.template.numel() * learner.template.element_size(),
        second_store=learner.spare.numel() * learner.spare.element_size(),
        kept_between_trees=base - before,
        peak_above_kept=peak_alloc - base)
    replay_peak, groups = live_at_peak(snap, base)
    print("rows %d x %d features, %s: level workspace %.1f MB (partials "
          "%.1f MB), row stores %.1f + %.1f MB; kept between trees %.1f MB; "
          "peak of the second tree %.1f MB above that (allocator), %.1f MB "
          "(replayed trace)" % (
              args.rows, X.shape[1],
              "quantized" if args.quantized else "exact",
              nbytes["workspace"] / 1e6, nbytes["partials"] / 1e6,
              nbytes["row_store"] / 1e6, nbytes["second_store"] / 1e6,
              nbytes["kept_between_trees"] / 1e6,
              nbytes["peak_above_kept"] / 1e6, (replay_peak - base) / 1e6),
          flush=True)
    print("blocks live at the peak, by the port's frame that made them:",
          flush=True)
    top = []
    for key, (n, size) in groups[:20]:
        print("  %10.1f MB in %4d blocks  %s" % (size / 1e6, n, key),
              flush=True)
        top.append(dict(frame=key, blocks=n, bytes=size))
    print(card, flush=True)
    print(json.dumps(dict(nbytes, replay_peak_above_kept=replay_peak - base,
                          top=top)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
