"""Epsilon-shaped binary data (chip_smoke.py's ``epsilon_task``): standard
normal f32 features, and labels drawn from a logistic model on 40 features
plus 5 products of pairs, made on the device from the configuration's
``data_seed``; ``seed`` orders the rows."""
from __future__ import annotations

import math

import torch


def make(config: dict, seed: int, device):
    n, n_test, f = (int(config[k]) for k in ("rows", "test_rows",
                                               "features"))
    g = torch.Generator(device=device).manual_seed(int(config["data_seed"]))
    X = torch.randn((n + n_test, f), generator=g, device=device)
    cols = torch.randperm(f, generator=g, device=device)[:50].tolist()
    w = torch.randn(40, generator=g, device=device, dtype=torch.float64)
    logit = X[:, cols[:40]].double() @ (w * 1.5 / math.sqrt(40))
    for a, b in zip(cols[40::2], cols[41::2]):
        logit += 0.5 * X[:, a].double() * X[:, b].double()
    u = torch.rand(n + n_test, generator=g, device=device,
                   dtype=torch.float64)
    y = (u < torch.sigmoid(logit)).double()
    # the seed orders the rows: each seed trains on the same rows (the same
    # work), held out the same rows, in an order of its own
    g.manual_seed(int(seed))
    order = torch.cat([torch.randperm(n, generator=g, device=device),
                       n + torch.randperm(n_test, generator=g, device=device)])
    X, y = X[order], y[order]
    return X[:n], y[:n], X[n:], y[n:]
