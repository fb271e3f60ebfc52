"""Higgs-shaped binary data: standard normal f32 features and a label from
``2 x0 + x1^2 - x2 x3`` plus normal noise of scale 0.5 (the generator of
``bench.py``'s ``synthetic_task``, the same model of the label), made on the
device from the configuration's ``data_seed`` in a few large calls; ``seed``
orders the rows."""
from __future__ import annotations

import torch


def make(config: dict, seed: int, device):
    n, n_test, f = (int(config[k]) for k in ("rows", "test_rows",
                                               "features"))
    g = torch.Generator(device=device).manual_seed(int(config["data_seed"]))
    X = torch.randn((n + n_test, f), generator=g, device=device)
    noise = torch.randn(n + n_test, generator=g, device=device,
                        dtype=torch.float64) * 0.5
    x = X[:, :4].double()
    logit = x[:, 0] * 2 + x[:, 1] ** 2 - x[:, 2] * x[:, 3] + noise
    y = (logit > 0).double()
    # the seed orders the rows: each seed trains on the same rows (the same
    # work), held out the same rows, in an order of its own
    g.manual_seed(int(seed))
    order = torch.cat([torch.randperm(n, generator=g, device=device),
                       n + torch.randperm(n_test, generator=g, device=device)])
    X, y = X[order], y[order]
    return X[:n], y[:n], X[n:], y[n:]
