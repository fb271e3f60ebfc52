"""The data generators: one seed gives the same rows in the same order,
two seeds the same rows in two orders (on the CPU's generator; the card's
stream is another)."""
import pytest
import torch

from harness import cells

CONFIGS = {"higgs": dict(rows=3000, test_rows=500, features=28,
                         data_seed=5),
           "epsilon": dict(rows=2000, test_rows=400, features=120,
                           data_seed=6)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_same_seed_same_rows(name, seed):
    gen = cells.module("datagen", name)
    a = gen.make(CONFIGS[name], seed, "cpu")
    b = gen.make(CONFIGS[name], seed, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    X, y, Xt, yt = a
    assert X.shape == (3000 if name == "higgs" else 2000,
                       CONFIGS[name]["features"])
    assert X.dtype == torch.float32 and y.dtype == torch.float64
    assert 0.2 < float(y.mean()) < 0.8


def _sorted_rows(X, y):
    rows = torch.cat([X.double(), y[:, None]], 1)
    return rows[torch.argsort(rows[:, 0])]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_seeds_order_the_same_rows(name):
    gen = cells.module("datagen", name)
    a = gen.make(CONFIGS[name], 1, "cpu")
    b = gen.make(CONFIGS[name], 2, "cpu")
    assert not torch.equal(a[0], b[0])
    for i in (0, 2):
        assert torch.equal(_sorted_rows(a[i], a[i + 1]),
                           _sorted_rows(b[i], b[i + 1]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_data_seed_makes_the_rows(name):
    gen = cells.module("datagen", name)
    a = gen.make(CONFIGS[name], 1, "cpu")
    b = gen.make(dict(CONFIGS[name], data_seed=99), 1, "cpu")
    assert not torch.equal(_sorted_rows(a[0], a[1]),
                           _sorted_rows(b[0], b[1]))
