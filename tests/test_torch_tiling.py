"""The host-side tiling of the port's kernels, which the CPU can check.

- ``part_tile_rows``: rows per block of the split pass's count, scatter and
  copy-back kernels, from the row width (about 128 KB of row bytes a block,
  clamped to [32, 2048]), and ``part_blocks``, the blocks of a window.
- ``level_meta``: the level pass's host-built block map uses the same rows
  per block at the widths the paths use (W = 128 at 28 features, W = 2048 at
  2000).
- ``check_hist_shape``: the exact histogram kernel's shared-memory tiling
  (``csrc/hist_common.cuh``) takes every shape the paths use, and at most
  10,905 bins (one feature of 4-byte bins in one SM's shared memory).
"""
import numpy as np
import pytest

from lightgbm_tpu_torch.core import histogram as H
from lightgbm_tpu_torch.core import partition as P
from lightgbm_tpu_torch.core.tree_learner import row_layout

@pytest.mark.parametrize("W, rows", [(16, 2048), (64, 2048), (128, 1024),
                                     (144, 910), (2048, 64), (4096, 32),
                                     (8192, 32), (1 << 20, 32)])
def test_part_tile_rows(W, rows):
    assert P.part_tile_rows(W) == rows


@pytest.mark.parametrize("wc, W, nblk", [(0, 128, 0), (1, 128, 1),
                                         (1024, 128, 1), (1025, 128, 2),
                                         (1 << 20, 128, 1024),
                                         (400_000, 2048, 6250),
                                         (10_000, 2048, 157),
                                         (20_000, 2048, 313)])
def test_part_blocks_of_a_window(wc, W, nblk):
    assert P.part_blocks(wc, W) == nblk
    got = P.part_blocks(np.asarray([wc, wc], np.int64), W)
    assert got.tolist() == [nblk, nblk]


def test_paths_row_widths():
    """The paths' row stores: W = 128 at 28 features, 2048 at 2000."""
    assert row_layout(28, 1).W == 128
    assert row_layout(2000, 1).W == 2048


def scal_rows(windows, num_bins):
    S = P.SCAL_HEAD + num_bins // 32
    s = np.zeros((len(windows), S), np.int64)
    for g, (wb, wc) in enumerate(windows):
        s[g, :2] = wb, wc
    return s


@pytest.mark.parametrize("F, W", [(28, 128), (2000, 2048)])
def test_level_meta_block_map(F, W):
    B = 256
    windows = [(0, 5000), (5000, 0), (6000, 64), (7000, 1), (9000, 70_000),
               (80_000, 2048)]
    s = scal_rows(windows, B)
    meta, NB, NS, srows, _ = P.level_meta(s, F, B, W)
    G, S = s.shape
    tile = P.part_tile_rows(W)
    nblk = [-(-wc // tile) for _, wc in windows]
    assert NB == sum(nblk)
    assert srows == sum(wc for _, wc in windows)
    wmeta = meta[G * S:G * S + 4 * G].reshape(G, 4)
    assert wmeta[:, 1].tolist() == nblk                       # nblk column
    assert wmeta[:, 0].tolist() == (np.cumsum(nblk) - nblk).tolist()
    assert wmeta[:, 2].tolist() == (np.cumsum([wc for _, wc in windows])
                                    - [wc for _, wc in windows]).tolist()
    blkmap = meta[G * S + 6 * G:G * S + 6 * G + 2 * NB].reshape(NB, 2)
    want = [(g, t) for g, n in enumerate(nblk) for t in range(n)]
    assert [tuple(r) for r in blkmap.tolist()] == want
    # each window keeps its single-window call's histogram segments
    seg = meta[G * S + 4 * G:G * S + 6 * G].reshape(G, 2)
    assert seg[:, 0].tolist() == [H._segments(wc, F, B) if wc else 0
                                  for _, wc in windows]
    assert NS == int(seg[:, 0].sum())


@pytest.mark.parametrize("F", [1, 28, 2000])
@pytest.mark.parametrize("B", [32, 64, 128, 256])
def test_check_hist_shape_takes_the_paths_shapes(F, B):
    H.check_hist_shape(F, B)


@pytest.mark.parametrize("F, B", [(0, 256), (28, 0), (28, 10906),
                                  (2000, 16384)])
def test_check_hist_shape_refuses(F, B):
    with pytest.raises(ValueError):
        H.check_hist_shape(F, B)


def test_check_hist_shape_limit_is_one_feature_of_4_byte_bins():
    """A block of one feature may fill an SM (227 KB): 10,905 bins."""
    assert H._MAX_BINS == 10905
    H.check_hist_shape(1, H._MAX_BINS)
    H.check_hist_shape(28, 8192)


@pytest.mark.parametrize("F, B, ok", [(1, 10905, True), (28, 10905, True),
                                      (2000, 10905, True), (1, 10906, False),
                                      (28, 10906, False), (1, 1, True),
                                      (1, 1 << 20, False)])
def test_check_hist_shape_bin_limit(F, B, ok):
    """10,905 bins is the most at any feature count, one bin the least."""
    if ok:
        H.check_hist_shape(F, B)
    else:
        with pytest.raises(ValueError, match="num_bins <= 10905"):
            H.check_hist_shape(F, B)
