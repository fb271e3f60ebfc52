"""The host-side tiling of the port's kernels, which the CPU can check.

- ``part_tile_rows``: rows per block of the split pass's count, scatter and
  copy-back kernels, from the row width (about 128 KB of row bytes a block,
  clamped to [32, 2048]), and ``part_blocks``, the blocks of a window.
- ``level_meta``: the level pass's host-built block map uses the same rows
  per block at the widths the paths use (W = 128 at 28 features, W = 2048 at
  2000); its histogram map keeps each window's single-window segments
  (exact), or the integer kernel's own grid (quantized).
- ``int_hist_grid``: the integer kernel's grid (features a block, row
  segments) at the paths' sizes, within its rows and shared memory.
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


WINDOWS = [(0, 5000), (5000, 0), (6000, 64), (7000, 1), (9000, 70_000),
           (80_000, 2048)]


@pytest.mark.parametrize("F, W", [(28, 128), (2000, 2048)])
def test_level_meta_block_map(F, W):
    B = 256
    windows = WINDOWS
    s = scal_rows(windows, B)
    lm = P.level_meta(s, F, B, W)
    meta, NB, NS = lm.meta, lm.nblk, lm.hist.nseg
    G, S = s.shape
    tile = P.part_tile_rows(W)
    nblk = [-(-wc // tile) for _, wc in windows]
    assert NB == sum(nblk)
    wmeta = meta[G * S:G * S + 2 * G].reshape(G, 2)
    assert wmeta[:, 1].tolist() == nblk                       # nblk column
    assert wmeta[:, 0].tolist() == (np.cumsum(nblk) - nblk).tolist()
    o = G * S + 2 * G
    blkmap = meta[o:o + 2 * NB].reshape(NB, 2)
    want = [(g, t) for g, n in enumerate(nblk) for t in range(n)]
    assert [tuple(r) for r in blkmap.tolist()] == want
    # each window keeps its single-window call's histogram segments
    o += 2 * NB
    seg = meta[o:o + 2 * G].reshape(G, 2)
    assert seg[:, 0].tolist() == [H._segments(wc, F, B) if wc else 0
                                  for _, wc in windows]
    assert NS == int(seg[:, 0].sum())
    assert meta.size == o + 2 * G + 2 * NS


@pytest.mark.parametrize("F, W", [(28, 128), (2000, 2048)])
def test_level_meta_quantized_block_map(F, W):
    """Quantized: the integer kernel's own grid for each window, the level's
    264 blocks shared by rows; windows of one segment need no accumulator."""
    B = 256
    s = scal_rows(WINDOWS, B)
    lm = P.level_meta(s, F, B, W, quantized=True)
    G, S = s.shape
    o = G * S + 2 * G + 2 * lm.nblk
    info = lm.meta[o:o + 4 * G].reshape(G, 4)
    hmap = lm.meta[o + 4 * G:]
    total = sum(wc for _, wc in WINDOWS)
    want = [H.int_hist_grid(wc, F, B, -(-264 * wc // total))
            if wc else (F, 0) for _, wc in WINDOWS]
    assert info[:, 2].tolist() == [ft for ft, _ in want]
    assert info[:, 0].tolist() == [ns for _, ns in want]
    nhb = [ns * -(-F // ft) for ft, ns in want]
    assert info[:, 3].tolist() == (np.cumsum(nhb) - nhb).tolist()
    assert hmap.tolist() == [g for g, n in enumerate(nhb) for _ in range(n)]
    h = lm.hist
    assert h.nblocks == sum(nhb)
    shared = [int(ns > 1) for _, ns in want]   # an accumulator row each
    assert info[:, 1].tolist() == (np.cumsum(shared) - shared).tolist()
    assert h.nacc == sum(shared)
    assert h.reduce                     # the empty window is zeroed by pass 2
    assert h.ft_max == max(ft for ft, ns in want if ns)
    assert h.seg_rows == max(-(-wc // ns) for (_, wc), (_, ns)
                             in zip(WINDOWS, want) if ns)
    # the 70,000-row window splits its rows; the small ones do not
    assert [ns for _, ns in want] == ([2, 0, 1, 1, 69, 1] if F == 28 else
                                      [2, 0, 1, 1, 3, 1])


@pytest.mark.parametrize("depth", range(8))
def test_level_meta_quantized_frontier_fills_the_card(depth):
    """The 2**depth windows of one level of a 1M-row tree at F = 28: the
    launch fills the card, and no block stages more than 4,096 rows of a
    small window (a block of a large one has ~4,000 rows of 28 features)."""
    B, F = 256, 28
    bounds = np.linspace(0, 1 << 20, 2 ** depth + 1).astype(np.int64)
    wc = np.diff(bounds)
    s = scal_rows([(int(a), int(c)) for a, c in zip(bounds, wc)], B)
    lm = P.level_meta(s, F, B, 128, quantized=True)
    G, S = s.shape
    o = G * S + 2 * G + 2 * lm.nblk
    info = lm.meta[o:o + 4 * G].reshape(G, 4)
    assert lm.hist.nblocks >= 2 * 132
    assert (-(-wc // info[:, 0]) <= (4096 if wc[0] <= 1 << 16 else
                                     4000)).all()
    assert lm.hist.nacc == int((info[:, 0] > 1).sum())


# (rows, F) -> (features a block, segments, blocks) at B = 256
INT_GRIDS = [(1000, 28, 1, 1, 28), (20_000, 28, 2, 18, 252),
             (1 << 20, 28, 28, 264, 264), (1000, 2000, 8, 1, 250),
             (20_000, 2000, 32, 5, 315), (1 << 20, 2000, 32, 4, 252),
             (400_000, 2000, 32, 4, 252), (0, 28, 1, 1, 28)]


@pytest.mark.parametrize("count, F, ft, nseg, blocks", INT_GRIDS)
def test_int_hist_grid(count, F, ft, nseg, blocks):
    """Small windows narrow the tiles first, large ones split the rows."""
    assert H.int_hist_grid(count, F, 256) == (ft, nseg)
    assert -(-F // ft) * nseg == blocks


@pytest.mark.parametrize("count", [1, 1000, 20_000, 65_536, 65_537, 1 << 20,
                                   8_500_000, 20_000_000])
@pytest.mark.parametrize("F, B", [(2, 32), (28, 64), (28, 256),
                                  (2000, 256), (1, 10905)])
def test_int_hist_grid_limits(count, F, B):
    """Every block within its rows and its shared memory; the card filled
    where the rows allow it."""
    ft, nseg = H.int_hist_grid(count, F, B)
    H.check_int_segments(count, nseg)
    assert 1 <= ft <= F and nseg >= 1
    assert ft == 1 or ft * 8 * B <= H._INT_HIST_SMEM
    blocks = -(-F // ft) * nseg
    if count >= 264 * H._INT_SEG_ROWS:
        assert blocks >= 264 * 0.9


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
