"""The port's histogram and split pass at a wide shape against the JAX package.

Past its 4 MiB accumulator gate (``_use_factored``, histogram.py:362) the JAX
package builds histograms with its classic packed-tile kernel
(``_hist_kernel_rows``, histogram.py:588) and, inside the fused split pass,
the classic ``_hist_tile`` branch (partition.py:281): the path an
Epsilon-shaped dataset (2000 features at 256 bins) takes on the TPU.  Here
both kernels run in Pallas interpret mode, forced onto the classic path with
``monkeypatch`` (``_use_factored`` replaced in both modules by a
3-argument lambda, the jitted functions' caches cleared before and after),
with ``pl.load``/``pl.store`` shimmed as ``test_torch_level_oracle.py`` does.
Nothing in ``lightgbm_tpu`` is edited.

Shapes: 600 features, 256 bins, 4096 rows, bpc 1 and 2 (histograms); 100
features, 256 bins in a 12,288-row store for the split pass, whose classic
branch reads the g/h bytes through a 128-lane mask (partition.py:284-287)
and so takes only 128-byte rows.  Tolerances: quantized histograms (integer
sums) must be equal bit for bit; exact ones (``exact=True``, as
``LIGHTGBM_TPU_EXACT_HIST=1`` selects: the JAX kernels sum in f32, the
port in f64 rounded once) within the f32 bound
``count * 2**-24 * max|value|`` per bin; row stores and left counts equal.  Also: the segment rule caps the partials of a wide store.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import lightgbm_tpu.core.histogram as JH
import lightgbm_tpu.core.partition as JP
from lightgbm_tpu_torch.core import histogram as H
from lightgbm_tpu_torch.core import partition as P
from lightgbm_tpu_torch.core.tree_learner import row_layout

F, B = 600, 256


def _store(ref, idx, val):
    ref[idx] = val


@pytest.fixture
def classic(monkeypatch):
    """The JAX package forced onto its classic kernels, interpret mode."""
    monkeypatch.setattr(pl, "load", lambda ref, idx: ref[idx], raising=False)
    monkeypatch.setattr(pl, "store", _store, raising=False)
    monkeypatch.setenv("LIGHTGBM_TPU_EXACT_HIST", "1")
    for mod in (JH, JP):
        monkeypatch.setattr(mod, "_use_factored", lambda f, b, q=False: False)
    jitted = (JH.histogram_pallas_rows, JP.partition_hist_pallas)
    for fn in jitted:
        fn.clear_cache()
    yield
    for fn in jitted:
        fn.clear_cache()


def make_rows(n, bpc, quantized, seed, nf=F):
    """[n, W] row store in the port's layout: random bins of ``nf``
    features, grad/hess (integers under ``quantized``), order ids."""
    rng = np.random.RandomState(seed)
    lay = row_layout(nf, bpc)
    rows = np.zeros((n, lay.W), np.uint8)
    codes = rng.randint(0, B, size=(n, nf))
    if bpc == 2:
        rows[:, 0:2 * nf:2] = codes & 255
        rows[:, 1:2 * nf:2] = codes >> 8
    else:
        rows[:, :nf] = codes
    if quantized:
        gh = np.stack([rng.randint(-127, 128, n), rng.randint(0, 256, n)], 1)
    else:
        gh = np.stack([rng.normal(size=n), rng.uniform(0.1, 1.0, n)], 1)
    rows[:, lay.voff:lay.voff + 8] = gh.astype(np.float32).view(
        np.uint8).reshape(n, 8)
    rows[:, lay.voff + 8:lay.voff + 12] = np.arange(n, dtype=np.int32).view(
        np.uint8).reshape(n, 4)
    return rows, lay.voff


def check_close(got, want, count, quantized, what):
    got, want = np.asarray(got), np.asarray(want)
    if quantized:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=max(count, 1) * 2.0 ** -24 * 4.0,
                                   err_msg=what)


@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("quantized", [False, True])
def test_wide_histogram_matches_jax_classic_and_xla(classic, bpc, quantized):
    n = 4096
    rows, voff = make_rows(n, bpc, quantized, seed=bpc + 2 * quantized)
    jr = jnp.asarray(rows)
    for start, count in ((0, n), (333, 2500)):
        kw = dict(num_features=F, voff=voff, bpc=bpc, quantized=quantized)
        port = H.histogram_rows(torch.from_numpy(rows), B, start, count, **kw)
        assert port.shape == (F, 2, B)
        xla = JH.histogram_rows(jr, B, jnp.int32(start), jnp.int32(count),
                                use_pallas=False, **kw)
        # the kernel entry itself: histogram_rows would pass f_begin traced,
        # which the classic path refuses
        ref = JH.histogram_pallas_rows(jr, B, jnp.int32(start),
                                       jnp.int32(count), interpret=True,
                                       exact=not quantized, **kw)
        what = "bpc=%d quantized=%s [%d, +%d)" % (bpc, quantized, start,
                                                  count)
        check_close(port.numpy(), xla, count, quantized, what + " vs XLA")
        check_close(port.numpy(), ref, count, quantized,
                    what + " vs the classic kernel")


@pytest.mark.parametrize("quantized", [False, True])
def test_wide_split_pass_matches_jax_classic(classic, quantized):
    n, nf = 3 * JP.CHUNK, 100
    rows, voff = make_rows(n, 1, quantized, seed=7 + quantized, nf=nf)
    assert rows.shape[1] == 128
    for wb, wc, hist_left in ((0, 2 * JP.CHUNK, 1), (1234, 2513, 0)):
        scal = np.zeros(12 + B // 32, np.int32)
        scal[:12] = [wb, wc, 17, 100, 1, 0, B, 0, 0, hist_left, 0, 1]
        kw = dict(num_features=nf, num_bins=B, voff=voff, bpc=1,
                  quantized=quantized)
        r_port, h_port, nl_port = P.partition_hist(
            torch.from_numpy(rows), scal, **kw)
        r_ref, h_raw, nl_ref = JP.partition_hist_pallas(
            jnp.asarray(rows), jnp.asarray(scal), exact=not quantized,
            interpret=True, **kw)
        h_ref = JP.fold_hist(h_raw, nf, B, quantized)
        assert int(nl_port[0]) == int(nl_ref[0, 0])
        np.testing.assert_array_equal(r_port.numpy(), np.asarray(r_ref))
        child = int(nl_port[0]) if hist_left else wc - int(nl_port[0])
        check_close(h_port.numpy(), h_ref, child, quantized,
                    "split [%d, +%d)" % (wb, wc))


def test_segments_cap_the_partials_of_a_wide_store():
    # unchanged at 28 features; at 2000 x 256 the f64 partials stay <= 256 MiB
    assert H._segments(1 << 20, 28, 256) == 512
    assert H._segments(400_000, 2000, 256) == 32
    assert H._segments(3000, 2000, 256) == 2
    assert 32 * 2000 * 2 * 256 * 8 <= H._PARTIAL_BUDGET


@pytest.fixture(autouse=True)
def _shim_is_undone():
    had = (hasattr(pl, "load"), hasattr(pl, "store"))
    yield
    assert (hasattr(pl, "load"), hasattr(pl, "store")) == had
