"""Quantized-gradient training: integer-valued grad/hess for histograms.

Counterpart of ``lightgbm_tpu/core/quant.py`` (``quant_uniforms`` and
``quantize_gradients``, quant.py:35-90).  Per boosting iteration the
gradients are scaled to ``GRAD_LEVELS`` signed / ``HESS_LEVELS`` non-negative
integer levels and stochastically rounded; the histograms then sum small
integers exactly and the split scan runs on the dequantized sums
(``split.dequantize_hist``).

The rounding offset of a row is a stateless hash of (seed, iteration, row
id), bit-equal to the JAX one: torch has little ``uint32`` support, so the
hash runs in ``int64`` and is masked to 32 bits after every step, with each
32 x 32-bit multiply split in two 16-bit halves so no product overflows.
Quantization is a plain elementwise pass (no kernel does it in the JAX
package either); its f32 operations are the JAX ones in the same order.
"""
from __future__ import annotations

import torch

GRAD_LEVELS = 127    # signed: q_g in [-127, 127]
HESS_LEVELS = 255    # non-negative: q_h in [0, 255]
_QUANT_TAG = 0x7FB5D591  # domain separation vs the bagging hash stream
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32) and a 32-bit ``c``,
    without an int64 product beyond 2**49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def quant_uniforms(row_ids: torch.Tensor, seed: int, it: int) -> torch.Tensor:
    """Stateless per-(iteration, row) uniform in [0, 1) as f32, truncated to
    24 bits so it stays strictly below 1.0 (quant.py:40-56)."""
    x = row_ids.to(torch.int64) & _M32
    x = x ^ ((int(seed) * 2654435761) & _M32)
    x = x ^ _QUANT_TAG
    x = (x + ((int(it) * 0x9E3779B9) & _M32)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 2246822519)
    x = x ^ (x >> 13)
    x = _mul32(x, 3266489917)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (2.0 ** -24)


def quantize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                       row_ids: torch.Tensor, it: int, seed: int, comm=None):
    """Stochastically round (grad, hess) to integer-valued f32.

    Returns ``(q_grad, q_hess, qscale[2])``: q_grad in [-127, 127], q_hess in
    [0, 255], ``qscale = (s_g, s_h)`` with real value = q * s.  Exact zeros
    stay exact zeros (quant.py:59-90).  With ``comm`` (a
    ``parallel.comm.ProcessComm`` over ranks that each hold a stripe of the
    rows) the maxima behind the scales are taken over every rank
    (quant.py:71-73, ``pmax``), so a striped build quantizes with the serial
    stream's scales; ``row_ids`` must then be the global ids."""
    f32 = torch.float32
    grad = grad.to(f32)
    hess = hess.to(f32)
    tiny = torch.full((), 1e-30, dtype=f32, device=grad.device)
    maxima = torch.stack([grad.abs().max(), hess.max()])
    if comm is not None:
        maxima = comm.all_reduce_max(maxima)
    s_g = torch.maximum(maxima[0], tiny) / GRAD_LEVELS
    s_h = torch.maximum(maxima[1], tiny) / HESS_LEVELS
    u_g = quant_uniforms(row_ids, seed, it)
    # the hessian reuses the grad stream reflected: 1 - 2**-24 - u_g
    u_h = torch.full((), 1.0 - 2.0 ** -24, dtype=f32,
                     device=grad.device) - u_g
    q_g = torch.clamp(torch.floor(grad / s_g + u_g), -GRAD_LEVELS, GRAD_LEVELS)
    q_h = torch.clamp(torch.floor(hess / s_h + u_h), 0, HESS_LEVELS)
    zero = torch.zeros((), dtype=f32, device=grad.device)
    q_g = torch.where(grad == 0.0, zero, q_g)
    q_h = torch.where(hess == 0.0, zero, q_h)
    return q_g, q_h, torch.stack([s_g, s_h])
