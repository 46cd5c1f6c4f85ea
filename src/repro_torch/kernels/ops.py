"""Entry points the engine calls into the kernels.

:func:`bitserial_matmul_exact` is the exact unsigned bit-serial GEMM the
``gemm`` backend (core/backends.py) runs: the 8-bit kernel, or the W4A4
kernel on nibble-packed activations.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitserial_matmul as _bsm

__all__ = ["bitserial_matmul_exact"]


def bitserial_matmul_exact(x_q: torch.Tensor, planes: torch.Tensor, *,
                           n_bits: int, w4a4: bool = False) -> torch.Tensor:
    """Exact unsigned-integer bit-serial GEMM ``[M, K] x [K, N] -> [M, N]``
    int32: unsigned plane weights (the MSB carries +2^(n-1), the packed word
    engine's operand convention) and the accumulator returned verbatim.
    ``w4a4=True`` takes nibble-packed activations ``[M, ceil(K/2)]``
    (:func:`~repro_torch.kernels.bitserial_matmul.pack_activation_nibbles`)
    through the W4A4 kernel, with unsigned nibbles."""
    if w4a4:
        return _bsm.bitserial_matmul_a4(x_q, planes, 1.0, None, n_bits=n_bits,
                                        out_dtype=torch.int32, signed=False)
    return _bsm.bitserial_matmul(x_q, planes, 1.0, None, n_bits=n_bits,
                                 out_dtype=torch.int32, signed=False)
