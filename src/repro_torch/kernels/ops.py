"""Entry points the engine calls into the kernels.

:func:`bitserial_matmul_exact` is the exact unsigned bit-serial GEMM the
``gemm`` backend (core/backends.py) runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitserial_matmul as _bsm

__all__ = ["bitserial_matmul_exact"]


def bitserial_matmul_exact(x_q: torch.Tensor, planes: torch.Tensor, *,
                           n_bits: int) -> torch.Tensor:
    """Exact unsigned-integer bit-serial GEMM ``[M, K] x [K, N] -> [M, N]``
    int32: unsigned plane weights (the MSB carries +2^(n-1), the packed word
    engine's operand convention) and the accumulator returned verbatim."""
    return _bsm.bitserial_matmul(x_q, planes, 1.0, None, n_bits=n_bits,
                                 out_dtype=torch.int32, signed=False)
