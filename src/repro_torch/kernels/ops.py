"""Entry points the engine calls into the kernels.

:func:`bitserial_matmul_exact` is the exact unsigned bit-serial GEMM the
``gemm`` backend (core/backends.py) runs: the 8-bit kernel, or the W4A4
kernel on nibble-packed activations.  :func:`quant_matmul` is the W8A8 GEMM
of the post-training-quantization flow (``quant/ptq.py``) and
:func:`flash_attention` the tiled attention of the LM's full prefill
(``models/layers.py``).  Each launches its Hopper kernel for CUDA tensors
and runs the kernel's plain version for CPU tensors.  So do the
reference's scaled entry points :func:`bitserial_matmul` (signed planes,
byte-packed or an unpacked plane stack) and :func:`bitserial_matmul_a4`
(nibble-packed activations from :func:`pack_activations`);
:func:`quant_matmul_xla` is the W8A8 GEMM's plain version on any device,
as the reference's is its plain XLA lowering.

Each goes through a ``torch.library`` custom op (``repro_torch::*``) with a
fake implementation, which is what ``meta`` operands (the dry run) run:
nothing is launched and an empty result of the output's shape comes back.
Its FLOPs are registered in ``torch.utils.flop_counter``'s registry, so a
FLOP counter or a dispatch mode (``repro_torch.distributed.trace_analysis``)
charges a kernel's launch as one op with the FLOPs of the product it
computes.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import bitserial_matmul as _bsm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quant_matmul as _qm

__all__ = ["bitserial_matmul_exact", "bitserial_matmul",
           "bitserial_matmul_a4", "quant_matmul", "quant_matmul_xla",
           "flash_attention", "pack_weights", "pack_activations"]


@torch.library.custom_op("repro_torch::bitserial_matmul_exact",
                         mutates_args=())
def _bitserial_op(x_q: torch.Tensor, planes: torch.Tensor, n_bits: int,
                  w4a4: bool) -> torch.Tensor:
    if w4a4:
        return _bsm.bitserial_matmul_a4(x_q, planes, 1.0, None, n_bits=n_bits,
                                        out_dtype=torch.int32, signed=False)
    return _bsm.bitserial_matmul(x_q, planes, 1.0, None, n_bits=n_bits,
                                 out_dtype=torch.int32, signed=False)


@_bitserial_op.register_fake
def _(x_q, planes, n_bits, w4a4):
    return x_q.new_empty((x_q.shape[0], planes.shape[-1]), dtype=torch.int32)


@register_flop_formula(torch.ops.repro_torch.bitserial_matmul_exact)
def _(x_shape, planes_shape, n_bits, w4a4, *args, out_shape=None, **kwargs):
    return 2 * x_shape[0] * planes_shape[-2] * planes_shape[-1]


def bitserial_matmul_exact(x_q: torch.Tensor, planes: torch.Tensor, *,
                           n_bits: int, w4a4: bool = False) -> torch.Tensor:
    """Exact unsigned-integer bit-serial GEMM ``[M, K] x [K, N] -> [M, N]``
    int32: unsigned plane weights (the MSB carries +2^(n-1), the packed word
    engine's operand convention) and the accumulator returned verbatim.
    ``w4a4=True`` takes nibble-packed activations ``[M, ceil(K/2)]``
    (:func:`~repro_torch.kernels.bitserial_matmul.pack_activation_nibbles`)
    through the W4A4 kernel, with unsigned nibbles."""
    return _bitserial_op(x_q, planes, n_bits, w4a4)


def pack_weights(w_q: torch.Tensor, n_bits: int = 8) -> torch.Tensor:
    """Weight-load-time transpose to the byte-packed bit-plane layout: bit
    ``b`` of each uint8 is plane ``b`` of the two's complement over
    ``n_bits`` (``repro.kernels.ref.pack_bitplanes_bytes``)."""
    if not 1 <= n_bits <= 8:
        raise ValueError(f"n_bits must be in 1..8, got {n_bits}")
    return (w_q.to(torch.int64) & ((1 << n_bits) - 1)).to(torch.uint8)


def pack_activations(x_q: torch.Tensor) -> torch.Tensor:
    """Nibble-pack 4-bit activations ``[M, K]`` two per byte for the W4A4
    kernel (the activation-side counterpart of :func:`pack_weights`)."""
    return _bsm.pack_activation_nibbles(x_q)


def _f32(t, device) -> torch.Tensor | None:
    return None if t is None else torch.as_tensor(
        t, dtype=torch.float32, device=device).reshape(-1)


def bitserial_matmul(x_q: torch.Tensor, planes: torch.Tensor, x_scale,
                     w_scale, *, n_bits: int | None = None) -> torch.Tensor:
    """Bit-serial GEMM with the dequantization epilogue: ``f32(sum_b pw[b]
    * (x_q @ plane_b)) * x_scale * w_scale[n]`` with two's-complement plane
    weights (the MSB carries ``-2^(n-1)``).  ``planes`` is the byte-packed
    ``[K, N]`` uint8 of :func:`pack_weights` (pass its ``n_bits``, default
    8) or an unpacked ``[n_bits, K, N]`` {0, 1} stack."""
    return _bsm.bitserial_matmul(x_q, planes, float(x_scale),
                                 _f32(w_scale, x_q.device), n_bits=n_bits,
                                 out_dtype=torch.float32, signed=True)


def bitserial_matmul_a4(x_packed: torch.Tensor, planes: torch.Tensor,
                        x_scale, w_scale, *, k: int) -> torch.Tensor:
    """W4A4 GEMM with the dequantization epilogue: nibble-packed signed
    activations ``[M, ceil(k/2)]`` (:func:`pack_activations`) times
    byte-packed 4-bit weight planes ``[k, N]``; ``k`` is the unpacked inner
    dimension."""
    if planes.shape[0] != k:
        raise ValueError(f"planes have K={planes.shape[0]}, expected k={k}")
    return _bsm.bitserial_matmul_a4(x_packed, planes, float(x_scale),
                                    _f32(w_scale, x_packed.device), n_bits=4,
                                    out_dtype=torch.float32, signed=True)


def quant_matmul_xla(x_q: torch.Tensor, w_q: torch.Tensor, x_scale=1.0,
                     w_scale=None, bias=None) -> torch.Tensor:
    """The W8A8 GEMM's plain version on the operands' device: int32
    accumulation, then ``f32(acc) * x_scale * w_scale[n] + bias[n]``."""
    dev = x_q.device
    N = w_q.shape[1]
    ws = _f32(w_scale, dev)
    if ws is None:
        ws = torch.ones(N, dtype=torch.float32, device=dev)
    elif ws.numel() == 1:
        ws = ws.expand(N).contiguous()
    return _qm.quant_matmul_plain(x_q, w_q, float(x_scale), ws,
                                  _f32(bias, dev))


@torch.library.custom_op("repro_torch::quant_matmul", mutates_args=())
def _quant_op(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: float,
              w_scale: torch.Tensor,
              bias: torch.Tensor | None) -> torch.Tensor:
    return _qm.quant_matmul(x_q, w_q, x_scale, w_scale, bias)


@_quant_op.register_fake
def _(x_q, w_q, x_scale, w_scale, bias):
    return x_q.new_empty((x_q.shape[0], w_q.shape[1]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.quant_matmul)
def _(x_shape, w_shape, *args, out_shape=None, **kwargs):
    return 2 * x_shape[0] * x_shape[1] * w_shape[1]


def quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale,
                 w_scale: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """W8A8 GEMM with the fused dequantization epilogue
    (:mod:`repro_torch.kernels.quant_matmul`)."""
    return _quant_op(x_q, w_q, float(x_scale), w_scale, bias)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> torch.Tensor:
    return _fa.flash_attention(q, k, v, causal=causal)


@_flash_op.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, *args, out_shape=None, **kwargs):
    """The score and P.V products over the (query, key) pairs attended:
    query row i attends keys 0..min(i, Tk - 1) when causal."""
    B, H, Tq, D = q_shape
    Tk = k_shape[2]
    pairs = Tq * Tk
    if causal:
        m = min(Tq, Tk)
        pairs = m * (m + 1) // 2 + (Tq - m) * Tk
    return 4 * B * H * D * pairs


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Tiled GQA attention with an online softmax
    (:mod:`repro_torch.kernels.flash_attention`)."""
    return _flash_op(q, k, v, causal)
