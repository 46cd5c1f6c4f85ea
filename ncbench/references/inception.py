"""Plain reference of the emulated Inception v3 forward (Neural Cache §IV-D).

Works out, from the float weights and the float images alone, what the
bit-serial emulation has to serve: the per-layer weight quantization, each
convolution's exact integer accumulator, the bias add and ReLU, the
per-image dynamic range, the fixed-point requantization, the pools, the
per-image requantizing concatenation and the FC logits.

Written in plain PyTorch; it imports nothing of the program.  The network
table below is a frozen copy of Inception v3's published structure
(Szegedy et al. 2016, TF-slim layer names).  Integer convolutions run in
float64, which holds every partial sum exactly (|x - zx|, |w - zw| <= 255
and K <= 4032, so every sum stays below 2^53); cuDNN is switched off around
them so that no FFT or Winograd algorithm rounds.  The scalar steps
(quantization parameters, fixed-point multipliers) are float32 on the host
with round-half-even, as the paper's host side computes them.

``bits`` selects the operand precision: 8 is the configuration's, and the
control of the benchmark's comparison runs the same code at 4.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

# op = ("conv", R, S, M, stride, pad) | ("maxpool"|"avgpool", R, stride, pad)
#    | ("split", [ops], [ops])
STEM = (
    ("Conv2d_1a_3x3", ("conv", 3, 3, 32, 2, "VALID")),
    ("Conv2d_2a_3x3", ("conv", 3, 3, 32, 1, "VALID")),
    ("Conv2d_2b_3x3", ("conv", 3, 3, 64, 1, "SAME")),
    ("MaxPool_3a_3x3", ("maxpool", 3, 2, "VALID")),
    ("Conv2d_3b_1x1", ("conv", 1, 1, 80, 1, "VALID")),
    ("Conv2d_4a_3x3", ("conv", 3, 3, 192, 1, "VALID")),
    ("MaxPool_5a_3x3", ("maxpool", 3, 2, "VALID")),
)


def _block_a(pool_proj):
    return ([("conv", 1, 1, 64, 1, "SAME")],
            [("conv", 1, 1, 48, 1, "SAME"), ("conv", 5, 5, 64, 1, "SAME")],
            [("conv", 1, 1, 64, 1, "SAME"), ("conv", 3, 3, 96, 1, "SAME"),
             ("conv", 3, 3, 96, 1, "SAME")],
            [("avgpool", 3, 1, "SAME"), ("conv", 1, 1, pool_proj, 1, "SAME")])


def _block_ra():
    return ([("conv", 3, 3, 384, 2, "VALID")],
            [("conv", 1, 1, 64, 1, "SAME"), ("conv", 3, 3, 96, 1, "SAME"),
             ("conv", 3, 3, 96, 2, "VALID")],
            [("maxpool", 3, 2, "VALID")])


def _block_b(c7):
    return ([("conv", 1, 1, 192, 1, "SAME")],
            [("conv", 1, 1, c7, 1, "SAME"), ("conv", 1, 7, c7, 1, "SAME"),
             ("conv", 7, 1, 192, 1, "SAME")],
            [("conv", 1, 1, c7, 1, "SAME"), ("conv", 7, 1, c7, 1, "SAME"),
             ("conv", 1, 7, c7, 1, "SAME"), ("conv", 7, 1, c7, 1, "SAME"),
             ("conv", 1, 7, 192, 1, "SAME")],
            [("avgpool", 3, 1, "SAME"), ("conv", 1, 1, 192, 1, "SAME")])


def _block_rb():
    return ([("conv", 1, 1, 192, 1, "SAME"), ("conv", 3, 3, 320, 2, "VALID")],
            [("conv", 1, 1, 192, 1, "SAME"), ("conv", 1, 7, 192, 1, "SAME"),
             ("conv", 7, 1, 192, 1, "SAME"), ("conv", 3, 3, 192, 2, "VALID")],
            [("maxpool", 3, 2, "VALID")])


def _block_c():
    split = ("split", [("conv", 1, 3, 384, 1, "SAME")],
             [("conv", 3, 1, 384, 1, "SAME")])
    return ([("conv", 1, 1, 320, 1, "SAME")],
            [("conv", 1, 1, 384, 1, "SAME"), split],
            [("conv", 1, 1, 448, 1, "SAME"), ("conv", 3, 3, 384, 1, "SAME"),
             split],
            [("avgpool", 3, 1, "SAME"), ("conv", 1, 1, 192, 1, "SAME")])


MIXED = (
    ("Mixed_5b", _block_a(32)), ("Mixed_5c", _block_a(64)),
    ("Mixed_5d", _block_a(64)), ("Mixed_6a", _block_ra()),
    ("Mixed_6b", _block_b(128)), ("Mixed_6c", _block_b(160)),
    ("Mixed_6d", _block_b(160)), ("Mixed_6e", _block_b(192)),
    ("Mixed_7a", _block_rb()), ("Mixed_7b", _block_c()),
    ("Mixed_7c", _block_c()),
)


def _scale(op, div):
    if op[0] == "conv":
        return op[:3] + (max(1, op[3] // div),) + op[4:]
    if op[0] == "split":
        return ("split",) + tuple([_scale(o, div) for o in sub]
                                  for sub in op[1:])
    return op


def network(cfg: dict):
    """``(stem, mixed)`` of the configuration ``cfg`` (its ``width_div``
    and ``mixed`` block names, ``"all"`` for every block)."""
    div = int(cfg.get("width_div", 1))
    keep = cfg.get("mixed", "all")
    stem = tuple((n, _scale(op, div)) for n, op in STEM)
    mixed = tuple((n, tuple([_scale(op, div) for op in br] for br in brs))
                  for n, brs in MIXED if keep == "all" or n in keep)
    return stem, mixed


def _out(h, r, stride, pad):
    return -(-h // stride) if pad == "SAME" else (h - r) // stride + 1


def _same_pad(h, r, stride):
    """TF SAME: total pad so that out = ceil(h / stride), the extra row
    after."""
    total = max((-(-h // stride) - 1) * stride + r - h, 0)
    return total // 2, total - total // 2


def layer_shapes(cfg: dict):
    """Every conv and FC layer of ``cfg`` in execution order, as ``(name,
    R, S, C, M, E, F)`` (E, F: output height and width)."""
    stem, mixed = network(cfg)
    out = []

    def op_shapes(name, op, h, c):
        if op[0] == "conv":
            _, r, s, m, stride, pad = op
            e = _out(h, max(r, s), stride, pad)
            out.append((name, r, s, c, m, e, e))
            return e, m
        if op[0] in ("maxpool", "avgpool"):
            return _out(h, op[1], op[2], op[3]), c
        cs = 0
        for i, sub in enumerate(op[1:]):
            hh, cc = h, c
            for j, sop in enumerate(sub):
                hh, cc = op_shapes(f"{name}_s{i}_{j}", sop, hh, cc)
            cs += cc
        return hh, cs

    h, c = int(cfg["img"]), 3
    for name, op in stem:
        h, c = op_shapes(name, op, h, c)
    for bname, brs in mixed:
        cs = 0
        for bi, br in enumerate(brs):
            hh, cc = h, c
            for oi, op in enumerate(br):
                hh, cc = op_shapes(f"{bname}_b{bi}_{oi}", op, hh, cc)
            cs += cc
        h, c = hh, cs
    out.append(("FullyConnected", 1, 1, c, int(cfg["classes"]), 1, 1))
    return out


# ---------------------------------------------------------------------------
# Host scalar steps: float32, round-half-even.
# ---------------------------------------------------------------------------
def f32(x) -> float:
    return float(torch.tensor(float(x), dtype=torch.float32))


def qparams(x_min, x_max, bits):
    """(scale, zero_point) of an unsigned affine range that holds 0."""
    lo = torch.minimum(torch.tensor(float(x_min), dtype=torch.float32),
                       torch.tensor(0.0))
    hi = torch.maximum(torch.tensor(float(x_max), dtype=torch.float32),
                       torch.tensor(0.0))
    qmax = (1 << bits) - 1
    scale = (hi - lo) / qmax
    scale = torch.where(scale <= 0, torch.tensor(1.0), scale)
    zp = torch.clamp(torch.round(0 - lo / scale), 0, qmax)
    return float(scale), int(zp)


def multiplier(real):
    """``real`` as a 31-bit fixed-point mantissa and right shift, computed
    in float32 (log2 as log(x) / ln 2, the ceiling of it the exponent)."""
    x = torch.tensor(float(real), dtype=torch.float32)
    exp = math.ceil(float(torch.log(x) * torch.tensor(1.0 / math.log(2.0),
                                                      dtype=torch.float32)))
    shift = 31 - exp
    m = torch.round(x * torch.pow(torch.tensor(2.0), torch.tensor(
        float(shift), dtype=torch.float32)))
    m = torch.clamp(m, 0, (1 << 31) - 1)
    return min(int(m), (1 << 31) - 1), shift


def requant(acc, real, zp, bits):
    """Integer requantization of an int64 tensor: multiply, round-shift,
    add the zero point, clip to the unsigned range."""
    m, s = multiplier(real)
    out = (acc * m + (1 << (s - 1))) >> s
    return torch.clamp(out + zp, 0, (1 << bits) - 1)


# ---------------------------------------------------------------------------
# The forward.  Activations: int64 [N, H, W, C] with per-image (scale, zp).
# ---------------------------------------------------------------------------
class _Net:
    def __init__(self, params, cfg, bits):
        self.cfg, self.bits = cfg, bits
        self.w = {}
        qmax = (1 << bits) - 1
        for name, *_ in layer_shapes(cfg):
            p = params[name]
            wf = p["w"].to(torch.float32) * p["scale"].to(torch.float32)
            scale, zp = qparams(float(wf.min()), float(wf.max()), bits)
            # a true float32 division: a tensor divisor, since CUDA divides
            # by a Python float as a multiply by its reciprocal, which
            # rounds some quotients otherwise
            div = torch.tensor(f32(scale), dtype=torch.float32,
                               device=wf.device)
            wq = torch.round(wf / div).to(torch.int64) + zp
            wq = torch.clamp(wq, 0, qmax)
            self.w[name] = (wq - zp, scale, p["bias"].to(torch.float32))

    def conv(self, name, x, qps, op):
        _, r, s, m, stride, pad = op
        wc, w_scale, bias = self.w[name]
        N = x.shape[0]
        zx = torch.tensor([z for _, z in qps], dtype=torch.int64,
                          device=x.device)
        xc = (x - zx[:, None, None, None]).to(torch.float64)
        if pad == "SAME":
            ph, pw = (_same_pad(x.shape[1], r, stride),
                      _same_pad(x.shape[2], s, stride))
            xc = F.pad(xc, (0, 0) + pw + ph)
        flags = (torch.backends.cudnn.flags(enabled=False)
                 if x.is_cuda else contextlib.nullcontext())
        with flags:
            acc = F.conv2d(xc.permute(0, 3, 1, 2),
                           wc.to(torch.float64).permute(3, 2, 0, 1),
                           stride=stride)
        acc = acc.permute(0, 2, 3, 1).round().to(torch.int64)
        sxw = [f32(sc * w_scale) for sc, _ in qps]
        if name == "FullyConnected":
            return acc.reshape(N, -1), sxw
        sxw_t = torch.tensor(sxw, dtype=torch.float64, device=x.device)
        bias_q = torch.round(bias.to(torch.float64)[None, :] / sxw_t[:, None])
        acc = torch.clamp_min(acc + bias_q.to(torch.int64)[:, None, None, :], 0)
        flat = acc.reshape(N, -1)
        mins, maxs = flat.amin(1).tolist(), flat.amax(1).tolist()
        ys, out_qps = [], []
        for n in range(N):
            qp = qparams(mins[n] * sxw[n], maxs[n] * sxw[n], self.bits)
            ys.append(requant(acc[n], sxw[n] / qp[0], qp[1], self.bits))
            out_qps.append(qp)
        return torch.stack(ys), out_qps

    @staticmethod
    def pool(x, op):
        kind, r, stride, pad = op
        ph = _same_pad(x.shape[1], r, stride) if pad == "SAME" else (0, 0)
        pw = _same_pad(x.shape[2], r, stride) if pad == "SAME" else (0, 0)
        xp = F.pad(x.to(torch.float64), (0, 0) + pw + ph).permute(0, 3, 1, 2)
        if kind == "maxpool":  # pads with 0, the unsigned minimum
            return (F.max_pool2d(xp, r, stride).permute(0, 2, 3, 1)
                    .to(torch.int64))
        ones = F.pad(torch.ones((1, 1, x.shape[1], x.shape[2]),
                                dtype=torch.float64, device=x.device),
                     pw + ph)
        sums = F.avg_pool2d(xp, r, stride, divisor_override=1).round()
        cnt = F.avg_pool2d(ones, r, stride, divisor_override=1).round()
        sums, cnt = sums.to(torch.int64), cnt.to(torch.int64)
        out = torch.div(sums + cnt // 2, cnt, rounding_mode="floor")
        return torch.clamp(out, 0, 255).permute(0, 2, 3, 1)

    def concat(self, outs):
        """Per image, every branch requantized to the common range."""
        N = outs[0][0].shape[0]
        qmax = (1 << self.bits) - 1
        qps_c = []
        pieces = [[None] * N for _ in outs]
        for n in range(N):
            lo = min(f32((0 - qps[n][1]) * qps[n][0]) for _, qps in outs)
            hi = max(f32((qmax - qps[n][1]) * qps[n][0]) for _, qps in outs)
            qc = qparams(lo, hi, self.bits)
            for i, (y, qps) in enumerate(outs):
                pieces[i][n] = requant(y[n] - qps[n][1], qps[n][0] / qc[0],
                                       qc[1], self.bits)
            qps_c.append(qc)
        return torch.cat([torch.stack(p) for p in pieces], dim=-1), qps_c

    def op(self, name, op, x, qps):
        if op[0] == "conv":
            return self.conv(name, x, qps, op)
        if op[0] in ("maxpool", "avgpool"):
            return self.pool(x, op), qps
        outs = []
        for i, sub in enumerate(op[1:]):
            y, q = x, qps
            for j, sop in enumerate(sub):
                y, q = self.op(f"{name}_s{i}_{j}", sop, y, q)
            outs.append((y, q))
        return self.concat(outs)

    def forward(self, images):
        qmax = (1 << self.bits) - 1
        x = torch.clamp(torch.round(images.to(torch.float32) * float(qmax)),
                        0, qmax).to(torch.int64)
        qps = [(f32(1.0 / qmax), 0)] * x.shape[0]
        stem, mixed = network(self.cfg)
        for name, op in stem:
            x, qps = self.op(name, op, x, qps)
        for bname, brs in mixed:
            outs = []
            for bi, br in enumerate(brs):
                y, q = x, qps
                for oi, op in enumerate(br):
                    y, q = self.op(f"{bname}_b{bi}_{oi}", op, y, q)
                outs.append((y, q))
            x, qps = self.concat(outs)
        x = self.pool(x, ("avgpool", x.shape[1], 1, "VALID"))
        acc, sxw = self.conv("FullyConnected", x, qps,
                             ("conv", 1, 1, 0, 1, "VALID"))
        sxw_t = torch.tensor(sxw, dtype=torch.float32, device=acc.device)
        logits = acc.to(torch.float32) * sxw_t[:, None]
        return logits + self.w["FullyConnected"][2][None, :]


def logits(params: dict, images: torch.Tensor, cfg: dict, *, bits: int = 8,
           block: int = 8) -> torch.Tensor:
    """Reference logits ``[N, classes]`` float32 of ``images`` ``[N, H, W,
    3]`` (float32 in [0, 1]) under the float weights ``params``
    (``{name: {"w": [R, S, C, M], "scale": [M], "bias": [M]}}``), computed
    on the images' device in blocks of ``block`` images."""
    net = _Net(params, cfg, bits)
    return torch.cat([net.forward(images[i:i + block])
                      for i in range(0, images.shape[0], block)])
