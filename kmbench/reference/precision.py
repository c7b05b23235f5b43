"""Operand precisions, emulated by rounding float32 values.

``Precision(conv, geometry)``: ``conv`` is the precision of the U-Net's
convolution operands (``bf16``, or ``fp8``: e4m3 with one scale per tensor,
its largest magnitude at 448), ``geometry`` that of the fits', flows' and
warp's products (``fp32``, or ``tf32``: a 10-bit mantissa, rounded to
nearest even). Activations are stored in bf16 in both. Rounding passes the
gradient through unchanged (the gradient is taken in float32).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Precision:
    conv: str = "bf16"
    geometry: str = "fp32"

    def __post_init__(self):
        if self.conv not in ("bf16", "fp8") or self.geometry not in ("fp32", "tf32"):
            raise ValueError(f"precision {self}")

    def conv_operand(self, x):
        return through(x, to_fp8 if self.conv == "fp8" else to_bf16)

    def geo_operand(self, x):
        return through(x, to_tf32) if self.geometry == "tf32" else x


REFERENCE = Precision("bf16", "fp32")
CONTROL = Precision("fp8", "tf32")


def through(x, rounding):
    """``rounding(x)`` forward, the identity backward."""
    if not x.requires_grad:
        return rounding(x)
    return x + (rounding(x.detach()) - x.detach())


def store(x):
    """Storage of an activation in bf16."""
    return through(x, to_bf16)


def to_bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def to_fp8(x):
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def to_tf32(x):
    """float32 -> the nearest TF32 value (round to nearest even on the 13
    low mantissa bits), as float32."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def mm(a, b, prec: Precision):
    """``a @ b`` with the geometry's operand precision."""
    return prec.geo_operand(a) @ prec.geo_operand(b)


def exact_fp32():
    """Turn TF32 off for float32 matmuls and convolutions: the reference
    states float32, and a lower precision is emulated above, never taken
    from the global switches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
