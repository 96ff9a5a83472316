"""Roundings for the controls: the reference computed one precision below
what the configuration states.

* ``tf32``: float32 rounded to TF32's 10 mantissa bits (round to nearest),
  the step below float32 (the reconstruction's float32 chain).
* ``fp8``: per-tensor scaled float8 e4m3 (the largest magnitude maps to
  448), the step below bfloat16 (the transcription's and the training
  step's bfloat16 chains).
* ``bf16``: float32 rounded to bfloat16 (round to nearest even). Not a
  control: ``calibrate.py --look`` runs the reference in the precision
  the training step stores its operands in, to tell the step's rounding
  from a fault.

Each is an autograd function: the forward rounds the tensor, and the
backward rounds the gradient it passes on the same way, so a training
step under a control computes its gradients in that precision too.
"""

import torch

__all__ = ["ROUNDINGS", "round_tf32", "round_fp8", "round_bf16"]


def round_tf32(x):
    """float32 -> the nearest value with a 10-bit mantissa, as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x):
    """float32 -> per-tensor scaled float8 e4m3 and back to float32."""
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def round_bf16(x):
    """float32 -> the nearest bfloat16, as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rounding):
        ctx.rounding = rounding
        return rounding(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.rounding(grad), None


def _quant(rounding):
    def quant(x):
        return _Round.apply(x, rounding)

    return quant


ROUNDINGS = {"tf32": _quant(round_tf32), "fp8": _quant(round_fp8),
             "bf16": _quant(round_bf16)}
