"""TF32: the precision below the float32 (TF32 off) the configurations
state. Inside `tf32()`, the result of every PyTorch operation that gives
a float32 tensor is rounded to TF32's 10 mantissa bits (nearest, ties to
even; inf and NaN kept), so the reference computes as a card would that
ran its float32 arithmetic through TF32.
"""
from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

_KEEP = 13  # float32 has 23 mantissa bits, TF32 10


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.view(torch.int32)
    lsb = (bits >> _KEEP) & 1
    rounded = ((bits + ((1 << (_KEEP - 1)) - 1) + lsb)
               & ~((1 << _KEEP) - 1)).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def _round_all(out):
    if isinstance(out, torch.Tensor):
        return round_tf32(out) if out.dtype == torch.float32 else out
    if isinstance(out, tuple):
        vals = [_round_all(o) for o in out]
        return type(out)(*vals) if hasattr(out, "_fields") else tuple(vals)
    if isinstance(out, list):
        return [_round_all(o) for o in out]
    return out


class tf32(TorchFunctionMode):
    """Round every float32 result to TF32 while the mode is on."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.Tensor.__setitem__, torch.Tensor.view):
            return out
        return _round_all(out)
