"""The control's precision: the step below the configuration's bf16.

``fp8`` rounds a tensor to float8 e4m3 under one scale a tensor (its largest
magnitude onto e4m3's largest finite value, 448), as an fp8 product takes
its operands; the gradient passes the rounding unchanged.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    xd = x.detach()
    scale = xd.abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (xd / scale).to(torch.float8_e4m3fn).to(xd.dtype) * scale
    return x + (q - xd) if x.requires_grad else q
