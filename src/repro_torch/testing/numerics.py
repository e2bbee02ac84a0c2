"""Tolerances stated in units of the working type, for holding a bf16
kernel against its float32 plain version."""

from __future__ import annotations

import torch

__all__ = ["bf16_ulp", "bf16_excess"]


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at ``|x|`` (float32; 0 where ``x`` is 0).

    bf16 keeps 8 significant bits: in ``[2^(e-1), 2^e)`` its values are
    ``2^(e-8)`` apart."""
    x = x.float()
    _, e = torch.frexp(x)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


def bf16_excess(got: torch.Tensor, want: torch.Tensor, atol: float = 0.0) -> float:
    """The largest ``|got - want|`` beyond one bf16 step of ``want`` plus
    ``atol``; 0.0 means every element is within that tolerance."""
    err = (got.float() - want.float()).abs() - bf16_ulp(want) - atol
    return max(err.max().item(), 0.0) if err.numel() else 0.0
