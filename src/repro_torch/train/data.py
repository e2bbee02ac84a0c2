"""Deterministic synthetic token stream: shardable and resumable.

Counterpart of ``repro/train/data.py``.  A batch is a pure function of
``(seed, step)``, so a restarted job regenerates exactly the stream it
would have seen: resuming needs no data-loader state beyond the step
counter.  Tokens follow a Zipf-like law (inverse CDF over the vocabulary),
drawn from the port's threefry keys (``core/prng.py``), bit for bit the
reference's ``jax.random.uniform``, on the batch's device.

A token is ``ranks * V`` truncated, where ``ranks`` reaches 2^31 / V and
more: one ulp of ``log`` or ``exp`` moves a token.  So the stream computes
the two functions as the reference's XLA lowers them on the CPU, not as
torch does (torch's differ from XLA's in about 14% and 9% of float32
inputs): Eigen's Cephes-style polynomials, each multiply that feeds one add
contracted into an FMA, and denormals flushed to zero.  An FMA is computed
in float64, where the product of two float32 values is exact, and rounded
once to float32: the FMA's own result unless the float64 sum both rounds
and lands on a float32 tie (no such input among the tests' million).  The
same float operations run on the card, so both devices give the
reference's CPU stream.

The reference's ``(ranks * V).astype(int32)`` saturates in XLA: a float
past 2^31 becomes 2147483647 (NaN becomes 0).  torch's cast wraps those
floats to -2^31 instead, so the ranks are clamped to the int32 range, in
float64, before the cast; about 11% of a 49,152-token vocabulary's stream
is then token ``2147483647 % 49152 = 32767``, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Union

import torch

from ..core import prng
from ..device import resolve_device

__all__ = ["DataConfig", "synthetic_batch", "data_iterator"]

_INT32_MAX = 2 ** 31 - 1
_FLT_MIN = 1.1754943508222875e-38  # the smallest normal float32


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (see the module docstring).
    Constants here are float32 values written out in full."""
    a, b, c = (x.double() if torch.is_tensor(x) else x for x in (a, b, c))
    return (a * b + c).float()


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` as XLA's CPU lowering computes it (Eigen's ``plog``)."""
    x = torch.where(x.abs() < _FLT_MIN, torch.zeros_like(x), x)  # denormals are zero
    bits = torch.clamp(x, min=_FLT_MIN).view(torch.int32)
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)  # mantissa in [0.5, 1)
    small = m < 0.7071067690849304  # sqrt(1/2) in float32
    e = ((bits >> 23) - 127).float() + 1.0 - small.float()
    r = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    r2 = r * r
    r3 = r2 * r
    y = _fma(r, 0.07037683576345444, -0.11514610052108765)
    y1 = _fma(r, -0.12420140951871872, 0.14249323308467865)
    y2 = _fma(r, 0.2000071406364441, -0.24999994039535522)
    y = _fma(y, r, 0.11676998436450958)
    y1 = _fma(y1, r, -0.16668057441711426)
    y2 = _fma(y2, r, 0.3333333134651184)
    y = _fma(y, r3, y1)
    y = _fma(y, r3, y2)
    y = _fma(y, r3, e * -0.00021219444170128554)
    out = _fma(e, 0.693359375, _fma(-0.5, r2, r) + y)
    out = torch.where(~(x > 0), torch.full_like(out, float("nan")), out)  # NaN too
    out = torch.where(x == 0, torch.full_like(out, float("-inf")), out)
    return torch.where(x == float("inf"), x, out)


def _xla_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` as XLA's CPU lowering computes it (Eigen's ``pexp``)."""
    x = torch.clamp(x, -87.80000305175781, 88.80000305175781)
    fx = torch.clamp(torch.floor(_fma(x, 1.4426950216293335, 0.5)), -127.0, 127.0)
    x = _fma(-fx, 0.693359375, x)
    x = _fma(-fx, -0.00021219444170128554, x)
    y = _fma(x, 0.00019875691214110702, 0.001398199936375022)
    for c in (0.008333452045917511, 0.04166579619050026, 0.1666666567325592, 0.5):
        y = _fma(y, x, c)
    y = _fma(y, x * x, x) + 1.0
    out = y * ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(out.abs() < _FLT_MIN, torch.zeros_like(out), out)  # flushed


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    zipf_alpha: float = 1.2


def _saturating_int32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float -> int32 conversion: truncation, clamped to the int32
    range, NaN to 0."""
    x = torch.nan_to_num(x.double(), nan=0.0, posinf=_INT32_MAX, neginf=-_INT32_MAX - 1)
    return x.clamp(-_INT32_MAX - 1, _INT32_MAX).to(torch.int32)


def synthetic_batch(cfg: DataConfig, step: int,
                    device: Optional[Union[str, torch.device]] = None) -> dict:
    """The batch of ``step``: ``{"tokens": int32 [global_batch, seq_len]}`` on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""
    dev = resolve_device(device)
    key = prng.fold_in(prng.key(cfg.seed), step)
    u = prng.uniform(key, (cfg.global_batch, cfg.seq_len), minval=1e-6, device=dev)
    # the exponent is the reference's Python float, rounded to float32 as a
    # weakly typed scalar is
    inv = torch.tensor(1.0 - cfg.zipf_alpha, dtype=torch.float32, device=dev)
    ranks = _xla_exp(_xla_log(u) / inv)  # heavy-tailed, >= 1
    v = torch.tensor(float(cfg.vocab_size), dtype=torch.float32, device=dev)
    tokens = torch.remainder(_saturating_int32(ranks * v), cfg.vocab_size)
    return {"tokens": tokens}


def data_iterator(cfg: DataConfig, start_step: int = 0,
                  device: Optional[Union[str, torch.device]] = None) -> Iterator[dict]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, step, device)
        step += 1
