"""Flash attention (online softmax, GQA, causal and sliding-window masks):
CUDA kernel, plain version, launch count.

Replaces ``flash_attention_pallas`` (``src/repro/kernels/flash_attention.py``),
whose grid ``(B, Hq, L/128, L/128)`` runs in order on one TPU core and
carries the running max, denominator and accumulator in VMEM scratch across
the innermost KV dimension.  On the card the CTAs run in no order, so the KV
sweep is a loop inside one CTA.

Kernel (``csrc/flash_attention.cu``): one CTA per (64-row query tile, query
head, batch); it stages its query tile once and walks the KV tiles of 64
keys in ascending order, staging K (transposed) and V as float32 in dynamic
shared memory and keeping ``m``, ``l`` and ``acc`` in registers.  The loop's
bounds skip the tiles the causal or window mask excludes.  Masking is the
TPU kernel's finite ``-1e30`` with probabilities zeroed where masked, and a
row with a zero denominator gives 0.  Keys past ``L`` are masked and query
rows past ``L`` are not stored, so any ``L`` works.  bf16 or float32 in,
float32 FMAs on the CUDA cores, output in the input type.

Bound on the H100: operations, ``4 B Hq pairs D`` flops for the (query,
key) pairs the mask allows, at the 989e12 bf16 tensor-core flop/s; q, k, v
and o moved once at 3.35e12 B/s take about a sixth of that at granite-3-8b's
layer shape.  This first version issues its products as float32 FMAs on the
CUDA cores, a fifteenth of that rate, so it stays above 14x its bound;
``wgmma`` on bf16 tiles is the redesign.
"""

from __future__ import annotations

import ctypes
import torch

from . import _build
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_plain", "HEAD_DIMS"]

#: the plain version the wrapper takes for a CPU tensor
flash_attention_plain = flash_attention_ref

#: head dimensions the kernel is built for
HEAD_DIMS = (64, 128)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Softmax attention of ``q`` ``[B, Hq, L, D]`` over ``k``, ``v`` ``[B, Hkv, L, D]``.

    Query head ``h`` reads KV head ``h // (Hq / Hkv)``; ``causal`` masks keys
    after the query, ``window > 0`` keys at or before ``query - window``;
    the logits are scaled by ``D**-0.5``.  Returns ``[B, Hq, L, D]`` in ``q``'s
    dtype.  A CPU tensor runs the plain version (which also takes ``Lq !=
    Lk``); a CUDA tensor launches the kernel or raises.
    """
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q [B, Hq, L, D], k and v [B, Hkv, L, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, lq, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k and v {tuple(k.shape)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check_cuda(q, k, v)
    out = torch.empty_like(q)
    fn = _build.kernel_fn("flash_attention", "flash_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, lq, d,
                 _DTYPES[q.dtype], int(bool(causal)), int(window), stream)
    _build.check(err, "flash_attention_launch")
    flash_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0
flash_attention.launches = 0


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The kernel's argument contract; raises on anything it does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"q must be on a CUDA device or the CPU, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is {q.dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for head dims {HEAD_DIMS}, got {q.shape[3]}")
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"the kernel is self-attention (Lq == Lk), got Lq {q.shape[2]} and "
                         f"Lk {k.shape[2]}")
    if q.shape[0] > 65535 or q.shape[1] > 65535:
        raise ValueError(f"batch and heads must each be at most 65535, got {tuple(q.shape[:2])}")
