"""Configurations (data copies of the reference rows): the counting
workloads (``subgraph``) and the language-model architectures
(``get_arch``)."""

from .base import SHAPES, ArchConfig, ShapeSpec  # noqa: F401
from . import granite_3_8b, internlm2_1_8b, qwen1_5_0_5b, smollm_360m

__all__ = ["ARCHS", "ArchConfig", "SHAPES", "ShapeSpec", "get_arch"]

#: the dense rows, every block of which the port runs
ARCHS = {
    c.name: c
    for c in (
        internlm2_1_8b.CONFIG,
        smollm_360m.CONFIG,
        qwen1_5_0_5b.CONFIG,
        granite_3_8b.CONFIG,
    )
}

#: the reference registry's other rows, and the ROADMAP queue 1 item each
#: waits for (the first of its blocks the port does not run yet)
WAITING = {
    "rwkv6-3b": "item 13 (rwkv6 blocks)",
    "phi3.5-moe-42b-a6.6b": "item 12 (moe)",
    "mixtral-8x22b": "item 12 (moe)",
    "llama-3.2-vision-90b": "item 11 (cross-attention)",
    "whisper-base": "item 15 (the whisper encoder)",
    "recurrentgemma-2b": "item 14 (rglru blocks)",
}


def get_arch(name: str) -> ArchConfig:
    if name in WAITING:
        raise NotImplementedError(
            f"{name} is not ported yet: it waits for ROADMAP queue 1 {WAITING[name]}"
        )
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
