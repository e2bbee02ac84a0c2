"""Configurations (data copies of the reference rows): the counting
workloads (``subgraph``) and the language-model architectures
(``get_arch``)."""

from .base import SHAPES, ArchConfig, ShapeSpec, ShardingConfig  # noqa: F401
from . import (
    granite_3_8b,
    internlm2_1_8b,
    llama3_2_vision_90b,
    mixtral_8x22b,
    phi3_5_moe,
    qwen1_5_0_5b,
    recurrentgemma_2b,
    rwkv6_3b,
    smollm_360m,
    whisper_base,
)
from .subgraph import (  # noqa: F401
    COUNTING_CONFIGS,
    SERVICE_WORKLOADS,
    CountingConfig,
    ServiceWorkloadConfig,
)

__all__ = ["ARCHS", "ArchConfig", "COUNTING_CONFIGS", "CountingConfig", "SERVICE_WORKLOADS",
           "SHAPES", "ServiceWorkloadConfig", "ShapeSpec", "ShardingConfig", "get_arch"]

#: every reference row, in the reference registry's order
ARCHS = {
    c.name: c
    for c in (
        rwkv6_3b.CONFIG,
        internlm2_1_8b.CONFIG,
        smollm_360m.CONFIG,
        qwen1_5_0_5b.CONFIG,
        granite_3_8b.CONFIG,
        phi3_5_moe.CONFIG,
        mixtral_8x22b.CONFIG,
        llama3_2_vision_90b.CONFIG,
        whisper_base.CONFIG,
        recurrentgemma_2b.CONFIG,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
