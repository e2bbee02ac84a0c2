"""rwkv6-3b — Finch, data-dependent decay [arXiv:2404.05892; hf].

Attention-free: every block is an RWKV6 time-mix + channel-mix pair.
32L d_model=2560 d_ff=8960 vocab=65536; head_dim 64 -> 40 wkv heads.

A copy of the reference row.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    block_pattern=("rwkv",),
    act="swiglu",  # channel-mix uses squared-relu internally; d_ff honored
    source="arXiv:2404.05892; hf",
)
