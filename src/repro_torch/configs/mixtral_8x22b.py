"""mixtral-8x22b — 8 experts top-2, SWA [arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2,
sliding window 4096.  8 experts do not divide the 16-way model axis, so
experts are TP-sharded (d_ff split over the model axis) — see DESIGN.md §5;
SWA bounds the KV cache, making long_500k runnable.

A copy of the reference row.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    experts_per_token=2,
    moe_sharding="tp",
    window=4096,
    source="arXiv:2401.04088; hf",
)
