"""phi3.5-moe-42b-a6.6b — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2.
Experts shard exactly over the 16-way model axis (EP) — the arch where the
paper's pipelined all-to-all applies most directly (DESIGN.md §5).

A copy of the reference row.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_token=2,
    moe_sharding="ep",
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
)
