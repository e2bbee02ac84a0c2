"""qwen1.5-0.5b — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936.

A copy of the reference row.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    attn_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)
