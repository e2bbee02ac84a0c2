"""recurrentgemma-2b — RG-LRU + local attn, 1:2 [arXiv:2402.19427; hf].

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000; block pattern is
two RG-LRU recurrent blocks per local-attention block (window 2048).
head_dim 256 (10 x 256 = 2560).

A copy of the reference row.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    act="gelu",
    source="arXiv:2402.19427; hf",
)
