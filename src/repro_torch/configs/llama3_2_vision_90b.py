"""llama-3.2-vision-90b — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; every 5th layer
is a cross-attention block over stub-provided image-patch embeddings
(frontend is a stub per the task spec: input_specs() supplies precomputed
patch embeddings).

A copy of the reference row.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=("attn", "attn", "attn", "attn", "cross"),
    num_image_tokens=1600,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
