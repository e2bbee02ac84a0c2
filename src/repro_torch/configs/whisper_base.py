"""whisper-base — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

6L encoder + 6L decoder, d_model=512 8H d_ff=2048 vocab=51865.  The conv
frontend is a stub: input_specs() provides precomputed frame embeddings fed
straight to the encoder.  Decoder cross-attends to the encoder output.

A copy of the reference row.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    encoder_layers=6,
    encoder_context=1500,
    block_pattern=("attn", "cross"),
    act="gelu",
    source="arXiv:2212.04356; unverified",
)
