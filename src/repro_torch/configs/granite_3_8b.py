"""granite-3-8b — GQA dense (a copy of the reference row).

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.  The widths are
IBM's Granite 3.0 8B; the row's ``source`` names the 2B base model, as the
reference's does.  Like the reference, the port models it as a plain
llama-style decoder, without Granite's embedding, residual, attention and
logit multipliers.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
)
