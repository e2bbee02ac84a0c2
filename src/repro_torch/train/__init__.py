"""Training-side utilities the counting path shares: checkpointing."""
