"""Test support shipped with the port: deterministic fault injection, and
tolerances in bf16 steps."""
