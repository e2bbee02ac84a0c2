"""Test support shipped with the port: deterministic fault injection, and
tolerances in bf16 steps."""

from . import faults  # noqa: F401

__all__ = ["faults"]
