"""Test support shipped with the port: deterministic fault injection."""
