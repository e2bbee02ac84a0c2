"""Workload configurations (data copies of the reference rows)."""
