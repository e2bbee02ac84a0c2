"""Roofline analysis of dry-run records against the H100 (:mod:`.analysis`)."""
