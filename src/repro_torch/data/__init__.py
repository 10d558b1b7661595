"""Deterministic synthetic training data (twin of ``repro.data``)."""
