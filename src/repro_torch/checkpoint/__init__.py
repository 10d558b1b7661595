"""Atomic, async checkpoints of the port's trees (twin of
``repro.checkpoint``)."""
