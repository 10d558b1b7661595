"""The training step and loop (twin of ``repro.train``)."""
