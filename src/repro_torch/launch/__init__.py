"""Command-line launchers (twin of ``repro.launch``)."""
