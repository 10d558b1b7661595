"""Execution-cache-memory pricing for the port (twin of ``repro.ecm``, in
part): the H100 figures and the one forecast the serving engine reads,
the restore-vs-reprefill gate of the session spill tier."""
