"""The optimizer layer (twin of ``repro.optim``): AdamW with the Kahan
carry (``adamw``) and microbatch gradient accumulation with fused
gradient statistics (``accumulate``)."""
