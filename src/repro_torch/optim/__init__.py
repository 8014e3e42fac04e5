"""AdamW with float32 state (counterpart of ``repro.optim``)."""
