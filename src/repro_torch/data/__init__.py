"""Deterministic synthetic batches (counterpart of ``repro.data``)."""
