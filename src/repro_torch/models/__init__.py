"""Model code: plain functions on tensors over parameter dicts."""
