"""Analysis helpers: the per-stage compute estimates the overlap-aware
planner hides switches behind."""
