"""Parallel plans and activation layouts (counterpart of ``repro.parallel``)."""
