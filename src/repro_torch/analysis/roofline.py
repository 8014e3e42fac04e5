"""Per-stage compute estimates for the overlap-aware planner (the part of
``repro.analysis.roofline`` that ``dsp_schedule(overlap=...)`` needs:
``stage_flops``, ``stage_compute_seconds``, ``attach_compute_seconds``).

The peak is one NVIDIA H100's, not the TPU's of the JAX package.  Which
switches the executor runs overlapped does not depend on its value: a
switch is decomposed when its consuming stage has a nonzero estimate
(``Schedule.overlap_mode``).  A plan priced in seconds on a ``Topology``
may depend on it.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM, bf16 dense without sparsity: NVIDIA's H100 data sheet
PEAK_FLOPS = 989e12


def stage_flops(stage, cfg) -> float:
    """Dense FLOPs of one planner stage (global, all ranks), from its
    declared activation shape ``(..., L_i ..., d_model)`` and the config's
    widths, at 2 FLOPs per multiply-add:

    * a mixer stage (``compute_dims`` non-empty): the q/k/v/o projections
      ``8·T·d²`` plus the attention's score and value products
      ``4·T·L·d``, ``L`` the product of the compute dims' extents;
    * otherwise the FFN's ``k·T·d·d_ff``, ``k`` 4 (up + down) or 6 for a
      gated MLP.

    ``T`` is the token count ``prod(shape[:-1])``.  0.0 when the stage has
    no shape or the config no ``d_model``: the planner then treats the
    boundary as fully exposed, the synchronous plan."""
    if stage.shape is None:
        return 0.0
    d = getattr(cfg, "d_model", None)
    if not d:
        return 0.0
    tokens = 1
    for e in stage.shape[:-1]:
        tokens *= e
    if stage.compute_dims:
        length = 1
        for dim in stage.compute_dims:
            if dim < len(stage.shape):
                length *= stage.shape[dim]
        return 8.0 * tokens * d * d + 4.0 * tokens * length * d
    d_ff = getattr(cfg, "d_ff", None) or 4 * d
    gated = "glu" in str(getattr(cfg, "mlp_kind", "")).lower()
    return (6.0 if gated else 4.0) * tokens * d * d_ff


def stage_compute_seconds(stage, cfg, topology=None) -> float:
    """Per-rank seconds of one planner stage at ``PEAK_FLOPS``: the
    compute an overlapped switch into it can hide behind.  The stage's
    tokens divide evenly over the SP group, so per-rank FLOPs are
    ``stage_flops / n`` (``topology`` None, an int degree, or a
    ``Topology`` whose ``size`` is n)."""
    f = stage_flops(stage, cfg)
    if not f:
        return 0.0
    if topology is None:
        n = 1
    elif isinstance(topology, int):
        n = max(topology, 1)
    else:
        n = topology.size
    return f / n / PEAK_FLOPS


def attach_compute_seconds(stages, cfg, topology=None):
    """The stage list with ``Stage.compute_seconds`` filled from
    ``stage_compute_seconds`` (stages that declare one keep it)."""
    return [st if st.compute_seconds is not None else
            dataclasses.replace(st, compute_seconds=stage_compute_seconds(
                st, cfg, topology))
            for st in stages]


__all__ = ["PEAK_FLOPS", "stage_flops", "stage_compute_seconds",
           "attach_compute_seconds"]
