"""Carry a JAX parameter tree into the port.

The JAX package and the port share one tree layout (same keys, linears as
(d_in, d_out), ``periods`` leaves stacked on a leading n_periods dim, the
enc-dec model's ``enc_periods``/``dec_periods`` on a leading layer dim), so
crossing over is a leafwise copy with no transpose.  The caller converts
the JAX tree to numpy first (``jax.tree_util.tree_map(np.asarray, ...)``);
this module never imports JAX.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def _leaf(a: np.ndarray, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is not a numpy type torch.from_numpy accepts;
        # widening to float32 is exact and the cast back restores the bits
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        # a copy: the port writes caches in place, and a JAX array's numpy
        # view is read-only
        t = torch.from_numpy(np.array(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Any, *, device, dtype: Optional[torch.dtype] = None):
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device``; floating leaves are cast to ``dtype`` when it is given,
    except a MoE router's, which stays float32 as both packages' inits
    draw it (``models.moe.init_moe``)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(
                    v, device=device,
                    dtype=(torch.float32 if k == "router" and dtype
                           is not None else dtype))
                for k, v in tree.items()}
    return _leaf(tree, device, dtype)
