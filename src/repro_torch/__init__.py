"""PyTorch/CUDA port of the DSP reproduction (``repro``).

Module paths and function names mirror ``repro``: ``repro_torch.models.lm``
is the counterpart of ``repro.models.lm``, and so on.  The port imports
``torch`` and never ``jax`` or ``repro``.  Its entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.
"""
