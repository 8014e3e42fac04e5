"""pixtral-12b [vlm] — hf:mistralai/Pixtral-12B-2409 (unverified tier).

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072 (mistral-nemo text
backbone).  The pixtral ViT frontend is a stub, as in the JAX package: a
batch's ``extra["patch_embeds"]`` (B, 1024, 1024), precomputed patch
embeddings (a 32x32 patch grid at ViT width 1024), replace the first 1024
sequence positions (``models.lm.forward(extra=)``).
long_500k skipped: pure full attention.
"""
import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.lm import LMConfig
from repro_torch.parallel.partition import ParallelPlan

CONFIG = LMConfig(
    name="pixtral-12b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
    d_ff=14336, vocab=131072,
    rope_theta=1e9, tie_embeddings=False,
    frontend_dim=1024, frontend_tokens=1024,
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="pixtral-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, tie_embeddings=False,
    frontend_dim=48, frontend_tokens=8, dtype=torch.float32,
)

SPEC = register(ArchSpec(
    name="pixtral-12b", family="lm",
    config=CONFIG, smoke=SMOKE,
    plan=ParallelPlan(mode="dsp", zero=True),
    skip_shapes=frozenset({"long_500k"}),
    skip_reason="pure full attention",
    source="hf:mistralai/Pixtral-12B-2409; unverified",
))
