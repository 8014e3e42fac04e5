"""gemma2-2b [dense] — arXiv:2408.00118 (hf).

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000; local(4096)/global
alternating attention, attn logit softcap 50, final softcap 30, gelu-GLU,
post-norms, head_dim 256, embeddings scaled by sqrt(d).
long_500k skipped: alternating layers still include full global attention.
"""
import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.lm import LMConfig
from repro_torch.parallel.partition import ParallelPlan

CONFIG = LMConfig(
    name="gemma2-2b",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256000,
    mlp_kind="gelu_glu", window=4096, window_pattern="local_global",
    attn_softcap=50.0, final_softcap=30.0, post_norm=True, embed_scale=True,
    tie_embeddings=True, dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="gemma2-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    mlp_kind="gelu_glu", window=16, window_pattern="local_global",
    attn_softcap=50.0, final_softcap=30.0, post_norm=True, embed_scale=True,
    dtype=torch.float32,
)

SPEC = register(ArchSpec(
    name="gemma2-2b", family="lm",
    config=CONFIG, smoke=SMOKE,
    plan=ParallelPlan(mode="dsp", zero=True),
    skip_shapes=frozenset({"long_500k"}),
    skip_reason="alternating local/global: global layers are full quadratic "
                "attention; skipped per assignment rules",
    source="arXiv:2408.00118; hf",
))
