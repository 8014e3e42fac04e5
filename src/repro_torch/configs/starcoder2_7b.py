"""starcoder2-7b [dense] — arXiv:2402.19173 (hf).

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152, RoPE, GELU MLP,
LayerNorm + biases.  long_500k skipped: pure full attention.
"""
import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.lm import LMConfig
from repro_torch.parallel.partition import ParallelPlan

CONFIG = LMConfig(
    name="starcoder2-7b",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128,
    d_ff=18432, vocab=49152,
    mlp_kind="gelu", norm_kind="layer", attn_bias=True,
    rope_theta=1e5, tie_embeddings=True, dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="starcoder2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab=512, mlp_kind="gelu", norm_kind="layer",
    attn_bias=True, dtype=torch.float32,
)

SPEC = register(ArchSpec(
    name="starcoder2-7b", family="lm",
    config=CONFIG, smoke=SMOKE,
    plan=ParallelPlan(mode="dsp", zero=True),
    skip_shapes=frozenset({"long_500k"}),
    skip_reason="pure full attention",
    source="arXiv:2402.19173; hf",
))
