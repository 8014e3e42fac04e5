"""qwen3-14b [dense] — hf:Qwen/Qwen3-8B family scaling (hf tier).

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936, qk-norm, RoPE
theta 1e6.  long_500k skipped: pure full attention.
"""
import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.lm import LMConfig
from repro_torch.parallel.partition import ParallelPlan

CONFIG = LMConfig(
    name="qwen3-14b",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab=151936,
    qk_norm=True, rope_theta=1e6, tie_embeddings=False,
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="qwen3-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab=512, qk_norm=True, rope_theta=1e6,
    tie_embeddings=False, dtype=torch.float32,
)

SPEC = register(ArchSpec(
    name="qwen3-14b", family="lm",
    config=CONFIG, smoke=SMOKE,
    plan=ParallelPlan(mode="dsp", zero=True),
    skip_shapes=frozenset({"long_500k"}),
    skip_reason="pure full attention",
    source="hf:Qwen/Qwen3-8B; hf",
))
