"""arctic-480b [moe] — hf:Snowflake/snowflake-arctic-base (hf).

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128 experts
top-2 + parallel dense-residual MLP (dense-MoE hybrid).  128 experts /
16-way EP = 8 experts per device.  long_500k skipped: full attention.

Every layer is MoE + dense, so the period is one layer.  The production
plan is tensor parallel over the model axis for attention and the dense
residual, expert parallel over the same axis for the routed experts, and
ZeRO-3 over data.  The KV cache is stored in float8_e4m3fn.
"""
import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.lm import LMConfig
from repro_torch.parallel.partition import ParallelPlan

CONFIG = LMConfig(
    name="arctic-480b",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab=32000,
    n_experts=128, top_k=2, dense_ff=4864,
    tie_embeddings=False, dtype=torch.bfloat16,
    cache_dtype=torch.float8_e4m3fn,
)

SMOKE = LMConfig(
    name="arctic-smoke",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab=512, n_experts=8, top_k=2, dense_ff=64,
    tie_embeddings=False, dtype=torch.float32,
)

SPEC = register(ArchSpec(
    name="arctic-480b", family="lm",
    config=CONFIG, smoke=SMOKE,
    plan=ParallelPlan(mode="tp", ep=True, zero=True),
    skip_shapes=frozenset({"long_500k"}),
    skip_reason="pure full attention",
    source="hf:Snowflake/snowflake-arctic-base; hf",
    notes="TP for attention/dense-residual + EP for the 128 routed experts, "
          "both on the model axis; ZeRO-3 over data.",
))
