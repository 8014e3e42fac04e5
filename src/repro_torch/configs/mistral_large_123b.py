"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407
(unverified tier).

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.  At 123B the
production plan is tensor parallel over the model axis + ZeRO-3 over data
(``ParallelPlan(mode="tp")``: column- and row-parallel attention and MLP,
the sequence gathered into each block and reduce-scattered out of it).
The KV cache is stored in float8_e4m3fn.  long_500k skipped: pure full
attention.
"""
import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.lm import LMConfig
from repro_torch.parallel.partition import ParallelPlan

CONFIG = LMConfig(
    name="mistral-large-123b",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=32768,
    rope_theta=1e6, tie_embeddings=False, dtype=torch.bfloat16,
    cache_dtype=torch.float8_e4m3fn,   # 4.7 TB bf16 KV -> 2.4 TB fp8
)

SMOKE = LMConfig(
    name="mistral-large-smoke",
    n_layers=4, d_model=96, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=224, vocab=512, tie_embeddings=False, dtype=torch.float32,
)

SPEC = register(ArchSpec(
    name="mistral-large-123b", family="lm",
    config=CONFIG, smoke=SMOKE,
    plan=ParallelPlan(mode="tp", zero=True),
    skip_shapes=frozenset({"long_500k"}),
    skip_reason="pure full attention",
    source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
    notes="TP over model axis (96 heads / 16-way); weights too large for "
          "DSP's replicated-weight layout at this scale.",
))
