"""jamba-1.5-large-398b [hybrid] — arXiv:2403.19887 (hf).

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2,
Mamba+attention 1:7 interleave (one attention layer per 8-layer period,
at layer 3), MoE every other layer (the odd ones).  The KV cache is
stored in float8_e4m3fn.  Sub-quadratic overall => long_500k runs.

The SSM layers' geometry here, Mamba-2 SSD heads of P = 128 over
d_inner 16384 (128 heads) with G = 8 B/C groups and S = 128, is the JAX
reference config's own choice, mirrored field for field: Jamba's paper
builds its SSM layers from Mamba (Mamba-1) blocks, not Mamba-2 heads, so
P 128 is not a published value of the model.
"""
import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.lm import LMConfig
from repro_torch.models.ssm import SSMConfig
from repro_torch.parallel.partition import ParallelPlan

CONFIG = LMConfig(
    name="jamba-1.5-large-398b",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536,
    ssm_every=8, ssm_attn_offset=3,
    n_experts=16, top_k=2, moe_every=2, moe_offset=1,
    ssm_cfg=SSMConfig(d_model=8192, d_inner=16384, head_dim=128,
                      d_state=128, n_groups=8, d_conv=4),
    tie_embeddings=False, dtype=torch.bfloat16,
    cache_dtype=torch.float8_e4m3fn,
)

SMOKE = LMConfig(
    name="jamba-smoke",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=512,
    ssm_every=4, ssm_attn_offset=1,
    n_experts=4, top_k=2, moe_every=2, moe_offset=1,
    ssm_cfg=SSMConfig(d_model=64, d_inner=128, head_dim=16, d_state=32,
                      n_groups=2, chunk=16),
    tie_embeddings=False, dtype=torch.float32,
)

SPEC = register(ArchSpec(
    name="jamba-1.5-large-398b", family="lm",
    config=CONFIG, smoke=SMOKE,
    plan=ParallelPlan(mode="dsp", ep=True, zero=True),
    source="arXiv:2403.19887; hf",
    notes="DSP switches around both attention (seq<->head) and the SSD scan "
          "(seq<->ssm-head); MoE dispatch is expert-parallel over the model "
          "axis (16 experts / 16-way EP).",
))
