"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B (hf).

24L d_model=2048 16H (GQA kv=16) d_ff=1408(per expert) vocab=151936,
MoE 60 experts top-4 + 4 shared experts (shared_ff 5632), norm_topk off.
60 experts pad to 64 for 16-way EP.  long_500k skipped: full attention.
"""
import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.lm import LMConfig
from repro_torch.parallel.partition import ParallelPlan

CONFIG = LMConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=151936,
    n_experts=60, top_k=4, n_shared=4, shared_ff=5632,
    norm_topk=False, ep_pad=64, attn_bias=True,
    tie_embeddings=False, dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="qwen2-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=48, vocab=512, n_experts=6, top_k=2, n_shared=1, shared_ff=96,
    norm_topk=False, ep_pad=8, attn_bias=True,
    tie_embeddings=False, dtype=torch.float32,
)

SPEC = register(ArchSpec(
    name="qwen2-moe-a2.7b", family="lm",
    config=CONFIG, smoke=SMOKE,
    plan=ParallelPlan(mode="dsp", ep=True, zero=True),
    skip_shapes=frozenset({"long_500k"}),
    skip_reason="pure full attention",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
    notes="60 experts padded to 64 (never-routed dummies) for 16-way EP; "
          "MoE dispatch = DSP switch token-dim <-> expert-dim.",
))
