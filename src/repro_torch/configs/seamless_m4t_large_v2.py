"""seamless-m4t-large-v2 [audio, enc-dec] — arXiv:2308.11596 (hf).

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.  Interpreted as the
published large-v2 backbone: 24 encoder + 24 decoder layers (speech encoder /
NLLB text decoder), d_model 1024.  The conformer audio frontend is a stub:
the batch supplies precomputed frame embeddings (B, S, 1024).
train/prefill sequence budget: S_enc = seq_len, S_dec = seq_len // 4 (audio
frames dominate the budget).
long_500k skipped: full (quadratic) attention throughout.
"""
import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.encdec import EncDecConfig
from repro_torch.parallel.partition import ParallelPlan

CONFIG = EncDecConfig(
    name="seamless-m4t-large-v2",
    n_enc_layers=24, n_dec_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab=256206, frontend_dim=1024,
    mlp_kind="relu", norm_kind="layer", dtype=torch.bfloat16,
)

SMOKE = EncDecConfig(
    name="seamless-smoke",
    n_enc_layers=2, n_dec_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, frontend_dim=40,
    mlp_kind="relu", norm_kind="layer", dtype=torch.float32,
)

SPEC = register(ArchSpec(
    name="seamless-m4t-large-v2", family="encdec",
    config=CONFIG, smoke=SMOKE,
    plan=ParallelPlan(mode="dsp", zero=True),
    skip_shapes=frozenset({"long_500k"}),
    skip_reason="pure full-attention enc-dec: 500k decode KV is quadratic-"
                "history; skipped per assignment rules",
    source="arXiv:2308.11596; hf",
))
