"""mamba2-370m [ssm] — arXiv:2405.21060 (unverified tier).

48L d_model=1024, attention-free, ssm_state=128, vocab=50280.  Standard
mamba2 geometry: expand 2 => d_inner 2048, head_dim 64 => 32 SSD heads,
1 B/C group, chunk 128, tied embeddings.
"""
import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.lm import LMConfig
from repro_torch.models.ssm import SSMConfig

CONFIG = LMConfig(
    name="mamba2-370m",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=0, vocab=50280, pure_ssm=True,
    ssm_cfg=SSMConfig(d_model=1024, d_inner=2048, head_dim=64,
                      d_state=128, n_groups=1, d_conv=4),
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="mamba2-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab=512, pure_ssm=True,
    ssm_cfg=SSMConfig(d_model=64, d_inner=128, head_dim=16, d_state=32,
                      n_groups=1, chunk=16),
    dtype=torch.float32,
)

SPEC = register(ArchSpec(
    name="mamba2-370m", family="lm",
    config=CONFIG, smoke=SMOKE,
    source="arXiv:2405.21060; unverified",
))
