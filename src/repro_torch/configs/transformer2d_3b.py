"""transformer2d-3b — the paper's larger model (Table 4).

36 blocks, hidden 2048 (the paper's table prints "2038", a transcription
artifact of 2048), 32 heads of 64, d_ff 8192.
"""
import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.transformer2d import T2DConfig

CONFIG = T2DConfig(
    name="transformer2d-3b",
    n_layers=36, d_model=2048, n_heads=32, d_ff=8192,
    in_dim=64, mlp_kind="gelu", modulate=True, dtype=torch.bfloat16,
)

SMOKE = T2DConfig(
    name="transformer2d-3b-smoke",
    n_layers=2, d_model=96, n_heads=8, d_ff=192,
    in_dim=16, mlp_kind="gelu", modulate=True, dtype=torch.float32,
)

SPEC = register(ArchSpec(
    name="transformer2d-3b", family="t2d",
    config=CONFIG, smoke=SMOKE,
    source="paper Table 4 (OpenSora variant)",
))
