"""transformer2d-720m — the paper's own base model (Table 4).

28 blocks (14 spatial + temporal pairs), hidden 1152, 16 heads of 72,
d_ff 4608: the OpenSora-like 2D DiT with cross-attention removed
(Appendix A.1).  Shapes follow A.3.2: spatial fixed at 4096, temporal
scales 128..1024 (``base.T2D_SHAPES``).
"""
import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.transformer2d import T2DConfig
from repro_torch.parallel.partition import ParallelPlan

CONFIG = T2DConfig(
    name="transformer2d-720m",
    n_layers=28, d_model=1152, n_heads=16, d_ff=4608,
    in_dim=64, mlp_kind="gelu", modulate=True, dtype=torch.bfloat16,
)

SMOKE = T2DConfig(
    name="transformer2d-smoke",
    n_layers=2, d_model=64, n_heads=4, d_ff=128,
    in_dim=16, mlp_kind="gelu", modulate=True, dtype=torch.float32,
)

SPEC = register(ArchSpec(
    name="transformer2d-720m", family="t2d",
    config=CONFIG, smoke=SMOKE,
    plan=ParallelPlan(mode="dsp", zero=True, shard_vocab=False),
    source="paper Table 4 (OpenSora variant)",
))
