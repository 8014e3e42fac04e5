"""Architecture registry (counterpart of ``repro.configs.base``).

Each spec carries the full published config, a reduced same-family
SMOKE config and the parallel plan of the JAX spec.  Architectures
register here as their families are ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, FrozenSet

from repro_torch.parallel.partition import ParallelPlan

# The four assigned LM shapes (seq_len, global_batch) and their entry points.
SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k":    {"seq": 4_096,   "batch": 256, "step": "train"},
    "prefill_32k": {"seq": 32_768,  "batch": 32,  "step": "prefill"},
    "decode_32k":  {"seq": 32_768,  "batch": 128, "step": "decode"},
    "long_500k":   {"seq": 524_288, "batch": 1,   "step": "decode"},
}

# The paper's own 2D-transformer shapes (temporal x spatial, per A.3.2):
# spatial fixed at 4096, temporal scaling 128 -> 1024.
T2D_SHAPES: Dict[str, Dict[str, Any]] = {
    "video_0.5m": {"temporal": 128,  "spatial": 4096, "batch": 32, "step": "train"},
    "video_1m":   {"temporal": 256,  "spatial": 4096, "batch": 16, "step": "train"},
    "video_2m":   {"temporal": 512,  "spatial": 4096, "batch": 16, "step": "train"},
    "video_4m":   {"temporal": 1024, "spatial": 4096, "batch": 16, "step": "train"},
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                      # "lm" | "encdec" | "t2d"
    config: Any
    smoke: Any
    plan: ParallelPlan
    skip_shapes: FrozenSet[str] = frozenset()
    skip_reason: str = ""
    source: str = ""
    notes: str = ""

    def shapes(self) -> Dict[str, Dict[str, Any]]:
        table = T2D_SHAPES if self.family == "t2d" else SHAPES
        return {k: v for k, v in table.items() if k not in self.skip_shapes}


_REGISTRY: Dict[str, ArchSpec] = {}

_MODULES = ["mamba2_370m", "qwen3_14b", "starcoder2_7b", "gemma2_2b",
            "mistral_large_123b", "qwen2_moe_a2_7b", "arctic_480b",
            "pixtral_12b", "transformer2d_720m", "transformer2d_3b",
            "seamless_m4t_large_v2", "jamba_1_5_large_398b"]


def register(spec: ArchSpec) -> ArchSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"{spec.name} registered twice")
    _REGISTRY[spec.name] = spec
    return spec


def _ensure_loaded() -> None:
    import importlib
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get(name: str) -> ArchSpec:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"{name!r} is not ported; ported: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)
