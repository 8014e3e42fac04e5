"""Architecture configs: ``repro_torch.configs.get("<arch-id>")`` -> ArchSpec."""
from repro_torch.configs.base import (ArchSpec, SHAPES, T2D_SHAPES, get, names,
                                      register)

__all__ = ["ArchSpec", "SHAPES", "T2D_SHAPES", "get", "names", "register"]
