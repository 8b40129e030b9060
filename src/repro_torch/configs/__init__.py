"""Architecture configs: one module per assigned architecture.

The port's own copy of ``repro/configs`` (framework-free; the port imports
nothing of the JAX package). Only the import paths differ.

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` returns a reduced same-family config for CPU
smoke tests (small layers/width/experts/vocab).
"""

from repro_torch.configs.base import ModelConfig, ShapeSpec, SHAPES, get_config, \
    get_smoke_config, ARCH_IDS

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "get_config",
           "get_smoke_config", "ARCH_IDS"]
