"""Model zoo of the port: the decoder-only ``dense`` and ``moe`` families
as ``nn.Module`` blocks under the JAX package's parameter names.
``registry.build(config)`` returns a :class:`Model` bundle with ``init /
prefill / decode_step / init_caches``; ``convert.params_from_numpy``
carries the JAX package's weights across.
"""

from repro_torch.models.registry import build, Model

__all__ = ["build", "Model"]
