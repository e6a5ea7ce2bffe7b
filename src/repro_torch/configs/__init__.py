"""Model and workload configurations.

The ten assigned architectures (copies of ``repro.configs``, registered on
import; select with ``get_config(name)``) and ``olaf_ppo``, the paper's own
DRL workload.
"""
from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeCfg, get_config,
                                      list_configs)

from repro_torch.configs import (  # noqa: F401  — registration side effects
    smollm_360m, gemma_2b, chatglm3_6b, mistral_large_123b, mamba2_130m,
    grok1_314b, arctic_480b, whisper_small, recurrentgemma_9b, internvl2_76b,
)

__all__ = ["ArchConfig", "ShapeCfg", "SHAPES", "get_config", "list_configs"]
