"""Architecture configs (counterpart of ``repro.configs``): FULL (the
published configuration) and REDUCED (a smoke variant of the same family:
<= 2 scan units, d_model <= 512, <= 4 experts) for each arch of the JAX
package, copied field for field.
"""

import importlib
from typing import List

from repro_torch.models.common import ModelConfig

ARCHS: List[str] = [
    "deepseek_7b", "starcoder2_15b", "olmoe_1b_7b", "xlstm_1_3b",
    "qwen2_vl_7b", "recurrentgemma_2b", "phi3_5_moe", "llama3_8b",
    "minitron_8b", "musicgen_medium",
]

# canonical CLI ids (--arch <id>) -> module name, as in the JAX package
ALIASES = {
    "deepseek-7b": "deepseek_7b",
    "starcoder2-15b": "starcoder2_15b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "xlstm-1.3b": "xlstm_1_3b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "phi3.5-moe": "phi3_5_moe",
    "llama3-8b": "llama3_8b",
    "minitron-8b": "minitron_8b",
    "musicgen-medium": "musicgen_medium",
}


def get_config(name: str, variant: str = "full") -> ModelConfig:
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.FULL if variant == "full" else mod.REDUCED


def all_archs() -> List[str]:
    return list(ARCHS)
