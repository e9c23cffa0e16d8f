"""Architecture registry — importing this package registers the ported archs:
the dense family (``llama3-8b``, ``yi-9b``, ``codeqwen1.5-7b``, ``gemma2-27b``),
the MoE family (``olmoe-1b-7b``, ``phi3.5-moe-42b-a6.6b``) and the hybrid
``zamba2-7b``."""
from repro_torch.configs.base import ModelConfig, get_config, list_archs, register

# One module per ported architecture (registration side effect).
from repro_torch.configs import (codeqwen15_7b, gemma2_27b, llama3_8b,  # noqa: E402
                                 olmoe_1b_7b, phi35_moe, yi_9b, zamba2_7b)

__all__ = ["ModelConfig", "get_config", "list_archs", "register", "codeqwen15_7b",
           "gemma2_27b", "llama3_8b", "olmoe_1b_7b", "phi35_moe", "yi_9b", "zamba2_7b"]
