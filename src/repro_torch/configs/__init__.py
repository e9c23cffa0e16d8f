"""Architecture registry — importing this package registers every arch of the
JAX package: the dense family (``llama3-8b``, ``yi-9b``, ``codeqwen1.5-7b``,
``gemma2-27b``), the MoE family (``olmoe-1b-7b``, ``phi3.5-moe-42b-a6.6b``),
the hybrid ``zamba2-7b``, the RWKV6 ``rwkv6-1.6b`` (``ssm``), the VLM
``internvl2-2b`` and the encoder-decoder ``seamless-m4t-large-v2``
(``audio``)."""
from repro_torch.configs.base import (SHAPES, ArchEntry, ModelConfig, ShapeSpec, all_cells,
                                      get_config, input_specs, list_archs, register,
                                      shape_applicable)

# One module per ported architecture (registration side effect).
from repro_torch.configs import (codeqwen15_7b, gemma2_27b, internvl2_2b,  # noqa: E402
                                 llama3_8b, olmoe_1b_7b, phi35_moe, rwkv6_1b6,
                                 seamless_m4t_v2, yi_9b, zamba2_7b)

__all__ = ["SHAPES", "ArchEntry", "ModelConfig", "ShapeSpec", "all_cells", "get_config",
           "input_specs", "list_archs", "register", "shape_applicable", "codeqwen15_7b",
           "gemma2_27b", "internvl2_2b", "llama3_8b", "olmoe_1b_7b", "phi35_moe",
           "rwkv6_1b6", "seamless_m4t_v2", "yi_9b", "zamba2_7b"]
