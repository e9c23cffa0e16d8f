"""Architecture registry — importing this package registers the ported archs
(dense ``llama3-8b`` and hybrid ``zamba2-7b``)."""
from repro_torch.configs.base import ModelConfig, get_config, list_archs, register

# One module per ported architecture (registration side effect).
from repro_torch.configs import llama3_8b, zamba2_7b  # noqa: E402

__all__ = ["ModelConfig", "get_config", "list_archs", "register", "llama3_8b", "zamba2_7b"]
