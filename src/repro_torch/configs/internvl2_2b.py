"""internvl2-2b — InternViT frontend (stubbed) + InternLM2 backbone [arXiv:2404.16821].

The modality frontend is a stub: the caller passes precomputed patch
embeddings (B, ``n_prefix_tokens``, d_model), which ``models.model.prefill``
prepends to the text stream. Served requests carry no image, as in the JAX
engine: the backbone then serves as the dense family does.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1000000.0,
    n_prefix_tokens=256,
    source="arXiv:2404.16821",
)

SMOKE = FULL.replace(
    name="internvl2-2b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    n_prefix_tokens=4,
    q_chunk=8,
    remat=False,
)

register(FULL, SMOKE)
