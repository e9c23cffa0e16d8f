"""seamless-m4t-large-v2 — encoder-decoder, multimodal [arXiv:2308.11596].

The audio frontend is a stub: the caller passes precomputed frame embeddings
(B, S, d_model) to ``models.model.prefill(src_frames=)``, which runs the 24
encoder layers and projects each decoder layer's cross-attention K/V once;
decode steps then walk the 24 decoder layers over their self-KV lanes and the
fixed memory. The engine does not serve it (admission has no frames), as in
the JAX package.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,          # decoder
    n_encoder_layers=24,  # encoder
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    source="arXiv:2308.11596",
)

SMOKE = FULL.replace(
    name="seamless-m4t-large-v2-smoke",
    n_layers=2,
    n_encoder_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    q_chunk=8,
    remat=False,
)

register(FULL, SMOKE)
