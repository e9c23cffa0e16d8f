"""Model zoo, dense family: init / paged decode step (port of the dense,
fully paged part of ``repro.models.model``).

Layers are a Python list of per-layer dicts and are walked with a Python
loop. The JAX package carried the layer-stacked page pool through
``lax.scan`` and rebuilt it per layer with ``dynamic_update_index_in_dim``;
here each layer's pages are views of the pool (``k_pages[i]``) written in
place, so a decode step never copies the pool.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dispatch
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L

# ===========================================================================
# init / weight carry-over
# ===========================================================================


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP A.9); the port "
            f"serves the dense family")
    if (cfg.sliding_window is not None or cfg.local_global_pattern
            or cfg.post_block_norm or cfg.tie_embeddings
            or cfg.name.startswith("gemma")):
        raise NotImplementedError(
            "sliding-window / post-norm / tied-embedding dense variants are not "
            "ported yet (ROADMAP A.7, kernel B4)")


def _init_dense_layer(generator: torch.Generator, cfg: ModelConfig, device) -> dict:
    dtype = torch_dtype(cfg.param_dtype)
    return {
        "attn_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "attn": attn_lib.init_attention(generator, cfg, device),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, device),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """Random params with the JAX package's distributions (``layers.py:19-26``),
    drawn from ``generator``, which must live on ``device``."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    return {
        "embed": L.init_embed(generator, cfg.vocab_size, cfg.d_model, dtype, dev),
        "layers": [_init_dense_layer(generator, cfg, dev) for _ in range(cfg.n_layers)],
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, dev),
        "lm_head": L.init_lm_head(generator, cfg.d_model, cfg.vocab_size, dtype, dev),
    }


def _leaf_to_torch(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy leaf -> torch tensor; an ``ml_dtypes.bfloat16`` array (which
    ``torch.from_numpy`` rejects) goes through its uint16 bits."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def params_from_numpy(tree: Any, device=None) -> Any:
    """Carry the JAX package's ``init_params`` tree over (after
    ``jax.tree_util.tree_map(np.asarray, ...)``): every leaf becomes a torch
    tensor on ``device`` and the layer-stacked ``(nL, ...)`` subtree under
    ``"layers"`` is split into a list of per-layer dicts."""
    dev = resolve_device(device)

    def conv(t, layer=None):
        if isinstance(t, dict):
            return {k: conv(v, layer) for k, v in t.items()}
        arr = np.asarray(t)
        return _leaf_to_torch(arr if layer is None else arr[layer], dev)

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    if "layers" in tree:
        leaf = tree["layers"]
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        out["layers"] = [conv(tree["layers"], i) for i in range(np.asarray(leaf).shape[0])]
    return out


def kv_cache_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.kv_dtype or cfg.dtype)


# ===========================================================================
# decode step (fully paged dense family)
# ===========================================================================


def logits_fn(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return L.lm_head(params["lm_head"], x, cfg.logit_softcap)


def _mlp_tail(lp: dict, x: torch.Tensor, cfg: ModelConfig, gemm: bool = False) -> torch.Tensor:
    h = L.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
    if gemm:
        m = L.mlp(lp["mlp"], h, linear_fn=attn_lib._dense_matmul)
    else:
        m = dispatch.mlp(lp["mlp"], h, cfg)  # W8A8 GEMVs under quantized_decode
    return x + m


def _dense_block_decode_paged(lp, x, kp, vp, table, pos, cfg: ModelConfig,
                              gemm: bool = False):
    h = L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    a = attn_lib.attention_decode_paged(lp["attn"], h, kp, vp, table, pos, cfg, gemm=gemm)
    return _mlp_tail(lp, x + a, cfg, gemm=gemm)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig,
                *, gemm: bool = False):
    """T tokens per lane: tokens (B, T) -> (logits (B, T, V), cache').

    ``cache`` holds ``k_pages``/``v_pages`` (nL, P, H, ...), ``block_table``
    (B, NB) and ``pos`` (B,); the pages are written IN PLACE and the returned
    cache shares them, with ``pos`` advanced by T. ``gemm=True`` runs the
    batch-prefill form (float GEMMs, dense attention at any T).
    """
    if "k_pages" not in cache:
        raise NotImplementedError(
            "only the fully paged decode cache is ported (contiguous lanes wait "
            "for kernel B4; ROADMAP A.7)")
    _check_family(cfg)
    pos = cache["pos"]
    table = cache["block_table"]
    kp_all, vp_all = cache["k_pages"], cache["v_pages"]
    x = L.embed(params["embed"], tokens)
    for i, lp in enumerate(params["layers"]):
        x = _dense_block_decode_paged(lp, x, kp_all[i], vp_all[i], table, pos, cfg,
                                      gemm=gemm)
    new_cache = {"k_pages": kp_all, "v_pages": vp_all, "block_table": table,
                 "pos": pos + tokens.shape[1]}
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, x, cfg), new_cache
