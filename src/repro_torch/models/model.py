"""Model zoo: init, the full-sequence forward and loss of training, prefill
and the decode step, for every family of the JAX package (port of
``repro.models.model``).

Layers are a Python list of per-layer dicts and are walked with a Python
loop. Two forms walk them:

* the full-sequence form (:func:`forward`, :func:`loss_fn`; the hybrid
  :func:`prefill`): every token at once, causal attention in query chunks
  (``attention.attention_dense``), no cache; with ``cfg.remat`` each layer's
  body (a hybrid group: its Mamba2 layers and the shared block) runs under
  ``torch.utils.checkpoint`` and is recomputed in the backward pass, where
  the JAX package applies ``jax.checkpoint``. :func:`loss_fn` is the chunked
  f32 softmax cross-entropy that never forms (B, S, V) logits at once;
* the cache-walking form (:func:`decode_step`, the other families'
  :func:`prefill`): the JAX package carried the layer-stacked caches (page
  pool, contiguous lanes, rings, recurrent states) through ``lax.scan`` and
  rebuilt them per layer with ``dynamic_update_index_in_dim``; here each
  layer's slice is a view of the stacked tensor (``k_pages[i]``, ``k[i]``,
  ``k_loc[i]``, ``ssd[i]``, ``wkv[i]``) written in place, so a decode step
  never copies a stacked cache.

Families: ``dense`` (llama3-8b, yi-9b, codeqwen1.5-7b and gemma2-27b; paged
or contiguous KV), ``vlm`` (internvl2-2b: the dense backbone, whose
``forward`` and ``prefill`` prepend precomputed patch embeddings), ``moe``
(olmoe-1b-7b, phi3.5-moe: the dense blocks with a top-k MoE FFN,
``models.moe``, in place of the MLP), ``ssm`` (rwkv6-1.6b: RWKV6 blocks,
``models.rwkv``, whose decode state is recurrent only), ``hybrid``
(zamba2-7b: groups of ``attn_every`` Mamba2 layers, each group followed by ONE
weight-shared attention + MLP block whose KV lives in contiguous lanes) and
``audio`` (seamless-m4t-large-v2: a bidirectional encoder over precomputed
frames, run once by ``prefill``, and a causal decoder with self-KV lanes and
cross attention over the encoder memory's per-layer K/V,
``cross_k``/``cross_v``).
gemma2 adds per-layer sliding windows (its even, local layers attend to the
last ``sliding_window`` tokens), attention and final-logit softcaps,
post-block norms, tied embeddings and the embedding scale; with
``windowed_kv_cache`` its local layers keep W-slot rings (``k_loc``/``v_loc``)
beside the global layers' full lanes.

**Partitioned** (``mesh=`` on :func:`decode_step` and :func:`prefill`): the
JAX dry run's decode and prefill programs for the dense configs (llama3-8b,
yi-9b, codeqwen1.5-7b, gemma2-27b), vlm (internvl2-2b) and audio
(seamless-m4t-large-v2; float linears, contiguous caches) run partitioned
over a ``torch.distributed`` mesh (``launch.mesh``), with
explicit collectives (``dist.collectives``), as GSPMD partitions them under
the JAX specs: every argument is the calling rank's local shard
(``dist.sharding.local_shards``: its batch rows over ``data``, its columns
or rows of each split weight over ``model``, its lanes of the cache, which
holds every KV head) and so is every output (its rows of the cache, its rows
and vocab columns of the logits, the out-spec ``P(ba, None, "model")``).
Megatron tensor parallelism: the vocab-sharded embedding looks up its rows
and all-reduces; ``wq``/``wk``/``wv`` and ``w_gate``/``w_up`` are
column-parallel, ``wo`` and ``w_down`` row-parallel, each block one
all-reduce (``models.attention`` gathers the new K/V); the LM head (tied:
the embedding's rows) gives vocab-sharded logits, or, where ``model`` does
not divide the vocab (GSPMD's padded vocab, ``dist.sharding``), gathers
them and drops the pad (:func:`logits_fn`). gemma2 keeps its softcaps, its
post-norms (after each block's reduction) and its local layers' windows
(a live range over full lanes); a vlm's image prefix goes before its
tokens; the audio encoder runs its blocks the same way and each decoder
layer's cross K/V gathers every head, its cross attention the rank's
heads. Under ``cfg.seq_parallel`` (and T >= 16) the dense and vlm
prefill's activations between blocks shard their sequence over ``model``
(the JAX package's ``_sp_constraint``, on its dense block only): a block
all-gathers its normed input and reduce-scatters its output. The
arithmetic is the unsharded program's up to the order of the reductions.
The paged cache, W8A8, gemma2's rings and the MoE, hybrid and ssm families
raise under a mesh.

The same families' training form (``mesh=`` on :func:`forward` and
:func:`loss_fn`, the loss of ``train.train_step.train_step`` with ``mesh=``)
runs the full-sequence blocks over the rank's rows with the same split
(:func:`train_parallel`), under autograd: every collective has its
conjugate in the backward pass (``dist.collectives``: a block's reduction
passes its gradient unchanged, a column input's gradient is all-reduced,
the K/V gather's is reduce-scattered), the remat recompute runs the block's
collectives again as far as it recomputes, and the head's vocab columns go
through a vocab-parallel cross-entropy (:func:`_vocab_parallel_xent`).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dispatch, kv_mapping
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.dist.collectives import TensorParallel, all_gather, all_reduce, reduce_from
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")
# param subtrees whose leaves the JAX package stacks layer-first for lax.scan
STACKED = ("layers", "mamba_layers", "enc_layers", "dec_layers")
# hybrid recurrent-state leaves, stacked over all n_layers Mamba2 layers
SSM_STATE_KEYS = ("ssd", "conv_x", "conv_bc")
# a global layer's window under gemma2's local/global pattern: wider than any
# lane, so its live range starts at 0 (the JAX package's width, model.py:288)
GLOBAL_WINDOW = 2**30

# ===========================================================================
# init / weight carry-over
# ===========================================================================


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the families are {FAMILIES}")


def _init_dense_layer(generator: torch.Generator, cfg: ModelConfig, device) -> dict:
    dtype = torch_dtype(cfg.param_dtype)
    p = {
        "attn_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "attn": attn_lib.init_attention(generator, cfg, device),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
    }
    if cfg.family == "moe":
        p["moe"] = moe_lib.init_moe(generator, cfg, device)
    else:
        p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, device)
    if cfg.post_block_norm:
        p["post_attn_norm"] = L.init_rmsnorm(cfg.d_model, dtype, device)
        p["post_mlp_norm"] = L.init_rmsnorm(cfg.d_model, dtype, device)
    return p


def _init_encdec_layer(generator: torch.Generator, cfg: ModelConfig, device,
                       cross: bool) -> dict:
    """An encoder (or, ``cross``, decoder) layer: a dense layer, the decoder's
    with a cross-attention norm and block."""
    p = _init_dense_layer(generator, cfg, device)
    if cross:
        p["cross_norm"] = L.init_rmsnorm(cfg.d_model, torch_dtype(cfg.param_dtype), device)
        p["cross_attn"] = attn_lib.init_attention(generator, cfg, device)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device=None) -> dict:
    """Random params with the JAX package's distributions (``layers.py:19-26``),
    drawn from ``generator``, which must live on ``device``. On the ``meta``
    device nothing is drawn and ``generator`` is ``None``
    (:func:`param_specs`)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    params = {"embed": L.init_embed(generator, cfg.vocab_size, cfg.d_model, dtype, dev)}
    if cfg.family == "hybrid":   # zamba2
        params["mamba_layers"] = [
            {"norm": L.init_rmsnorm(cfg.d_model, dtype, dev),
             "ssm": ssm_lib.init_ssm(generator, cfg, dev)} for _ in range(cfg.n_layers)]
        params["shared_attn"] = _init_dense_layer(generator, cfg.replace(family="dense"), dev)
    elif cfg.family == "ssm":    # rwkv6
        params["layers"] = [
            {"block": rwkv_lib.init_rwkv_block(generator, cfg, dev),
             "ln1": L.init_layernorm(cfg.d_model, dtype, dev),
             "ln2": L.init_layernorm(cfg.d_model, dtype, dev)} for _ in range(cfg.n_layers)]
        params["ln_in"] = L.init_layernorm(cfg.d_model, dtype, dev)
    elif cfg.family == "audio":  # seamless enc-dec
        params["enc_layers"] = [_init_encdec_layer(generator, cfg, dev, cross=False)
                                for _ in range(cfg.n_encoder_layers)]
        params["dec_layers"] = [_init_encdec_layer(generator, cfg, dev, cross=True)
                                for _ in range(cfg.n_layers)]
        params["enc_norm"] = L.init_rmsnorm(cfg.d_model, dtype, dev)
    else:                        # dense / vlm / moe
        params["layers"] = [_init_dense_layer(generator, cfg, dev)
                            for _ in range(cfg.n_layers)]
    params["final_norm"] = L.init_rmsnorm(cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:    # tied: the head is the embedding (logits_fn)
        params["lm_head"] = L.init_lm_head(generator, cfg.d_model, cfg.vocab_size, dtype,
                                           dev)
    return params


def param_specs(cfg: ModelConfig) -> dict:
    """The params tree without storage: :func:`init_params`'s leaves built on
    the ``meta`` device (their shapes and dtypes, nothing drawn), each layer
    list stacked ``(nL, ...)`` under its key as the JAX package's
    ``param_specs`` stacks it (:func:`stack_layers`)."""
    return stack_layers(init_params(cfg, None, device="meta"), torch.stack)


def leaf_to_torch(arr: np.ndarray, device: torch.device) -> torch.Tensor:
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
    tensor on ``device`` and each layer-stacked ``(nL, ...)`` subtree
    (``"layers"``, the hybrid's ``"mamba_layers"``, the encoder-decoder's
    ``"enc_layers"``/``"dec_layers"``) is split into a list of per-layer
    dicts. A layer's leaf is the stacked leaf's slice, whatever its rank: the
    MoE expert tables ``(nL, E, d, f)`` become ``(E, d, f)``, RWKV's
    ``mix_w2`` ``(nL, 5, 32, d)`` becomes ``(5, 32, d)``."""
    dev = resolve_device(device)

    def conv(t, layer=None):
        if isinstance(t, dict):
            return {k: conv(v, layer) for k, v in t.items()}
        arr = np.asarray(t)
        return leaf_to_torch(arr if layer is None else arr[layer], dev)

    out = {k: conv(v) for k, v in tree.items() if k not in STACKED}
    for key in STACKED:
        if key in tree:
            leaf = tree[key]
            while isinstance(leaf, dict):
                leaf = next(iter(leaf.values()))
            out[key] = [conv(tree[key], i) for i in range(np.asarray(leaf).shape[0])]
    return out


def stack_layers(tree: dict, stack: Callable) -> dict:
    """``tree`` (shaped like the params: the layer lists under
    :data:`STACKED` keys) with each layer list merged leaf by leaf into one
    leaf, ``stack(per-layer leaves)``: the JAX package's layer-stacked
    layout."""
    def merge(layers):
        if isinstance(layers[0], dict):
            return {k: merge([lp[k] for lp in layers]) for k in layers[0]}
        return stack(layers)

    return {k: merge(v) if k in STACKED and v else v for k, v in tree.items()}


def unstack_layers(tree: dict) -> dict:
    """The inverse of :func:`stack_layers`: each stacked ``(nL, ...)``
    subtree under a :data:`STACKED` key as a list of per-layer dicts whose
    leaves are the stacked leaves' slices ``t[i]`` (a leaf may also be a
    list of the layers' leaves)."""
    def layer(node, i):
        return {k: layer(v, i) for k, v in node.items()} if isinstance(node, dict) else node[i]

    out = dict(tree)
    for key in STACKED:
        if key in tree:
            leaf = tree[key]
            while isinstance(leaf, dict):
                leaf = next(iter(leaf.values()))
            out[key] = [layer(tree[key], i) for i in range(len(leaf))]
    return out


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch leaf -> numpy on the host; numpy has no bfloat16, so a bf16
    leaf widens to f32, losslessly (as the checkpoint stores it)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(tree: dict) -> dict:
    """The inverse of :func:`params_from_numpy`: every leaf of a params tree
    (or of a tree shaped like it: gradients, AdamW moments) as a numpy array
    (bf16 widened to f32), each layer list re-stacked ``(nL, ...)`` under its
    key as the JAX package stacks it."""
    def conv(t):
        return {k: conv(v) for k, v in t.items()} if isinstance(t, dict) else _leaf_to_numpy(t)

    return conv(stack_layers(tree, lambda leaves: torch.stack([x.detach() for x in leaves])))


def kv_cache_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.kv_dtype or cfg.dtype)


# ===========================================================================
# decode cache: init / specs
# ===========================================================================


def _hybrid_groups(cfg: ModelConfig) -> int:
    """Shared-block applications: one after every ``attn_every`` Mamba2
    layers (the layers after the last one run without it)."""
    return cfg.n_layers // cfg.attn_every


def windowed_cache_applicable(cfg: ModelConfig) -> bool:
    """gemma2 under ``windowed_kv_cache``: its local (even) layers keep a ring
    of ``sliding_window`` slots, its global (odd) layers full lanes."""
    return (cfg.windowed_kv_cache and cfg.local_global_pattern
            and cfg.sliding_window is not None and cfg.n_layers % 2 == 0)


def layer_windows(cfg: ModelConfig) -> list[Optional[int]]:
    """Each layer's sliding window on the decode path (the JAX package's
    ``_layer_flags`` with the widths of ``_dense_block_decode``): None
    without ``sliding_window``; under gemma2's local/global pattern the even
    (local) layers take ``sliding_window`` and the odd (global) ones
    :data:`GLOBAL_WINDOW`; otherwise every layer takes ``sliding_window``."""
    if cfg.sliding_window is None:
        return [None] * cfg.n_layers
    if cfg.local_global_pattern:
        return [cfg.sliding_window if i % 2 == 0 else GLOBAL_WINDOW
                for i in range(cfg.n_layers)]
    return [cfg.sliding_window] * cfg.n_layers


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
                      src_len: int = 0) -> dict:
    """A fresh contiguous decode cache: K (nL, B, Hkv, hd, Lmax) column-wise and
    V (nL, B, Hkv, Lmax, hd) row-wise (the hybrid keeps one KV layer per
    shared-block application and adds the stacked Mamba2 states; a windowed
    gemma2 keeps ``k_loc``/``v_loc`` rings of ``min(sliding_window, max_len)``
    slots for its local layers and ``k``/``v`` lanes for its global ones; the
    audio decoder adds ``cross_k``/``cross_v`` (nL, B, Hkv, ``src_len``, hd)
    for the encoder memory; rwkv6 keeps its recurrent state only: ``wkv``
    (nL, B, H, 64, 64) f32 and the ``att_tail``/``ffn_tail`` (nL, B, d)),
    fill ``pos`` 0 (a scalar, as in the JAX package)."""
    _check_family(cfg)
    kvd = kv_cache_dtype(cfg)
    if windowed_cache_applicable(cfg):
        n_pairs = cfg.n_layers // 2
        w = min(cfg.sliding_window, max_len)
        loc = kv_mapping.init_cache(n_pairs, batch, cfg.n_kv_heads, cfg.head_dim, w, kvd,
                                    device)
        glob = kv_mapping.init_cache(n_pairs, batch, cfg.n_kv_heads, cfg.head_dim, max_len,
                                     kvd, device)
        return {"k_loc": loc["k"], "v_loc": loc["v"], "k": glob["k"], "v": glob["v"],
                "pos": glob["pos"]}
    if cfg.family == "ssm":
        st = rwkv_lib.init_rwkv_state(batch, cfg, device=device)
        cache = {k: v.expand(cfg.n_layers, *v.shape).clone() for k, v in st.items()}
        cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
        return cache
    n_kv = cfg.n_layers
    cache: dict = {}
    if cfg.family == "hybrid":
        n_kv = _hybrid_groups(cfg)
        st = ssm_lib.init_ssm_state(batch, cfg, device=device)
        cache = {k: v.expand(cfg.n_layers, *v.shape).clone() for k, v in st.items()}
    cache.update(kv_mapping.init_cache(n_kv, batch, cfg.n_kv_heads, cfg.head_dim, max_len,
                                       kvd, device))
    cache.pop("layout")
    if cfg.family == "audio":
        for key in ("cross_k", "cross_v"):
            cache[key] = torch.zeros((cfg.n_layers, batch, cfg.n_kv_heads, src_len,
                                      cfg.head_dim), dtype=kvd, device=device)
    return cache


def decode_cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Shape and dtype of every leaf of :func:`init_decode_cache`, without
    allocating (built on the ``meta`` device)."""
    return {k: (tuple(v.shape), v.dtype)
            for k, v in init_decode_cache(cfg, batch, max_len, device="meta").items()}


# ===========================================================================
# blocks
# ===========================================================================


def logits_fn(params: dict, x: torch.Tensor, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """f32 logits of x (the tied head: ``x @ embed.T``), the final-logit
    softcap applied. With ``mesh`` the head is the rank's vocab shard (tied:
    its embedding rows), so are the logits (B, T, V / model), the softcap
    acting on the shard; where ``model`` does not divide the vocab (GSPMD's
    padded vocab, ``dist.sharding``) the rank all-gathers the shards over
    ``model`` and drops the pad columns (B, T, V): the dry run's replicated
    out-spec, one all-gather a call."""
    if cfg.tie_embeddings:
        logits = L.lm_head_tied(params["embed"], x, cfg.logit_softcap)
    else:
        logits = L.lm_head(params["lm_head"], x, cfg.logit_softcap)
    if mesh is not None and cfg.vocab_size % TensorParallel(mesh).size:
        logits = all_gather(logits, mesh, "model", dim=-1).narrow(-1, 0, cfg.vocab_size)
    return logits


def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
           tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Token embeddings; gemma scales them by sqrt(d_model) rounded to the
    activation dtype first, as the JAX package's ``jnp.asarray(d**0.5,
    x.dtype)`` does (bf16: 68.0 for gemma2-27b's 4608). Under ``tp`` a
    vocab-sharded table looks up its own rows ``[index * rows, (index + 1) *
    rows)`` (a padded vocab's pad rows, on the last rank, are never hit) and
    all-reduces over ``model``; the scale acts on the sum."""
    w = params["embed"]["w"]
    if tp is not None and w.shape[0] < cfg.vocab_size:
        x = reduce_from(L.embed_rows(params["embed"], tokens, tp.offset(w.shape[0])), tp.mesh)
    else:
        x = L.embed(params["embed"], tokens)
    if cfg.name.startswith("gemma"):
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
    return x


def _post_norm(lp: dict, name: str, y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return L.rmsnorm(lp[name], y, cfg.norm_eps) if cfg.post_block_norm else y


def _column(tp: Optional[TensorParallel], h: torch.Tensor, split: bool) -> torch.Tensor:
    """The input of a block's products under ``tp`` (``split``: the rank
    holds a share of their columns; ``TensorParallel.column_input``)."""
    return h if tp is None else tp.column_input(h, split)


def _reduced(tp: Optional[TensorParallel], y: torch.Tensor, split: bool) -> torch.Tensor:
    """A block's output under ``tp``: summed over ``model`` where it is the
    rank's partial sum (``split``; ``TensorParallel.reduce``)."""
    return y if tp is None else tp.reduce(y, split)


def _mlp_tail(lp: dict, x: torch.Tensor, cfg: ModelConfig, gemm: bool = False,
              tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """x + the MLP (or MoE) half of a block. Under ``tp`` the normed input
    is the column-parallel products' (``TensorParallel.column_input``:
    gathered over the sequence where it is sharded there), and the
    row-parallel ``w_down``'s partial sums reduced (``TensorParallel.reduce``)."""
    h = L.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
    split = tp is not None and _mlp_split(lp["mlp"], cfg)
    h = _column(tp, h, split)
    if cfg.family == "moe":
        m = moe_lib.moe_einsum(lp["moe"], h, cfg)   # float experts in every form, as in JAX
    elif gemm:
        m = L.mlp(lp["mlp"], h, linear_fn=attn_lib._dense_matmul)
    else:
        m = dispatch.mlp(lp["mlp"], h, cfg)  # W8A8 GEMVs under quantized_decode
    m = _reduced(tp, m, split)
    return x + _post_norm(lp, "post_mlp_norm", m, cfg)


def _attn_residual(lp, x, kc, vc, pos, cfg: ModelConfig, window: Optional[int] = None,
                   gemm: bool = False, tp: Optional[TensorParallel] = None):
    """The attention half of a block over a contiguous cache: x + attention
    (under ``tp`` reduced over ``model``)."""
    h = L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    a = attn_lib.attention_decode(lp["attn"], h, kc, vc, pos, cfg, window=window, gemm=gemm,
                                  tp=tp)
    a = _reduced(tp, a, tp is not None and _heads_split(lp["attn"], cfg))
    return x + _post_norm(lp, "post_attn_norm", a, cfg)


def _dense_block_decode(lp, x, kc, vc, pos, cfg: ModelConfig, window: Optional[int] = None,
                        gemm: bool = False, tp: Optional[TensorParallel] = None):
    return _mlp_tail(lp, _attn_residual(lp, x, kc, vc, pos, cfg, window=window, gemm=gemm,
                                        tp=tp), cfg, gemm=gemm, tp=tp)


def _dense_block_decode_paged(lp, x, kp, vp, table, pos, cfg: ModelConfig,
                              window: Optional[int] = None, gemm: bool = False):
    h = L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    a = attn_lib.attention_decode_paged(lp["attn"], h, kp, vp, table, pos, cfg,
                                        window=window, gemm=gemm)
    return _mlp_tail(lp, x + _post_norm(lp, "post_attn_norm", a, cfg), cfg, gemm=gemm)


# ===========================================================================
# decode step
# ===========================================================================


PARTITIONED_FAMILIES = ("dense", "vlm", "audio")


def check_partitioned(cfg: ModelConfig, mesh, cache: Optional[dict] = None) -> None:
    """Raise unless the partitioned program covers ``cfg`` (and ``cache``)
    on ``mesh``: the dense family (llama-style and gemma2), vlm and audio,
    with float linears over contiguous lanes (gemma2's local layers over
    full lanes, their window a live range), its query heads split evenly
    over ``model``."""
    from repro_torch.launch.mesh import axis_size

    if cfg.family not in PARTITIONED_FAMILIES:
        raise ValueError(f"{cfg.name}: the partitioned program covers the dense family "
                         f"(llama3-8b, yi-9b, codeqwen1.5-7b, gemma2-27b), vlm "
                         f"(internvl2-2b) and audio (seamless-m4t-large-v2); the "
                         f"{cfg.family} family (MoE, the hybrid, rwkv6's ssm) is later work")
    if cfg.quantized_decode:
        raise ValueError("W8A8 (quantized_decode) is not partitioned, as in the JAX package")
    if windowed_cache_applicable(cfg) or (cache is not None and "k_loc" in cache):
        raise ValueError(f"{cfg.name}: gemma2's W-slot rings (windowed_kv_cache) are not "
                         f"partitioned: the JAX dry run never builds them (its gemma2 cells "
                         f"keep full lanes, each local layer's window a live range)")
    if cache is not None and "k" not in cache:
        raise ValueError("the partitioned program takes contiguous lanes ('k'/'v'); the "
                         "paged cache is not partitioned, as in the JAX package")
    n = axis_size(mesh, "model")
    if cfg.n_heads % n:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} query heads do not split over the "
                         f"{n} ranks of 'model'")


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig,
                *, gemm: bool = False, mesh=None):
    """T tokens per lane: tokens (B, T) -> (logits (B, T, V), cache').

    ``cache`` is fully paged (``k_pages``/``v_pages`` (nL, P, H, ...),
    ``block_table`` (B, NB)), contiguous (``k``/``v`` (nL, B, H, ...), plus
    the hybrid's Mamba2 states or the audio decoder's encoder memory
    ``cross_k``/``cross_v``), a windowed gemma2's rings and global lanes
    (``k_loc``/``v_loc``/``k``/``v``, one token a step), or rwkv6's recurrent
    state alone (``wkv``/``att_tail``/``ffn_tail``), with ``pos`` the
    per-lane fill (B,) or a scalar. Every cache tensor is written IN PLACE
    and the returned cache shares them, with ``pos`` advanced by T.
    ``gemm=True`` runs the batch-prefill form (float GEMMs, dense attention at
    any T); rwkv6 has no other form. With ``mesh`` it is the partitioned
    step (the module's docstring): params, cache and tokens are the rank's
    shards, and so are the logits (B_rank, T, V / model; a padded vocab's
    gathered, :func:`logits_fn`) and the cache.
    """
    x, new_cache = _forward(params, cache, tokens, cfg, gemm=gemm, mesh=mesh)
    return logits_fn(params, x, cfg, mesh), new_cache


def _forward(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig,
             *, gemm: bool = False, mesh=None):
    """:func:`decode_step` up to the final norm: (hidden (B, T, d), cache')."""
    _check_family(cfg)
    tp = None
    if mesh is not None:
        check_partitioned(cfg, mesh, cache)   # dense, vlm, audio over contiguous lanes
        tp = TensorParallel(mesh)
    if cfg.family == "hybrid":
        return _hybrid_forward(params, cache, tokens, cfg, gemm=gemm)
    if cfg.family == "ssm":
        return _rwkv_forward(params, cache, tokens, cfg)
    if cfg.family == "audio":
        return _audio_forward(params, cache, tokens, cfg, gemm=gemm, tp=tp)
    if "k_loc" in cache:
        return _windowed_forward(params, cache, tokens, cfg)
    pos = cache["pos"]
    x = _embed(params, tokens, cfg, tp)
    windows = layer_windows(cfg)
    if "k_pages" in cache:
        table = cache["block_table"]
        kp_all, vp_all = cache["k_pages"], cache["v_pages"]
        for i, lp in enumerate(params["layers"]):
            x = _dense_block_decode_paged(lp, x, kp_all[i], vp_all[i], table, pos, cfg,
                                          window=windows[i], gemm=gemm)
        new_cache = {"k_pages": kp_all, "v_pages": vp_all, "block_table": table,
                     "pos": pos + tokens.shape[1]}
    else:
        k_all, v_all = cache["k"], cache["v"]
        for i, lp in enumerate(params["layers"]):
            x = _dense_block_decode(lp, x, k_all[i], v_all[i], pos, cfg, window=windows[i],
                                    gemm=gemm, tp=tp)
        new_cache = {"k": k_all, "v": v_all, "pos": pos + tokens.shape[1]}
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), new_cache


def _windowed_forward(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """gemma2 over rings: (local, global) layer pairs in layer order; the
    local layer attends over its W-slot ring (``attention_decode_ring``), the
    global one over its full lane (no window)."""
    pos = cache["pos"]
    x = _embed(params, tokens, cfg)
    layers = params["layers"]
    for i in range(cfg.n_layers // 2):
        loc, glob = layers[2 * i], layers[2 * i + 1]
        h = L.rmsnorm(loc["attn_norm"], x, cfg.norm_eps)
        a = attn_lib.attention_decode_ring(loc["attn"], h, cache["k_loc"][i],
                                           cache["v_loc"][i], pos, cfg)
        x = _mlp_tail(loc, x + _post_norm(loc, "post_attn_norm", a, cfg), cfg)
        x = _dense_block_decode(glob, x, cache["k"][i], cache["v"][i], pos, cfg)
    new_cache = {k: cache[k] for k in ("k_loc", "v_loc", "k", "v")}
    new_cache["pos"] = pos + tokens.shape[1]
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), new_cache


def _hybrid_forward(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig,
                    *, gemm: bool = False):
    """zamba2: ``attn_every`` Mamba2 layers, then the shared attention + MLP
    block against that application's KV layer; the trailing layers after the
    last application run Mamba2 only. Mamba2 states are written back IN
    PLACE into their layer's slice of the stacked state."""
    pos = cache["pos"]
    n_groups = _hybrid_groups(cfg)
    acfg = cfg.replace(family="dense")
    shared = params["shared_attn"]
    x = L.embed(params["embed"], tokens)

    def mamba(li: int, h: torch.Tensor) -> torch.Tensor:
        lp = params["mamba_layers"][li]
        st = {k: cache[k][li] for k in SSM_STATE_KEYS}
        y, st2 = ssm_lib.ssm_decode_step(lp["ssm"], L.rmsnorm(lp["norm"], h, cfg.norm_eps),
                                         st, cfg)
        for k in SSM_STATE_KEYS:
            st[k].copy_(st2[k])                          # in place
        return h + y

    for gi in range(n_groups):
        for li in range(gi * cfg.attn_every, (gi + 1) * cfg.attn_every):
            x = mamba(li, x)
        x = _dense_block_decode(shared, x, cache["k"][gi], cache["v"][gi], pos, acfg,
                                gemm=gemm)
    for li in range(n_groups * cfg.attn_every, cfg.n_layers):
        x = mamba(li, x)
    new_cache = {k: cache[k] for k in (*SSM_STATE_KEYS, "k", "v")}
    new_cache["pos"] = pos + tokens.shape[1]
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), new_cache


def _rwkv_forward(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """rwkv6: the input layernorm, then each RWKV6 block over the T tokens
    from its layer's state, written back IN PLACE into that layer's slice of
    the stacked ``wkv``/``att_tail``/``ffn_tail`` (no kernel: the JAX
    package has none for it either)."""
    x = L.layernorm(params["ln_in"], L.embed(params["embed"], tokens), cfg.norm_eps)
    for i, lp in enumerate(params["layers"]):
        st = {k: cache[k][i] for k in rwkv_lib.STATE_KEYS}
        x, st2 = rwkv_lib.rwkv_block(lp["block"], x, st, cfg, lp["ln1"], lp["ln2"],
                                     cfg.norm_eps)
        for k in rwkv_lib.STATE_KEYS:
            st[k].copy_(st2[k])                          # in place
    new_cache = {k: cache[k] for k in rwkv_lib.STATE_KEYS}
    new_cache["pos"] = cache["pos"] + tokens.shape[1]
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), new_cache


def _audio_forward(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig,
                   *, gemm: bool = False, tp: Optional[TensorParallel] = None):
    """The audio decoder: per layer, self attention over its contiguous lanes
    (written in place; one token takes B4 and, under W8A8, the B3 GEMVs),
    cross attention over the layer's encoder memory K/V, then the MLP. Under
    ``tp`` each block is the rank's share, reduced over ``model``."""
    if cache["cross_k"].shape[-2] == 0:
        raise ValueError("the audio decoder's cache holds no encoder memory: it is "
                         "filled by prefill(..., src_frames=...), which takes the "
                         "source frames (the engine's admission passes none)")
    pos = cache["pos"]
    x = _embed(params, tokens, cfg, tp)
    for i, lp in enumerate(params["dec_layers"]):
        x = _attn_residual(lp, x, cache["k"][i], cache["v"][i], pos, cfg, gemm=gemm, tp=tp)
        x = _cross_residual(lp, x, cache["cross_k"][i], cache["cross_v"][i], cfg, tp)
        x = _mlp_tail(lp, x, cfg, gemm=gemm, tp=tp)
    new_cache = {k: cache[k] for k in ("k", "v", "cross_k", "cross_v")}
    new_cache["pos"] = pos + tokens.shape[1]
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), new_cache


def _heads_split(p: dict, cfg: ModelConfig) -> bool:
    """Does the rank hold a share of an attention block's ``wo`` rows?"""
    return p["wo"].shape[0] < cfg.n_heads * cfg.head_dim


def _mlp_split(p: dict, cfg: ModelConfig) -> bool:
    """Does the rank hold a share of an MLP's ``w_down`` rows?"""
    return p["w_down"].shape[0] < cfg.d_ff


def _cross_residual(lp: dict, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                    cfg: ModelConfig, tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """x + the cross-attention block over one layer's encoder-memory K/V
    (under ``tp`` the rank's query heads over their window, its partial sum
    of ``wo`` reduced over ``model``)."""
    split = _heads_split(lp["cross_attn"], cfg)
    h = _column(tp, L.rmsnorm(lp["cross_norm"], x, cfg.norm_eps), split)
    return x + _reduced(tp, attn_lib.attention_cross(lp["cross_attn"], h, (ck, cv), cfg, tp=tp),
                        split)


def _audio_encode(params: dict, frames: torch.Tensor, cfg: ModelConfig,
                  tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """The bidirectional encoder over stub frames (B, S, d) -> memory (B, S, d).
    Under ``tp`` each layer's attention and MLP are the rank's share (its
    heads, its MLP columns), each half reduced over ``model``; the JAX
    package puts no sequence-parallel constraint on this stack, so neither
    does the port."""
    def body(lp, h):
        sa, sm = _heads_split(lp["attn"], cfg), _mlp_split(lp["mlp"], cfg)
        a = attn_lib.attention_dense(
            lp["attn"], _column(tp, L.rmsnorm(lp["attn_norm"], h, cfg.norm_eps), sa), cfg,
            causal=False, tp=tp)
        h = h + _reduced(tp, a, sa)
        m = L.mlp(lp["mlp"], _column(tp, L.rmsnorm(lp["mlp_norm"], h, cfg.norm_eps), sm),
                  linear_fn=attn_lib._dense_matmul)
        return h + _reduced(tp, m, sm)

    h = frames
    for lp in params["enc_layers"]:
        h = _remat(body, cfg)(lp, h)
    return L.rmsnorm(params["enc_norm"], h, cfg.norm_eps)


def project_cross_kv(params: dict, mem: torch.Tensor, cfg: ModelConfig,
                     tp: Optional[TensorParallel] = None):
    """Every decoder layer's cross-attention K/V of the encoder memory:
    (k, v), each (nL, B, Hkv, S, hd). Under ``tp`` every head too: each
    layer's K/V columns gathered over ``model``
    (``attention.project_memory_kv``); the memory is the input of all of
    them, so its gradient is summed over ``model`` once."""
    mem = _column(tp, mem, True)
    kvs = [attn_lib.project_memory_kv(lp["cross_attn"], mem, cfg, tp)
           for lp in params["dec_layers"]]
    return torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])


# ===========================================================================
# full-sequence forward (training; the hybrid prefill) and loss
# ===========================================================================


def _remat(fn: Callable, cfg: ModelConfig, collect: bool = False) -> Callable:
    """``fn`` recomputed in the backward pass (``torch.utils.checkpoint``)
    where ``cfg.remat`` is set and nothing is collected from it: where the
    JAX package wraps a layer body in ``jax.checkpoint``. The forward draws
    no random numbers, so no RNG state is stashed for the recompute (reading
    and restoring the card's generator state has no place in a captured
    train step)."""
    if not cfg.remat or collect:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def _dense_block(lp: dict, x: torch.Tensor, cfg: ModelConfig, window: Optional[int] = None,
                 return_kv: bool = False, tp: Optional[TensorParallel] = None):
    """One pre-norm block over the whole sequence x (B, S, d): causal
    attention (gemma2's local layers with their ``window``: the JAX
    package's ``_windowed_attn`` is this attention with the window its layer
    flag selects, a global layer's window covering every key), the optional
    post-norms, then the MLP or, for MoE, ``moe_einsum`` over all B·S tokens.
    With ``return_kv`` also the layer's (k, v) (B, Hkv, S, hd).

    The JAX package constrains ``x`` here to shard its sequence dim over the
    ``model`` axis when ``cfg.seq_parallel`` is set (``_sp_constraint``), a
    layout hint that is the identity without a mesh. This form runs on one
    rank, where it is the identity too, so ``seq_parallel`` changes nothing
    here. Under ``tp`` (the partitioned train step, :func:`loss_fn` with
    ``mesh``) it is the rank's share of the block: its heads and MLP
    columns, each half's partial sum reduced over ``model`` (under
    ``tp.seq`` x is the rank's share of the sequence, gathered for each
    half's products and scattered after)."""
    h = _column(tp, L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps), True)
    out = attn_lib.attention_dense(lp["attn"], h, cfg, window=window, return_kv=return_kv,
                                   tp=tp)
    a, kv = out if return_kv else (out, None)
    a = _reduced(tp, a, True)
    x = _mlp_tail(lp, x + _post_norm(lp, "post_attn_norm", a, cfg), cfg, gemm=True, tp=tp)
    return (x, kv) if return_kv else x


def _scan_layers(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """The dense, vlm and MoE stack over the whole sequence, each layer with
    its window (:func:`layer_windows`)."""
    for lp, window in zip(params["layers"], layer_windows(cfg)):
        x = _remat(_dense_block, cfg)(lp, x, cfg, window, False, tp)
    return x


def _rwkv_forward_seq(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """rwkv6 over the whole sequence from zero state: the input layernorm,
    then every RWKV6 block (its final state dropped)."""
    x = L.layernorm(params["ln_in"], x, cfg.norm_eps)
    st0 = rwkv_lib.init_rwkv_state(x.shape[0], cfg, device=x.device)

    def body(lp, h):
        return rwkv_lib.rwkv_block(lp["block"], h, st0, cfg, lp["ln1"], lp["ln2"],
                                   cfg.norm_eps)[0]

    for lp in params["layers"]:
        x = _remat(body, cfg)(lp, x)
    return x


def _hybrid_forward_seq(params: dict, x: torch.Tensor, cfg: ModelConfig,
                        collect: bool = False):
    """zamba2 over the whole sequence from zero state: groups of
    ``attn_every`` Mamba2 layers (``ssm_forward``), each followed by the
    shared attention + MLP block, then the trailing Mamba2 layers. Returns
    (x, states, kvs): with ``collect`` the final Mamba2 states stacked over
    all layers (``ssd``/``conv_x``/``conv_bc``, (nL, B, ...)) and the shared
    block's K/V per application ((G, B, Hkv, S, hd) each, None for no
    group), else (x, None, None), each group under ``cfg.remat``."""
    acfg = cfg.replace(family="dense")
    n_groups = _hybrid_groups(cfg)
    st0 = ssm_lib.init_ssm_state(x.shape[0], cfg, device=x.device)
    states, kvs = [], []

    def mamba(li, h):
        lp = params["mamba_layers"][li]
        y, st = ssm_lib.ssm_forward(lp["ssm"], L.rmsnorm(lp["norm"], h, cfg.norm_eps), cfg, st0)
        if collect:
            states.append(st)
        return h + y

    def group(gi, h):
        for li in range(gi * cfg.attn_every, (gi + 1) * cfg.attn_every):
            h = mamba(li, h)
        if not collect:
            return _dense_block(params["shared_attn"], h, acfg)
        h, kv = _dense_block(params["shared_attn"], h, acfg, return_kv=True)
        kvs.append(kv)
        return h

    for gi in range(n_groups):
        x = _remat(group, cfg, collect)(gi, x)
    for li in range(n_groups * cfg.attn_every, cfg.n_layers):
        x = mamba(li, x)
    if not collect:
        return x, None, None
    stacked = {k: torch.stack([st[k] for st in states]) for k in SSM_STATE_KEYS}
    kv = (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])) if kvs else None
    return x, stacked, kv


def _audio_decode_stack(params: dict, x: torch.Tensor, cross_kv, cfg: ModelConfig,
                        tp: Optional[TensorParallel] = None):
    """The audio decoder over the whole sequence: per layer causal self
    attention, cross attention over that layer's encoder-memory K/V
    (``cross_kv``: (k, v), each (nL, B, Hkv, S_src, hd)), then the MLP.
    Under ``tp`` each of the three is the rank's share, reduced over
    ``model``."""
    def body(lp, ck, cv, h):
        sa, sm = _heads_split(lp["attn"], cfg), _mlp_split(lp["mlp"], cfg)
        a = attn_lib.attention_dense(
            lp["attn"], _column(tp, L.rmsnorm(lp["attn_norm"], h, cfg.norm_eps), sa), cfg,
            tp=tp)
        h = _cross_residual(lp, h + _reduced(tp, a, sa), ck, cv, cfg, tp)
        m = L.mlp(lp["mlp"], _column(tp, L.rmsnorm(lp["mlp_norm"], h, cfg.norm_eps), sm),
                  linear_fn=attn_lib._dense_matmul)
        return h + _reduced(tp, m, sm)

    for lp, ck, cv in zip(params["dec_layers"], *cross_kv):
        x = _remat(body, cfg)(lp, ck, cv, x)
    return x


def forward(params: dict, batch: dict, cfg: ModelConfig, *, mesh=None) -> torch.Tensor:
    """The full-sequence forward: ``batch`` {``tokens`` (B, S), and for vlm
    optionally ``prefix_embeds`` (B, P, d), for audio ``src_frames`` (B, S_src,
    d)} -> final-normed hidden states (B, S, d). gemma scales the embeddings
    by sqrt(d_model) rounded to the activation dtype; vlm runs the stack over
    the prefix and the tokens and keeps the tokens' rows; audio encodes the
    frames, projects each decoder layer's cross K/V and runs the decoder.

    With ``mesh`` it is the partitioned forward of the dense, vlm and audio
    families (:func:`train_parallel`): params and inputs the rank's shards,
    the result its rows, under ``cfg.seq_parallel`` (S >= 16) its share of
    the sequence (a vlm with a prefix: the whole sequence, gathered, before
    its tokens' rows are kept)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    n = stack_len(cfg, batch)
    tp = None if mesh is None else train_parallel(cfg, mesh, n)
    if cfg.family == "ssm":
        x = _rwkv_forward_seq(params, L.embed(params["embed"], tokens), cfg)
    elif cfg.family == "hybrid":
        x, _, _ = _hybrid_forward_seq(params, L.embed(params["embed"], tokens), cfg)
    else:
        x = _forward_stack(params, batch, cfg, tp)
        if n == tokens.shape[1]:
            return x
        if tp is not None:
            x = tp.gather_seq(x)
        return x[:, n - tokens.shape[1]:]
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def stack_len(cfg: ModelConfig, batch: dict) -> int:
    """The positions a batch runs through the decoder stack: its tokens, and
    a vlm's prefix rows before them."""
    prefix = batch.get("prefix_embeds") if cfg.family == "vlm" else None
    return batch["tokens"].shape[1] + (0 if prefix is None else prefix.shape[1])


def train_parallel(cfg: ModelConfig, mesh, seq_len: int) -> TensorParallel:
    """The rank's :class:`TensorParallel` for the partitioned forward and loss
    of ``seq_len`` positions (:func:`stack_len`): :func:`check_partitioned`,
    and every attention and MLP width split over ``model`` (a product
    replicated there would take a partial gradient that the step does not
    sum); sequence parallelism under ``cfg.seq_parallel`` with ``seq_len``
    >= 16, as the prefill takes it, for the dense and vlm stacks (the JAX
    package constrains the dense block only, not the audio stacks)."""
    from repro_torch.launch.mesh import MODEL_SHARD

    check_partitioned(cfg, mesh)
    widths = {"n_heads * head_dim": cfg.n_heads * cfg.head_dim,
              "n_kv_heads * head_dim": cfg.n_kv_heads * cfg.head_dim, "d_ff": cfg.d_ff}
    for name, n in widths.items():
        if n % MODEL_SHARD:
            raise ValueError(f"{cfg.name}: {name} = {n} is not split over 'model' (it does "
                             f"not divide by {MODEL_SHARD}); the partitioned train step "
                             f"takes split products only")
    return _tensor_parallel(cfg, mesh, seq_len)


def _tensor_parallel(cfg: ModelConfig, mesh, seq_len: int) -> TensorParallel:
    """The rank's :class:`TensorParallel` over a stack of ``seq_len``
    positions: sequence parallel under ``cfg.seq_parallel`` from 16
    positions, the dense and vlm stacks only."""
    seq = cfg.seq_parallel and seq_len >= 16 and cfg.family != "audio"
    tp = TensorParallel(mesh, seq=seq)
    if tp.seq and seq_len % tp.size:
        raise ValueError(f"sequence parallelism: {seq_len} positions do not split over the "
                         f"{tp.size} ranks of 'model'")
    return tp


def partial_over_model(cfg: ModelConfig, mesh, seq_len: int) -> tuple[str, ...]:
    """The stacked paths of the params that :func:`loss_fn` with ``mesh``
    leaves replicated over ``model`` but gives each rank a partial gradient
    of, which sums over ``model`` to the whole: under sequence parallelism
    every norm scale (each rank normalizes its share of the sequence;
    gemma2's post-norms too, which act on the reduced, scattered block
    output). Nothing else: a norm's input gradient comes whole from the
    column input's reduction, and the q/k/v biases, stacked (nL, n), split
    over ``model`` as their weights' columns do.

    The tied embedding (gemma2) needs no path of its own: the rank's rows
    take the lookup's part of their gradient (from the whole gradient of the
    lookup's output, which its reduction passes unchanged) and the head's
    part (its vocab columns against the whole final hidden state, which the
    head's input gathers or sums over ``model``), both whole, on the same
    shard."""
    if not train_parallel(cfg, mesh, seq_len).seq:
        return ()
    names = ("attn_norm", "mlp_norm")
    if cfg.post_block_norm:
        names += ("post_attn_norm", "post_mlp_norm")
    return (*(f"layers/{n}/scale" for n in names), "final_norm/scale")


def _forward_stack(params: dict, batch: dict, cfg: ModelConfig,
                   tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """:func:`forward` of the dense, vlm, MoE and audio families through the
    final norm, before a vlm's prefix rows are dropped; under ``tp`` the
    rank's share (under ``tp.seq`` its share of the sequence, a vlm's prefix
    included)."""
    tokens = batch["tokens"]
    if cfg.family == "audio":
        mem = _audio_encode(params, batch["src_frames"].to(torch_dtype(cfg.dtype)), cfg, tp)
        x = _audio_decode_stack(params, _embed(params, tokens, cfg, tp),
                                project_cross_kv(params, mem, cfg, tp), cfg, tp)
        return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    x = _embed(params, tokens, cfg, tp)
    prefix = batch.get("prefix_embeds") if cfg.family == "vlm" else None
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    if tp is not None:
        x = tp.local_seq(x)
    return L.rmsnorm(params["final_norm"], _scan_layers(params, x, cfg, tp), cfg.norm_eps)


def _vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor, tp: TensorParallel,
                         vocab: int) -> torch.Tensor:
    """The summed cross-entropy of f32 ``logits`` (B, C, V / model), the
    rank's vocab columns (the final-logit softcap already applied), against
    ``labels`` (B, C), through two f32 all-reduces over ``model`` a chunk:
    (1) the max of each position's logits (detached: the log-sum-exp does
    not depend on it), (2) the sum of each position's exps beside its gold
    logit, which lives on one rank and is zero elsewhere (one stacked
    reduction of the loss's two statistics a token). A padded vocab's pad
    columns (past ``vocab``, on the last rank) are masked out of both, so
    the loss is the unpadded one and the pad takes no gradient."""
    n = logits.shape[-1]
    lo = tp.offset(n)
    if lo + n > vocab:
        pad = torch.arange(lo, lo + n, device=logits.device) >= vocab
        logits = logits.masked_fill(pad, float("-inf"))
    mx = all_reduce(logits.detach().amax(-1), tp.mesh, "model", op="max")
    local = labels - lo
    hit = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = torch.where(hit, gold, torch.zeros((), dtype=gold.dtype, device=gold.device))
    stats = reduce_from(torch.stack([torch.exp(logits - mx[..., None]).sum(-1), gold]),
                        tp.mesh, "model")
    return (torch.log(stats[0]) + mx - stats[1]).sum()


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, chunk: int = 1024, *,
            mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy over the B·S positions of ``batch``
    (``labels`` (B, S) beside the :func:`forward` inputs), in f32: the head
    (tied: the embedding) runs ``chunk`` positions at a time (one chunk if
    it does not divide S), with the final-logit softcap, so (B, S, V) logits
    never exist at once. MoE adds 0.01 x :func:`moe.aux_load_balance_loss` of
    layer 0's router over the first min(S, 512) final-normed hidden states,
    as the JAX package computes it.

    With ``mesh`` it is the partitioned loss of the dense, vlm and audio
    families over the rank's rows (the mean over them, the same on every
    rank of ``model``): the forward of :func:`forward` with ``mesh``, the
    final hidden states gathered over the sequence under sequence
    parallelism (a vlm's prefix rows then dropped), the head's vocab columns
    (tied: the embedding's rows) and :func:`_vocab_parallel_xent` a chunk."""
    labels = batch["labels"].long()
    if mesh is not None:
        tp = train_parallel(cfg, mesh, stack_len(cfg, batch))
        x = tp.column_input(_forward_stack(params, batch, cfg, tp), True)
        x = x[:, x.shape[1] - labels.shape[1]:]
    else:
        x = forward(params, batch, cfg)
    b, s, _ = x.shape
    w = params["embed"]["w"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    c = min(chunk, s)
    if s % c != 0:
        c = s
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s, c):
        logits = L.softcap((x[:, lo:lo + c] @ w).float(), cfg.logit_softcap)
        if mesh is not None:
            total = total + _vocab_parallel_xent(logits, labels[:, lo:lo + c], tp,
                                                 cfg.vocab_size)
            continue
        gold = torch.gather(logits, -1, labels[:, lo:lo + c, None])[..., 0]
        total = total + (torch.logsumexp(logits, dim=-1) - gold).sum()
    loss = total / (b * s)
    if cfg.family == "moe":
        loss = loss + 0.01 * moe_lib.aux_load_balance_loss(params["layers"][0]["moe"],
                                                           x[:, :min(s, 512)], cfg)
    return loss


# ===========================================================================
# prefill
# ===========================================================================


def _prefill_forward(params: dict, cache: dict, x: torch.Tensor, cfg: ModelConfig,
                     step: int, tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """:func:`prefill`'s pass over the embedded inputs x (B, S, d) up to the
    final norm, layer by layer: each layer projects its Q/K/V once, writes
    its K/V into the contiguous ``cache`` (in place) and attends ``step``
    queries at a time (``attention_prefill``); its MLP tail takes the layer's
    whole (B, S) batch, as the JAX ``prefill`` computes it (which a MoE's
    capacity dispatch needs). Under ``tp`` each half is reduced once a layer;
    under ``tp.seq`` x is the rank's share of the sequence and so is the
    result."""
    windows = layer_windows(cfg)
    for i, lp in enumerate(params["layers"]):
        split = tp is not None and _heads_split(lp["attn"], cfg)
        h = _column(tp, L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps), split)
        a = attn_lib.attention_prefill(lp["attn"], h, cache["k"][i], cache["v"][i], cfg,
                                       step=step, window=windows[i], tp=tp)
        a = _reduced(tp, a, split)
        x = _mlp_tail(lp, x + _post_norm(lp, "post_attn_norm", a, cfg), cfg, gemm=True, tp=tp)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def _last_hidden(x: torch.Tensor, seq_lens) -> torch.Tensor:
    """Each row's last-token hidden state (B, 1, d): row i reads position
    ``seq_lens[i] - 1`` (None: the last position)."""
    if seq_lens is None:
        return x[:, -1:, :]
    idx = torch.as_tensor(seq_lens, device=x.device).long() - 1
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None, :]


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, max_len: int,
            seq_lens=None, *, prefix_embeds: Optional[torch.Tensor] = None,
            src_frames: Optional[torch.Tensor] = None, mesh=None):
    """Whole prompts in one pass: tokens (B, S) -> (logits at each row's last
    token (B, 1, V), a fresh decode cache filled to S, ``pos`` the scalar S).
    ``seq_lens`` (B,) marks each row's true length in a right-padded ragged
    batch; its logits are read at ``seq_lens - 1``.

    The dense, vlm and MoE pass is the batch-prefill form of
    :func:`decode_step` (``gemm=True``: float GEMMs, dense masked attention
    with each layer's window) into a fresh full-length contiguous cache,
    layer by layer: the attention ``cfg.q_chunk`` queries at a time, so one
    layer's f32 scores stay (B, Hq, q_chunk, max_len), then the layer's MLP
    or MoE over all B·S tokens at once, pads included, in row-major order, as
    the JAX ``prefill`` groups them (:func:`_prefill_forward`). A windowed
    gemma2 then places each local layer's last W tokens into their ring slots
    (slot ``t % W`` holds token ``t``; a prompt shorter than W leaves the
    surplus slots holding its last token, masked at decode by ``end = min(pos
    + 1, W)``) and keeps the global layers' lanes.

    ``prefix_embeds`` (B, P, d), vlm only: precomputed patch embeddings put
    before the tokens; positions, the cache fill, ``pos`` (S + P) and
    ``seq_lens`` (read at P + seq_lens - 1) all shift by P. ``src_frames``
    (B, S_src, d), required by the audio family: the encoder runs over them,
    each decoder layer's cross K/V of its memory fills ``cross_k``/``cross_v``
    and the decoder runs over the tokens (usually one BOS each). rwkv6 runs
    its blocks over the tokens from zero state; the cache is the final
    state (pads included, as in the JAX package). The hybrid runs its
    full-sequence form (:func:`_hybrid_forward_seq`) from zero state and
    keeps each Mamba2 layer's final state and each shared-block
    application's K/V, stored in the cache's dtype (pads included, as in
    the JAX package).

    With ``mesh`` it is the partitioned prefill of the dense, vlm and audio
    families (the module's docstring): params, tokens, ``prefix_embeds``,
    ``src_frames`` (and ``seq_lens``) are the rank's shards, and the logits
    (B_rank, 1, V / model; a padded vocab's gathered, (B_rank, 1, V)) and
    the cache its own."""
    _check_family(cfg)
    if prefix_embeds is not None and cfg.family != "vlm":
        raise ValueError(f"prefix_embeds is the vlm family's input, not {cfg.family!r}'s")
    if cfg.family == "audio" and src_frames is None:
        raise ValueError("the audio family's prefill needs src_frames (B, S, d_model): "
                         "the encoder's input")
    if mesh is not None:
        check_partitioned(cfg, mesh)
    b, s = tokens.shape
    dev = tokens.device
    if prefix_embeds is not None:
        s += prefix_embeds.shape[1]
    tp = None if mesh is None else _tensor_parallel(cfg, mesh, s)
    if cfg.family == "ssm":
        x, cache = _rwkv_forward(params, init_decode_cache(cfg, b, max_len, device=dev),
                                 tokens, cfg)
        return logits_fn(params, _last_hidden(x, seq_lens), cfg), cache
    if cfg.family == "hybrid":
        x, states, kvs = _hybrid_forward_seq(params, L.embed(params["embed"], tokens), cfg,
                                             collect=True)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        cache = init_decode_cache(cfg, b, max_len, device=dev)
        for k in SSM_STATE_KEYS:
            cache[k].copy_(states[k])
        if kvs is not None:   # K/V in the compute dtype until stored, as the JAX prefill
            cache["k"][..., :s].copy_(kvs[0].transpose(-1, -2))
            cache["v"][..., :s, :].copy_(kvs[1])
        cache["pos"] = torch.tensor(s, dtype=torch.int32, device=dev)
        return logits_fn(params, _last_hidden(x, seq_lens), cfg), cache
    if cfg.family == "audio":   # K/V in the compute dtype until stored, as below
        mem = _audio_encode(params, src_frames.to(torch_dtype(cfg.dtype)), cfg, tp)
        cache = init_decode_cache(cfg.replace(kv_dtype=""), b, max_len, device=dev,
                                  src_len=mem.shape[1])
        cross_k, cross_v = project_cross_kv(params, mem, cfg, tp)
        cache["cross_k"].copy_(cross_k)
        cache["cross_v"].copy_(cross_v)
        x, cache = _audio_forward(params, cache, tokens, cfg, gemm=True, tp=tp)
        kvd = kv_cache_dtype(cfg)
        cache.update({k: cache[k].to(kvd) for k in ("k", "v", "cross_k", "cross_v")})
        return logits_fn(params, _last_hidden(x, seq_lens), cfg, mesh), cache
    x = _embed(params, tokens, cfg, tp)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        if seq_lens is not None:
            seq_lens = torch.as_tensor(seq_lens, device=dev) + prefix_embeds.shape[1]
    # the pass attends over K/V in the compute dtype, and the cache takes its own
    # dtype only when stored (an fp8 ``kv_dtype``), as the JAX prefill casts its
    # collected K/V; with kv_dtype == dtype the casts below return the tensors
    full = init_decode_cache(cfg.replace(windowed_kv_cache=False, kv_dtype=""), b, max_len,
                             device=dev)
    if tp is not None:
        x = tp.local_seq(x)
    x = _prefill_forward(params, full, x, cfg, max(int(cfg.q_chunk), 1), tp)
    if tp is not None:
        x = tp.gather_seq(x)
    kvd = kv_cache_dtype(cfg)
    full = {"k": full["k"].to(kvd), "v": full["v"].to(kvd)}
    logits = logits_fn(params, _last_hidden(x, seq_lens), cfg, mesh)
    pos = torch.tensor(s, dtype=torch.int32, device=dev)
    if not windowed_cache_applicable(cfg):
        return logits, {"k": full["k"], "v": full["v"], "pos": pos}
    w = min(cfg.sliding_window, max_len)
    slots = torch.arange(w, device=dev)
    t_idx = (s - w + (slots - (s - w)) % w) if s >= w else slots.clamp_max(s - 1)
    return logits, {"k_loc": full["k"][0::2].index_select(-1, t_idx),
                    "v_loc": full["v"][0::2].index_select(-2, t_idx),
                    "k": full["k"][1::2].contiguous(), "v": full["v"][1::2].contiguous(),
                    "pos": pos}
