"""Token sampling: ONE masked-sampling path for the decode pool (port of
``repro.serve.sampling``).

``sample_masked`` is the engine's only sampler: per-slot temperature / top-k /
top-p / key vectors ride beside the ``done`` mask, and ``temperature == 0``
lanes take the exact argmax, so a greedy request is bit-identical whether its
batch siblings sample or not. ``greedy_masked`` is the all-greedy fast path.

RNG lanes are per REQUEST: :func:`request_key` derives a base key from the
request's own seed and a prompt hash, :func:`token_key` folds in the emitted
token's index. The keys are the JAX package's bit for bit (the port's own
threefry, :mod:`repro_torch.serve.prng`), so the same request draws the same
tokens in both packages on the same logits.
"""
from __future__ import annotations

import torch

from repro_torch.serve import prng

NEG_FILL = -1e30  # filtered-out logit value (f32-safe)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, T, V) → (B,) int32 argmax of the last position (first
    maximal index on ties, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)


def request_key(seed: int, prompt) -> torch.Tensor:
    """Per-request base key: ``fold_in(PRNGKey(seed), h)`` with ``h`` the low 32
    bits of a polynomial rolling hash of the prompt over the prime 2**61 - 1."""
    mix = 0
    for t in prompt:
        mix = (mix * 1000003 + int(t) + 1) % (2**61 - 1)
    return prng.fold_in(prng.PRNGKey(seed), mix & 0xFFFFFFFF)


def token_key(base: torch.Tensor, index: int) -> torch.Tensor:
    """Key for the request's ``index``-th emitted token (0 = prefill-seeded)."""
    return prng.fold_in(base, index)


def _filter_top_k_top_p(lg: torch.Tensor, top_k: torch.Tensor,
                        top_p: torch.Tensor) -> torch.Tensor:
    """Per-row logit filter over (B, V): keep the top-k AND the nucleus top-p
    set. ``top_k`` (B,) int, 0 disables; ``top_p`` (B,) f32, 1 disables. The
    highest-probability token is always kept.

    Disabled cutoffs are EXACT no-ops: with ``top_p >= 1`` and ``top_k``
    disabled or >= vocab a row passes through untouched (the f32 cumsum can
    reach 1.0 at the tail, which would otherwise drop the last-ranked token).
    The sort is stable and descending, as ``argsort(-lg)``.
    """
    v = lg.shape[-1]
    order = torch.sort(lg, dim=-1, descending=True, stable=True).indices
    slg = torch.gather(lg, -1, order)
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(v, device=lg.device).expand_as(order))
    k_eff = torch.where(top_k > 0, top_k, torch.full_like(top_k, v))
    probs = torch.softmax(slg, dim=-1)
    prev_mass = torch.cumsum(probs, dim=-1) - probs     # mass strictly above each rank
    keep_sorted = (prev_mass < top_p[:, None]) & (
        torch.arange(v, device=lg.device)[None, :] < k_eff[:, None])
    keep = torch.gather(keep_sorted, -1, ranks)
    exact_noop = (top_p >= 1.0) & ((top_k <= 0) | (top_k >= v))
    filtered = torch.where(keep, lg, torch.full_like(lg, NEG_FILL))
    return torch.where(exact_noop[:, None], lg, filtered)


def sample_masked(logits: torch.Tensor, done: torch.Tensor, *, keys: torch.Tensor,
                  temperature: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor,
                  pad_id: int = 0) -> torch.Tensor:
    """The decode pool's single sampling path → (B,) int32.

    logits (B, 1, V); done (B,) bool (retired/free lanes emit ``pad_id``);
    keys (B, 2) uint32 words (int64); temperature (B,) f32, where 0 selects
    the exact argmax; top_k (B,) int, 0 disables; top_p (B,) f32, 1 disables.
    Sampled lanes draw from the temperature-scaled, filtered categorical with
    their OWN key. Everything runs on the logits' device: an input already
    there in its dtype (the engine's captured program passes static device
    buffers) is used as it is, any other is copied there first.
    """
    dev = logits.device
    lg = logits[:, -1, :]
    gtok = torch.argmax(lg, dim=-1).to(torch.int32)
    temp = _on(temperature, dev, torch.float32)
    scaled = lg.to(torch.float32) / torch.where(temp > 0, temp, torch.ones_like(temp))[:, None]
    filtered = _filter_top_k_top_p(scaled, _on(top_k, dev, torch.int64),
                                   _on(top_p, dev, torch.float32))
    stok = prng.categorical(prng.as_key(keys, dev), filtered).to(torch.int32)
    tok = torch.where(temp > 0, stok, gtok)
    return torch.where(_on(done, dev, torch.bool), torch.full_like(tok, pad_id), tok)


def _on(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(x).to(dev, dtype)


def greedy_masked(logits: torch.Tensor, done: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """All-greedy masked sampling: exactly what :func:`sample_masked` emits when
    every lane's temperature is 0, without the filter or any key. Retired/free
    lanes (``done``) emit ``pad_id``, active lanes the exact argmax."""
    tok = greedy(logits)
    return torch.where(done.to(tok.device), torch.full_like(tok, pad_id), tok)


def sample(logits: torch.Tensor, key: torch.Tensor, temperature: float = 1.0,
           top_k: int = 0) -> torch.Tensor:
    """Single-policy batch sampling with ONE key for the batch (the legacy
    utility; the engine uses :func:`sample_masked`): ``categorical(key, lg)``
    over (B, V) draws a (B, V) noise block from the one key, as
    ``jax.random.categorical`` with a batch axis does."""
    lg = logits[:, -1, :].to(torch.float32)
    if temperature <= 0.0:
        return greedy(logits)
    lg = lg / temperature
    if top_k > 0:
        cutoff = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = torch.where(lg >= cutoff, lg, torch.full_like(lg, -1e30))
    b, v = lg.shape
    noise = prng.gumbel(prng.as_key(key, lg.device), b * v).reshape(b, v)
    return torch.argmax(noise + lg, dim=-1).to(torch.int32)
