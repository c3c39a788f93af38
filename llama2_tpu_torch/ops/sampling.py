"""Samplers: argmax, multinomial, top-p (nucleus).

Port of ``llama2_tpu/ops/sampling.py`` (reference semantics main.zig:715-798,
1002-1013; the full-sort nucleus formulation and its proof of equivalence are
in that module's docstring). The uniform draw ``r`` in [0, 1) is an
argument, not drawn here: the caller owns the randomness (the Generator
draws it from a ``torch.Generator`` seeded from (seed, position)), and a test
can feed this module and the JAX one the same draw.
"""

from __future__ import annotations

import torch

ARGMAX = 0
MULTINOMIAL = 1
TOP_P = 2


def choose_mode(temperature: float, top_p: float) -> int:
    """The reference's sampler dispatch (main.zig:1002-1013)."""
    if temperature == 0.0:
        return ARGMAX
    if top_p == 0.0 or top_p == 1.0:
        return MULTINOMIAL
    return TOP_P


def sample_argmax(logits: torch.Tensor) -> torch.Tensor:
    """First-max argmax over raw logits (main.zig:715-726). (..., V) -> int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def probs_from_logits(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """Temperature-scale then softmax the full vocab (main.zig:1005-1009)."""
    logits = logits.float() / temperature
    e = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def _as_draw(r, probs: torch.Tensor) -> torch.Tensor:
    """``r`` as a float32 (..., 1) tensor on probs' device."""
    r = torch.as_tensor(r, dtype=torch.float32, device=probs.device)
    return r.reshape(probs.shape[:-1] + (1,))


def sample_multinomial(probs: torch.Tensor, r) -> torch.Tensor:
    """CDF walk: first index with cdf > r, fallback last (main.zig:728-743)."""
    cdf = torch.cumsum(probs, dim=-1)
    idx = torch.sum(cdf <= _as_draw(r, probs), dim=-1)
    return torch.clamp(idx, max=probs.shape[-1] - 1).to(torch.int32)


def sample_top_p(probs: torch.Tensor, p: float, r) -> torch.Tensor:
    """Nucleus sampling with the reference's exact nucleus construction.

    The descending sort is stable (ties keep ascending index order), as
    ``lax.top_k`` is in the JAX package.
    """
    V = probs.shape[-1]
    sorted_probs, sorted_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    cdf = torch.cumsum(sorted_probs, dim=-1)
    # smallest prefix with cumulative prob > p -> nucleus [0, cutoff_index]
    cutoff_index = torch.clamp(torch.sum(cdf <= p, dim=-1), max=V - 1)
    cum_prob = torch.gather(cdf, -1, cutoff_index[..., None])
    j = torch.sum(cdf <= _as_draw(r, probs) * cum_prob, dim=-1)
    j = torch.minimum(j, cutoff_index)  # fallback: last nucleus element
    return torch.gather(sorted_idx, -1, j[..., None])[..., 0].to(torch.int32)


def sample(logits: torch.Tensor, mode: int, temperature: float, top_p: float, r) -> torch.Tensor:
    """Dispatch on the sampler mode. logits (..., V) -> int32 token."""
    if mode == ARGMAX:
        return sample_argmax(logits)
    probs = probs_from_logits(logits, temperature)
    if mode == MULTINOMIAL:
        return sample_multinomial(probs, r)
    return sample_top_p(probs, top_p, r)
