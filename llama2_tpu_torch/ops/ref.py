"""Plain PyTorch versions of the model's compute.

Port of ``llama2_tpu/ops/xla.py`` with the same semantics, shapes and cast
order (the reference's SIMD kernels, main.zig:432-713): activations are row
vectors ``(batch, seq, dim)``, weights ``(in_features, out_features)``.
Matmul precision is the process-wide torch setting; the fp32 parity path
runs with TF32 off (see ``runtime/generator.py``).
"""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm with eps added *after* the mean (main.zig:452-454).

    Sum of squares in float32; the normalized value is cast back to x's
    dtype BEFORE the weight multiply (in bf16 this order changes the bits).
    """
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * weight


def rope_angles(positions: torch.Tensor, head_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for interleaved-pair RoPE (main.zig:336-351).

    ``freq_j = 1 / 10000^(2j/head_size)`` in float32; returns ``(cos, sin)``
    of shape ``positions.shape + (head_size//2,)``.
    """
    j = torch.arange(0, head_size, 2, dtype=torch.float32, device=positions.device) / head_size
    freqs = 1.0 / (10000.0**j)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs ``(x[2j], x[2j+1])`` per head.

    ``x``: (B, T, H, hs); ``cos/sin``: (B, T, hs/2) or (T, hs/2), broadcast
    over heads. The rotation runs in float32 and is cast back to x's dtype.
    """
    shape = x.shape
    xr = x.reshape(*shape[:-1], shape[-1] // 2, 2)
    x0, x1 = xr[..., 0], xr[..., 1]
    c = cos.unsqueeze(-2)  # broadcast over the heads axis
    s = sin.unsqueeze(-2)
    r0 = x0 * c - x1 * s
    r1 = x0 * s + x1 * c
    return torch.stack([r0, r1], dim=-1).reshape(shape).to(x.dtype)


def attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal GQA attention of T query tokens against a KV cache.

    q: (B, T, H, hs); k_cache/v_cache: (B, KVH, S, hs); ``pos`` is the
    position of the first query token, an int or a per-row (B,) tensor.
    Scores in float32, scaled, masked to the causal window [0, pos+t],
    softmaxed; probabilities are cast to q's dtype before the value product,
    as in the JAX package. Returns (B, T, H, hs).
    """
    B, T, H, hs = q.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    if scale is None:
        scale = 1.0 / (hs**0.5)
    qg = q.reshape(B, T, KVH, G, hs)
    scores = torch.einsum("btkgd,bksd->bkgts", qg, k_cache).float() * scale

    pos = torch.as_tensor(pos, device=q.device)
    key_pos = torch.arange(S, device=q.device)[None, :]
    query_pos = pos[..., None, None] + torch.arange(T, device=q.device)[:, None]
    mask = key_pos <= query_pos  # (T, S) or (B, T, S)
    if mask.ndim == 2:
        mask = mask[None]
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    att = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bksd->btkgd", att, v_cache)
    return out.reshape(B, T, H, hs)


def swiglu(h1: torch.Tensor, h3: torch.Tensor) -> torch.Tensor:
    """SwiGLU gate ``silu(h1) * h3`` (main.zig:411-416); silu in float32,
    cast to h1's dtype, then the product."""
    h1f = h1.float()
    return (h1f * torch.sigmoid(h1f)).to(h1.dtype) * h3


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Max-subtracted softmax (main.zig:687-706), float32 accumulation."""
    xf = x.float()
    e = torch.exp(xf - torch.amax(xf, dim=dim, keepdim=True))
    return (e / torch.sum(e, dim=dim, keepdim=True)).to(x.dtype)
