"""Parameter dicts as torch tensors.

The parameter layout is the one :func:`~llama2_tpu_torch.io.checkpoint.load_checkpoint`
returns (transposed, layer-stacked; see that module's docstring), which is
also the JAX package's layout, so the same numpy dict can feed both.
"""

from __future__ import annotations

import numpy as np
import torch

from llama2_tpu_torch.config import ModelConfig


def params_from_numpy(params: dict, device, dtype=torch.float32) -> dict:
    """numpy (or array-like) fp params -> ``dtype`` tensors on ``device``."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
        for k, a in params.items()
    }


def random_params(
    config: ModelConfig,
    seed: int,
    device,
    dtype=torch.float32,
    scale: float = 0.02,
) -> dict:
    """Seeded random weights built directly on ``device`` (no host copy).

    Normal(0, ``scale``) matrices (0.02 is Llama's initializer std, which
    keeps activations of a full-width model in range) and ``1 + N(0, scale)``
    norm weights. Each tensor is drawn in float32 from one
    ``torch.Generator`` on ``device`` and then cast, so a (seed, device) pair
    always gives the same weights. The classifier is the shared embedding
    (``wcls`` is a transposed view of ``tok_emb``, as a shared v0 file loads).
    """
    gen = torch.Generator(device=device).manual_seed(seed)

    def r(*shape):
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return t.mul_(scale).to(dtype)

    L, D, HD, V = config.n_layers, config.dim, config.hidden_dim, config.vocab_size
    KV = config.kv_dim
    tok_emb = r(V, D)
    return {
        "tok_emb": tok_emb,
        "rms_att": 1.0 + r(L, D),
        "wq": r(L, D, D),
        "wk": r(L, D, KV),
        "wv": r(L, D, KV),
        "wo": r(L, D, D),
        "rms_ffn": 1.0 + r(L, D),
        "w1": r(L, D, HD),
        "w2": r(L, HD, D),
        "w3": r(L, D, HD),
        "rms_final": 1.0 + r(D),
        "wcls": tok_emb.T,
    }
