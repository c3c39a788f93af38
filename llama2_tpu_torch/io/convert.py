"""Parameter dicts as torch tensors.

The parameter layout is the one :func:`~llama2_tpu_torch.io.checkpoint.load_checkpoint`
returns (transposed, layer-stacked; see that module's docstring), which is
also the JAX package's layout, so the same numpy dict can feed both.
"""

from __future__ import annotations

import numpy as np
import torch

from llama2_tpu_torch.config import ModelConfig
from llama2_tpu_torch.quant.q8 import DEFAULT_GROUP_SIZE, QuantTensor


def params_from_numpy(params: dict, device, dtype=torch.float32) -> dict:
    """numpy (or array-like) params -> tensors on ``device``.

    An fp entry becomes a ``dtype`` tensor. A quantized entry, given as a
    ``(q int8, scale f32, group_size)`` triple of numpy arrays or as a
    :class:`QuantTensor`, becomes a QuantTensor on ``device`` (int8 values and
    float32 scales whatever ``dtype`` is), so one numpy tree can feed this
    package and the JAX one.
    """
    out = {}
    for k, a in params.items():
        if isinstance(a, QuantTensor):
            out[k] = a.to(device)
        elif isinstance(a, tuple):
            q, scale, group_size = a
            out[k] = QuantTensor(
                torch.from_numpy(np.ascontiguousarray(q, dtype=np.int8)).to(device),
                torch.from_numpy(np.ascontiguousarray(scale, dtype=np.float32)).to(device),
                int(group_size),
            )
        else:
            out[k] = torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
    return out


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


def random_q8_params(
    config: ModelConfig,
    seed: int,
    device,
    dtype=torch.float32,
    group_size: int = DEFAULT_GROUP_SIZE,
) -> dict:
    """Seeded random INT8 weights built directly on ``device``: no fp32 copy
    of the model exists at any point.

    The idea of ``llama2_tpu/tools/make_random_q8.py``: uniform int8 values in
    [-127, 127] (std ~73) under scales of ``2.7e-4 * U(0.7, 1.3)``, for an
    effective weight std of ~0.02 (Llama's initializer). Norm weights and the
    embedding are ``dtype`` tensors; the classifier is a QuantTensor of its
    own (unshared).
    """
    gen = torch.Generator(device=device).manual_seed(seed)

    def qt(*shape):
        n_in = shape[-2]
        if n_in % group_size != 0:
            raise ValueError(f"in-features {n_in} not divisible by group size {group_size}")
        q = torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)
        sshape = (*shape[:-2], n_in // group_size, shape[-1])
        jitter = torch.rand(sshape, generator=gen, device=device, dtype=torch.float32)
        return QuantTensor(q, 2.7e-4 * (0.7 + 0.6 * jitter), group_size)

    def f(*shape, loc=0.0):
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return t.mul_(0.02).add_(loc).to(dtype)

    L, D, HD, V = config.n_layers, config.dim, config.hidden_dim, config.vocab_size
    KV = config.kv_dim
    return {
        "tok_emb": f(V, D),
        "rms_att": f(L, D, loc=1.0),
        "wq": qt(L, D, D),
        "wk": qt(L, D, KV),
        "wv": qt(L, D, KV),
        "wo": qt(L, D, D),
        "rms_ffn": f(L, D, loc=1.0),
        "w1": qt(L, D, HD),
        "w2": qt(L, HD, D),
        "w3": qt(L, D, HD),
        "rms_final": f(D, loc=1.0),
        "wcls": qt(D, V),
    }
